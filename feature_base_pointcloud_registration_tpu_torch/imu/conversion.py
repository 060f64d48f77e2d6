"""IMU frame conversion — the imuConverter equivalent.

Port of the JAX package's `imu/conversion.py`: rotates IMU accel/gyro into
the lidar frame by the extrinsic rotation and the orientation quaternion by
the RPY extrinsic, with the 9-axis validity check (ref:
include/utility.h:219-253).  Quaternions are (x, y, z, w).
"""

from __future__ import annotations

import torch

from ..config import Params


def _quat_mul(a, b):
    """Hamilton product, (x, y, z, w) layout."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def _rot_to_quat(R):
    """Rotation matrix -> quaternion (x, y, z, w); a proper rotation."""
    t = R[0, 0] + R[1, 1] + R[2, 2]
    w = torch.sqrt(torch.clamp(1.0 + t, min=1e-12)) / 2.0
    return torch.stack([(R[2, 1] - R[1, 2]) / (4.0 * w),
                        (R[0, 2] - R[2, 0]) / (4.0 * w),
                        (R[1, 0] - R[0, 1]) / (4.0 * w), w])


def imu_converter(params: Params, acc, gyr, quat):
    """IMU samples into the lidar frame, on the samples' device.

    acc, gyr [..., 3]; quat [..., 4] (x, y, z, w) orientation.  Returns
    (acc_l, gyr_l, quat_l, valid); valid is the reference's 9-axis check
    (quaternion norm >= 0.1, ref: utility.h:246-250)."""
    def mat(v):
        return torch.tensor(v, dtype=torch.float32,
                            device=acc.device).reshape(3, 3)

    ext_rot = mat(params.ext_rot)
    acc_l = acc @ ext_rot.T
    gyr_l = gyr @ ext_rot.T
    q_ext = _rot_to_quat(mat(params.ext_rpy))
    quat_l = _quat_mul(q_ext.expand(quat.shape), quat)
    valid = torch.linalg.norm(quat_l, dim=-1) >= 0.1
    return acc_l, gyr_l, quat_l, valid
