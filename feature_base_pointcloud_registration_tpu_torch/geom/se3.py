"""SE(3) / Euler-angle core, matching the PCL conventions the reference uses.

Port of the JAX package's `geom/se3.py`.  Convention (ZYX intrinsic):
pcl::getTransformation(x, y, z, roll, pitch, yaw) builds
R = Rz(yaw) @ Ry(pitch) @ Rx(roll), t = (x, y, z), and
pcl::getTranslationAndEulerAngles inverts it with roll = atan2(R21, R22),
pitch = asin(-R20), yaw = atan2(R10, R00) (ref: src/mapOptmization.h:309,
326, 414, 447); tf::Matrix3x3::getRPY and tf::createQuaternionFromRPY use
the same convention.  Pose vectors are `pose6 = [roll, pitch, yaw, x, y, z]`
(ref: src/mapOptmization.h:131).  Quaternions are (x, y, z, w).

Every function broadcasts over leading batch dimensions and keeps the dtype
and device of its inputs (float32 throughout, TF32 off: see device.py).
"""

from __future__ import annotations

import torch


def euler_to_rot(roll, pitch, yaw):
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll); broadcasts, returns (..., 3, 3)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    r00 = cy * cp
    r01 = cy * sp * sr - sy * cr
    r02 = cy * sp * cr + sy * sr
    r10 = sy * cp
    r11 = sy * sp * sr + cy * cr
    r12 = sy * sp * cr - cy * sr
    r20 = -sp
    r21 = cp * sr
    r22 = cp * cr
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def rot_to_euler(R):
    """Inverse of euler_to_rot (PCL getTranslationAndEulerAngles)."""
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def _homogeneous(R, t):
    """(..., 3, 3) rotation and (..., 3) translation -> (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def pose6_to_matrix(pose6):
    """[roll, pitch, yaw, x, y, z] -> homogeneous (..., 4, 4)."""
    R = euler_to_rot(pose6[..., 0], pose6[..., 1], pose6[..., 2])
    return _homogeneous(R, pose6[..., 3:6])


def matrix_to_pose6(T):
    roll, pitch, yaw = rot_to_euler(T[..., :3, :3])
    return torch.stack(
        [roll, pitch, yaw, T[..., 0, 3], T[..., 1, 3], T[..., 2, 3]], dim=-1)


def inverse_matrix(T):
    """Rigid-transform inverse: [R t]^-1 = [R^T  -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _homogeneous(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def compose_pose6(a, b):
    """pose6 composition: matrix(a) @ matrix(b) -> pose6."""
    return matrix_to_pose6(pose6_to_matrix(a) @ pose6_to_matrix(b))


def apply_transform(T, pts):
    """Apply a (..., 4, 4) rigid transform to (..., N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def quat_from_euler(roll, pitch, yaw):
    """tf-convention quaternion (x, y, z, w) from RPY:
    q = qz(yaw) qy(pitch) qx(roll)."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([x, y, z, w], dim=-1)


def euler_from_quat(q):
    """RPY from a quaternion (x, y, z, w), the convention of tf getRPY."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return roll, pitch, yaw


def quat_slerp(q0, q1, t):
    """Spherical linear interpolation between quaternions (x, y, z, w), as
    tf::Quaternion::slerp (the IMU attitude fusion, ref:
    src/mapOptmization.h:1464); lerp for nearly parallel quaternions."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.acos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-6
    safe = torch.where(near, 1.0, sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe)
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def _skew(k):
    zero = torch.zeros_like(k[..., 0])
    return torch.stack([
        torch.stack([zero, -k[..., 2], k[..., 1]], dim=-1),
        torch.stack([k[..., 2], zero, -k[..., 0]], dim=-1),
        torch.stack([-k[..., 1], k[..., 0], zero], dim=-1),
    ], dim=-2)


def so3_exp(w):
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    small = theta[..., 0] < 1e-8
    K = _skew(w / torch.where(theta < 1e-8, 1.0, theta))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    th = theta[..., None]
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where(small[..., None, None], eye, R)


def so3_log(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3); near theta = pi
    the axis comes from the diagonal."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.acos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-6
    sin2 = torch.where(small, 1.0, 2.0 * torch.sin(theta))
    scale = torch.where(small, 0.5, theta / sin2)
    w = v * scale[..., None]
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    axis2 = torch.clamp((diag - cos_t[..., None])
                        / (1.0 - cos_t[..., None] + 1e-12), min=0.0)
    w_pi = torch.sqrt(axis2) * torch.sign(v + 1e-20) * theta[..., None]
    return torch.where((theta > 3.0)[..., None], w_pi, w)


def kabsch(src, dst, weights=None):
    """Weighted rigid alignment: (R, t) minimizing sum w |R src + t - dst|^2
    by SVD.  src, dst (..., N, 3); weights (..., N) or None.  Returns the
    (..., 4, 4) transform."""
    if weights is None:
        weights = torch.ones_like(src[..., 0])
    w = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-12)
    mu_s = torch.sum(src * w[..., None], dim=-2, keepdim=True)
    mu_d = torch.sum(dst * w[..., None], dim=-2, keepdim=True)
    H = ((src - mu_s) * w[..., None]).transpose(-1, -2) @ (dst - mu_d)
    U, _, Vh = torch.linalg.svd(H)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    S = torch.eye(3, dtype=src.dtype, device=src.device).repeat(
        *H.shape[:-2], 1, 1)
    S[..., 2, 2] = torch.linalg.det(V @ Ut)
    R = V @ S @ Ut
    t = mu_d[..., 0, :] - (R @ mu_s[..., 0, :, None])[..., 0]
    return _homogeneous(R, t)
