"""Synthetic VLP-16 world + scan simulator (NumPy, host-side).

The port's copy of the JAX package's `io/synthetic.py`: the port imports no
module of the JAX package, and the same seeds give the same scans in both.

The reference is validated empirically against curated rosbag datasets
(ref: README.md:99-123); it ships no data we can use.  This module
manufactures equivalent test input: an analytic world (ground plane, box
walls, vertical poles) ray-cast from a VLP-16 pose, producing the exact raw
point layout the front end ingests (xyz, intensity, ring, per-point time —
PointXYZIRT, ref: src/imageProjection.cpp:8-21), plus ground-truth feature
maps sampled directly from the analytic surfaces for registration tests.
"""

from __future__ import annotations

import dataclasses
import numpy as np

# VLP-16 elevation angles, degrees (ring 0 = -15deg .. ring 15 = +15deg)
VLP16_ELEV_DEG = np.linspace(-15.0, 15.0, 16)


def _euler_to_rot_np(roll, pitch, yaw):
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def pose6_to_matrix_np(pose6):
    T = np.eye(4)
    T[:3, :3] = _euler_to_rot_np(pose6[0], pose6[1], pose6[2])
    T[:3, 3] = pose6[3:6]
    return T


@dataclasses.dataclass
class SyntheticWorld:
    """Axis-aligned room with poles: planes give surf features, pole/wall
    verticals give corner features."""

    half_x: float = 25.0
    half_y: float = 25.0
    ground_z: float = -1.5
    ceil_z: float = 8.0
    pole_xy: np.ndarray = None  # [P,2]
    pole_radius: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if self.pole_xy is None:
            rng = np.random.RandomState(self.seed)
            n = 24
            xy = rng.uniform(-0.85, 0.85, (n, 2)) * np.array(
                [self.half_x, self.half_y]
            )
            keep = np.linalg.norm(xy, axis=1) > 3.0
            self.pole_xy = xy[keep]

    # --- analytic ray casting (origin o, unit dir d, world frame) ---
    def ray_hit(self, o, d):
        """Nearest positive intersection distance for rays [N,3]; inf if none."""
        n = o.shape[0]
        best = np.full(n, np.inf)

        def consider(t):
            nonlocal best
            ok = (t > 0.05) & np.isfinite(t)
            best = np.where(ok & (t < best), t, best)

        # planes z = ground, z = ceil
        for zp in (self.ground_z, self.ceil_z):
            dz = d[:, 2]
            t = np.where(np.abs(dz) > 1e-9, (zp - o[:, 2]) / dz, np.inf)
            consider(t)
        # walls x = +-half_x, y = +-half_y (check hit stays inside box)
        for axis, lim in ((0, self.half_x), (1, self.half_y)):
            for sgn in (-1.0, 1.0):
                da = d[:, axis]
                with np.errstate(divide="ignore", invalid="ignore"):
                    t = np.where(np.abs(da) > 1e-9,
                                 (sgn * lim - o[:, axis]) / da, np.inf)
                other = 1 - axis
                hit_other = o[:, other] + t * d[:, other]
                lim_other = self.half_y if other == 1 else self.half_x
                hit_z = o[:, 2] + t * d[:, 2]
                ok = (
                    (np.abs(hit_other) <= lim_other + 1e-6)
                    & (hit_z >= self.ground_z - 1e-6)
                    & (hit_z <= self.ceil_z + 1e-6)
                )
                consider(np.where(ok, t, np.inf))
        # poles: infinite vertical cylinders clipped to [ground, ceil]
        for px, py in self.pole_xy:
            ox = o[:, 0] - px
            oy = o[:, 1] - py
            dx, dy = d[:, 0], d[:, 1]
            a = dx * dx + dy * dy
            b = 2.0 * (ox * dx + oy * dy)
            c = ox * ox + oy * oy - self.pole_radius**2
            disc = b * b - 4 * a * c
            with np.errstate(invalid="ignore", divide="ignore"):
                sq = np.sqrt(np.maximum(disc, 0.0))
                t = (-b - sq) / (2 * a)
            hit_z = o[:, 2] + t * d[:, 2]
            ok = (disc > 0) & (hit_z >= self.ground_z) & (hit_z <= self.ceil_z)
            consider(np.where(ok, t, np.inf))
        return best

    # --- ground-truth feature maps sampled from the analytic surfaces ---
    def surf_map_points(self, spacing: float = 0.35):
        pts = []
        xs = np.arange(-self.half_x, self.half_x, spacing)
        ys = np.arange(-self.half_y, self.half_y, spacing)
        zs = np.arange(self.ground_z, self.ceil_z, spacing)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        pts.append(np.stack([gx.ravel(), gy.ravel(),
                             np.full(gx.size, self.ground_z)], 1))
        for sgn in (-1.0, 1.0):
            wy, wz = np.meshgrid(ys, zs, indexing="ij")
            pts.append(np.stack([np.full(wy.size, sgn * self.half_x),
                                 wy.ravel(), wz.ravel()], 1))
            wx, wz = np.meshgrid(xs, zs, indexing="ij")
            pts.append(np.stack([wx.ravel(),
                                 np.full(wx.size, sgn * self.half_y),
                                 wz.ravel()], 1))
        return np.concatenate(pts).astype(np.float32)

    def corner_map_points(self, spacing: float = 0.12):
        """Vertical lines: pole axes + room wall corners."""
        zs = np.arange(self.ground_z, self.ceil_z, spacing)
        pts = []
        for px, py in self.pole_xy:
            pts.append(np.stack([np.full(zs.size, px), np.full(zs.size, py), zs], 1))
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                pts.append(np.stack([np.full(zs.size, sx * self.half_x),
                                     np.full(zs.size, sy * self.half_y), zs], 1))
        return np.concatenate(pts).astype(np.float32)


def simulate_scan(world: SyntheticWorld, pose6, n_scan: int = 16,
                  horizon_scan: int = 1800, scan_period: float = 0.1,
                  noise: float = 0.0, seed: int = 0,
                  spin_rpy_rate=None, vel_world=None, elev_deg=None):
    """Ray-cast one VLP-16 scan from pose6 (sensor in world frame); another
    lidar's scan with elev_deg, its n_scan ring elevations in degrees.

    Returns dict(xyz [N,3] sensor frame, intensity, ring, time, valid).
    If spin_rpy_rate (rad/s, [3]) is given, the sensor rotates during the
    sweep — points are produced in the *instantaneous* sensor frame like a
    real spinning lidar, for deskew testing.  vel_world (m/s, [3], spin
    path only) additionally translates the sensor during the sweep — the
    full motion-skew of a vehicle-mounted lidar (the reference corrects
    rotation skew only and stubs position skew, ref:
    src/imageProjection.cpp:500-511; scans generated with both stress
    exactly that envelope).
    """
    rng = np.random.RandomState(seed)
    T = pose6_to_matrix_np(np.asarray(pose6, np.float64))
    R0, t0 = T[:3, :3], T[:3, 3]

    az = np.tile(np.arange(horizon_scan) * (2 * np.pi / horizon_scan), n_scan)
    ring = np.repeat(np.arange(n_scan), horizon_scan).astype(np.int32)
    elev = np.deg2rad(VLP16_ELEV_DEG if elev_deg is None
                      else np.asarray(elev_deg, np.float64))[ring]
    rel_t = (az / (2 * np.pi) * scan_period).astype(np.float32)

    # sensor-frame ray directions at emission time
    d_sensor = np.stack(
        [np.cos(elev) * np.cos(az), np.cos(elev) * np.sin(az), np.sin(elev)], 1
    )

    if spin_rpy_rate is not None:
        rates = np.asarray(spin_rpy_rate, np.float64)
        # instantaneous attitude = R0 @ Rz(yaw_rate*t)Ry(..)Rx(..);
        # _euler_to_rot_np broadcasts over vector angles to [3, 3, N]
        ang = rates[:, None] * rel_t[None, :].astype(np.float64)
        Ri = np.moveaxis(_euler_to_rot_np(ang[0], ang[1], ang[2]),
                         -1, 0)                      # [N, 3, 3]
        Ri = np.einsum("ij,njk->nik", R0, Ri)        # R0 @ Ri, [N, 3, 3]
        d_world = np.einsum("nij,nj->ni", Ri, d_sensor)
        o_world = np.broadcast_to(t0, d_sensor.shape).copy()
        if vel_world is not None:
            o_world = o_world + (np.asarray(vel_world, np.float64)[None, :]
                                 * rel_t[:, None])
        t_hit = world.ray_hit(o_world, d_world)
        ok = np.isfinite(t_hit)
        p_world = o_world + d_world * t_hit[:, None]
        # back into the instantaneous sensor frame at each point's time
        xyz = np.einsum("nji,nj->ni", Ri, p_world - o_world)
    else:
        d_world = d_sensor @ R0.T
        o_world = np.broadcast_to(t0, d_sensor.shape)
        t_hit = world.ray_hit(o_world, d_world)
        ok = np.isfinite(t_hit)
        xyz = d_sensor * t_hit[:, None]

    if noise > 0:
        xyz = xyz + rng.normal(0, noise, xyz.shape)

    xyz = np.where(ok[:, None], xyz, 0.0).astype(np.float32)
    return dict(
        xyz=xyz,
        intensity=np.full(xyz.shape[0], 100.0, np.float32),
        ring=ring,
        time=rel_t,
        valid=ok,
    )


def build_feature_map(world: SyntheticWorld, corner_cap: int, surf_cap: int,
                      corner_spacing: float = 0.12, surf_spacing: float = 0.35):
    """Ground-truth global feature map padded to capacities (world frame)."""
    c = world.corner_map_points(corner_spacing)
    s = world.surf_map_points(surf_spacing)

    def pad(a, cap):
        assert a.shape[0] <= cap, f"{a.shape[0]} > {cap}"
        m = np.zeros(cap, bool)
        m[: a.shape[0]] = True
        out = np.zeros((cap, 3), np.float32)
        out[: a.shape[0]] = a
        return out, m

    cx, cm = pad(c, corner_cap)
    sx, sm = pad(s, surf_cap)
    return cx, cm, sx, sm


def _rot_to_quat_np(R):
    """(x,y,z,w) from a proper rotation matrix."""
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2.0
    return np.array([(R[2, 1] - R[1, 2]) / (4 * w),
                     (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w), w])


def _quat_mul_np(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz])


def constant_twist_platform(duration, imu_hz=100.0, ext_rot=None,
                            ext_rpy=None, gravity=9.80511,
                            w_body=(0.0, 0.0, 0.15), v_body=(1.2, 0.0, 0.0)):
    """Constant-twist ground-truth platform + synthetic RAW IMU stream.

    Returns (imu_samples, states):
      imu_samples: list of (t, acc_imu, gyr_imu, quat_imu) in the IMU SENSOR
        frame — i.e. pre-imuConverter raw input.  When ext_rot/ext_rpy are
        given (row-major 9-tuples, the reference's extrinsicRot/extrinsicRPY,
        ref: config/params.yaml:37-42), the lidar-frame truth is rotated
        back into the sensor frame so that imu_converter must be applied to
        recover it; identity extrinsics otherwise.
      states: list of (t, R_lidar, p_lidar) ground-truth lidar poses.
    """
    Re = (np.asarray(ext_rot, float).reshape(3, 3) if ext_rot is not None
          else np.eye(3))
    Rq = (np.asarray(ext_rpy, float).reshape(3, 3) if ext_rpy is not None
          else np.eye(3))
    q_ext_inv = _rot_to_quat_np(Rq.T)

    dt = 1.0 / imu_hz
    n = int(duration * imu_hz)
    w_b = np.asarray(w_body, float)
    v_b0 = np.asarray(v_body, float)
    R, p = np.eye(3), np.zeros(3)
    states, imu = [], []
    for i in range(n):
        t = i * dt
        v_world = R @ v_b0
        a_world = R @ np.cross(w_b, v_b0)
        acc_lidar = R.T @ (a_world - np.array([0, 0, -gravity]))
        quat_lidar = _rot_to_quat_np(R)
        # sensor-frame raw sample: undo the extrinsics the converter applies
        imu.append((t, Re.T @ acc_lidar, Re.T @ w_b,
                    _quat_mul_np(q_ext_inv, quat_lidar)))
        states.append((t, R.copy(), p.copy()))
        p = p + v_world * dt + 0.5 * a_world * dt * dt
        th = np.linalg.norm(w_b) * dt
        if th > 0:
            k = w_b / np.linalg.norm(w_b)
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                          [-k[1], k[0], 0]])
            R = R @ (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K)
    return imu, states
