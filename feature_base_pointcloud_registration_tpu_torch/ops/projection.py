"""Range-image projection, motion deskew and row-major compaction, batched
over scans.

Port of the JAX package's `ops/projection.py`.  Replaces ImageProjection's
hot loop (ref: src/imageProjection.cpp:583-670 projectPointCloud /
cloudExtraction and :494-580 findRotation / deskewPoint): cell assignment is
a closed-form (ring, atan2 column) map; per-point IMU rotation interpolation
is a searchsorted + lerp over the integrated gyro table; "first write wins"
(ref :623-624) is a stable sort by cell (equal cells keep arrival order, so
the first of each run is the winner), and compaction with ring start/end
indices (ref :642-670) is a second stable sort that moves winners to the
front in row-major order.
"""

from __future__ import annotations

import math

import torch

from ..config import Params
from ..geom.se3 import euler_to_rot
from ..pipeline.cloud_info import CloudInfo, DeskewInfo, RawScan


def _find_rotation(point_time, imu_time, imu_rot, imu_count):
    """Integrated gyro rotation at each point's time (findRotation, ref:
    src/imageProjection.cpp:494-526), batched: point_time [B, N], imu_time
    [B, Q] (+inf past imu_count), imu_rot [B, Q, 3], imu_count [B].

    front = the first sample with imu_time[front] > t, capped at imu_count;
    rot[front] itself when t > imu_time[front] (past the table's end) or
    front == 0, else the lerp between front-1 and front."""
    q = imu_time.shape[1]
    front = torch.searchsorted(imu_time.contiguous(), point_time.contiguous(),
                               right=True)
    front = torch.minimum(front, imu_count[:, None].long())
    front_c = torch.clamp(front, max=q - 1)
    back = torch.clamp(front - 1, min=0)
    t_front = torch.gather(imu_time, 1, front_c)
    t_back = torch.gather(imu_time, 1, back)
    direct = (point_time > t_front) | (front == 0)
    denom = t_front - t_back
    ratio = torch.where(denom > 0, (point_time - t_back)
                        / torch.where(denom == 0, 1.0, denom), 0.0)

    def rot_at(i):
        return torch.gather(imu_rot, 1, i[..., None].expand(-1, -1, 3))

    rot_front, rot_back = rot_at(front_c), rot_at(back)
    interp = rot_front * ratio[..., None] + rot_back * (1.0 - ratio)[..., None]
    return torch.where(direct[..., None], rot_front, interp)


def deskew_points(xyz, rel_time, deskew_info: DeskewInfo, first_idx=None,
                  scan_duration=None):
    """Motion-compensate points into the scan-start lidar frame, batched
    (deskewPoint, ref: src/imageProjection.cpp:544-580): each point's
    rotation from the gyro integral table and, behind `odom_deskew_flag`,
    a position interpolated along `odom_incre` (the reference stubs position
    to zero, :528-542), both relative to the transform of point `first_idx`
    (firstPointFlag, :562-566).

    xyz [B, N, 3]; rel_time [B, N] seconds since scan start; first_idx [B]
    (default 0); scan_duration [B] or None (no positional term)."""
    B = xyz.shape[0]
    rot = _find_rotation(rel_time, deskew_info.imu_time, deskew_info.imu_rot,
                         deskew_info.imu_count)
    if scan_duration is not None:
        ratio = rel_time / torch.clamp(scan_duration, min=1e-9)[:, None]
        pos = torch.where(deskew_info.odom_deskew_flag[:, None, None],
                          ratio[..., None] * deskew_info.odom_incre[:, None],
                          0.0)
    else:
        pos = torch.zeros_like(xyz)
    R = euler_to_rot(rot[..., 0], rot[..., 1], rot[..., 2])   # [B, N, 3, 3]
    if first_idx is None:
        first_idx = torch.zeros(B, dtype=torch.long, device=xyz.device)
    lanes = torch.arange(B, device=xyz.device)
    R0 = R[lanes, first_idx]                                   # [B, 3, 3]
    p0 = pos[lanes, first_idx]                                 # [B, 3]
    # transBt = inv(T0) @ Ti (ref :564,571): R0^T Ri x + R0^T (pi - p0)
    R0t = R0.transpose(-1, -2)[:, None]
    Rbt = R0t @ R
    tbt = (R0t @ (pos - p0[:, None])[..., None])[..., 0]
    return (Rbt @ xyz[..., None])[..., 0] + tbt


def project_scan(params: Params, scan: RawScan,
                 deskew_info: DeskewInfo | None = None,
                 enable_deskew: bool = True) -> CloudInfo:
    """Project a batch of raw scans [B, N] to the (ring, column) grid and
    compact them (projectPointCloud + cloudExtraction, ref:
    src/imageProjection.cpp:583-670).  With `deskew_info` ([B] fields) and
    `enable_deskew`, each lane with IMU info has its points deskewed
    relative to its first surviving point (ref :635, :544-580); without
    it, the IMU/odometry fields are empty."""
    n_scan, horizon_scan = params.n_scan, params.horizon_scan
    B, N = scan.valid.shape
    G = n_scan * horizon_scan
    dev = scan.xyz.device
    if deskew_info is None:
        deskew_info = DeskewInfo.empty(B, params.imu_queue_len, device=dev)
        enable_deskew = False

    x, y, z = scan.xyz.unbind(-1)
    # correctly rounded float32 sqrt on every device: PyTorch's vectorized
    # CPU sqrt is off by an ulp on ~0.6% of inputs, and the curvature
    # ordering downstream is sensitive to single ulps
    rng = torch.sqrt((x * x + y * y + z * z).double()).float()

    row = scan.ring.to(torch.int32)
    row_ok = (row >= 0) & (row < n_scan)

    # columnIdn = -round((atan2(x,y)*180/pi - 90)/ang_res) + H/2, wrapped
    # (ref: src/imageProjection.cpp:605-615); round is half-to-even in both
    # frameworks.
    horizon_angle = torch.atan2(x, y) * (180.0 / math.pi)
    ang_res_x = 360.0 / float(horizon_scan)
    col = (-torch.round((horizon_angle - 90.0) / ang_res_x)).to(
        torch.int32) + horizon_scan // 2
    col = torch.where(col >= horizon_scan, col - horizon_scan, col)
    col_ok = (col >= 0) & (col < horizon_scan)

    range_ok = rng >= 1.0  # ref :620 drops range < 1.0
    gate = scan.valid & row_ok & col_ok & range_ok
    cell = torch.where(gate, row * horizon_scan + col,
                       torch.full_like(row, G))

    pts = scan.xyz
    if enable_deskew:
        # relative to the first surviving point (firstPointFlag, ref
        # :562-566); the scan duration scales the positional term (ref :531)
        first_idx = torch.argmax(gate.to(torch.uint8), dim=1)
        do = deskew_info.imu_available & gate.any(1)
        duration = torch.where(gate, scan.time, 0.0).amax(1)
        desk = deskew_points(scan.xyz, scan.time, deskew_info,
                             first_idx=first_idx, scan_duration=duration)
        pts = torch.where(do[:, None, None], desk, scan.xyz)

    # sort 1 (by cell, stable): the first of each run is the first-write
    # winner, and runs are in ascending-cell = row-major order
    cell_s, perm = torch.sort(cell, dim=1, stable=True)
    pay = torch.cat([pts, rng[..., None], scan.intensity[..., None]],
                    dim=-1)
    pay = torch.gather(pay, 1, perm[..., None].expand(-1, -1, 5))
    first_in_run = torch.ones_like(gate)
    first_in_run[:, 1:] = cell_s[:, 1:] != cell_s[:, :-1]
    is_winner = (cell_s < G) & first_in_run
    num_points = is_winner.sum(1, dtype=torch.int32)

    # sort 2 (winners first, stable): winners stay in row-major order = the
    # serial push_back order of cloudExtraction; losers' cells demote to G
    # so the compacted cell array is nondecreasing
    cell_w = torch.where(is_winner, cell_s, torch.full_like(cell_s, G))
    _, perm2 = torch.sort((~is_winner).to(torch.uint8), dim=1, stable=True)
    ccell = torch.gather(cell_w, 1, perm2)
    pay = torch.gather(pay, 1, perm2[..., None].expand(-1, -1, 5))

    if N >= G:
        ccell, pay = ccell[:, :G], pay[:, :G]
    else:
        ccell = torch.cat([ccell, ccell.new_full((B, G - N), G)], 1)
        pay = torch.cat([pay, pay.new_zeros((B, G - N, 5))], 1)

    comp_valid = (torch.arange(G, device=dev)[None, :]
                  < num_points[:, None])
    pay = torch.where(comp_valid[..., None], pay, 0.0)
    comp_col = torch.where(comp_valid, ccell % horizon_scan, 0)

    # ring start/end with the +-5 curvature margins (ref :650,668):
    # count_before[r] = #winners with cell < r*H
    bounds = (torch.arange(n_scan + 1, device=dev, dtype=torch.int32)
              * horizon_scan).expand(B, -1).contiguous()
    ring_edges = torch.searchsorted(ccell.contiguous(), bounds,
                                    side="left").to(torch.int32)
    count_before = ring_edges[:, :-1]
    ring_counts = ring_edges[:, 1:] - ring_edges[:, :-1]

    return CloudInfo(
        start_ring_index=count_before - 1 + 5,
        end_ring_index=count_before + ring_counts - 1 - 5,
        point_col_ind=comp_col,
        point_range=pay[..., 3].contiguous(),
        point_valid=comp_valid,
        num_points=num_points,
        points=pay[..., 0:3].contiguous(),
        intensity=pay[..., 4].contiguous(),
        imu_available=deskew_info.imu_available,
        odom_available=deskew_info.odom_available,
        imu_rpy_init=deskew_info.imu_rpy_init,
        initial_guess=deskew_info.initial_guess,
        reset_id=deskew_info.reset_id,
    )
