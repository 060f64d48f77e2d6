"""Range-image projection and row-major compaction, batched over scans.

Port of the JAX package's `ops/projection.py` without deskew (the reference's
active path runs with deskew off; it comes in a later slice).  Replaces
ImageProjection's hot loop (ref: src/imageProjection.cpp:583-670
projectPointCloud/cloudExtraction): cell assignment is a closed-form
(ring, atan2 column) map, "first write wins" (ref :623-624) is a stable sort
by cell (equal cells keep arrival order, so the first of each run is the
winner), and compaction with ring start/end indices (ref :642-670) is a
second stable sort that moves winners to the front in row-major order.
"""

from __future__ import annotations

import math

import torch

from ..config import Params
from ..pipeline.cloud_info import CloudInfo, DeskewInfo, RawScan


def project_scan(params: Params, scan: RawScan) -> CloudInfo:
    """Project a batch of raw scans [B, N] to the (ring, column) grid and
    compact them (the JAX package's `project_scan(params, scan, None)`: no
    deskew, empty IMU/odometry fields)."""
    n_scan, horizon_scan = params.n_scan, params.horizon_scan
    B, N = scan.valid.shape
    G = n_scan * horizon_scan
    dev = scan.xyz.device
    deskew_info = DeskewInfo.empty(B, device=dev)

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

    # sort 1 (by cell, stable): the first of each run is the first-write
    # winner, and runs are in ascending-cell = row-major order
    cell_s, perm = torch.sort(cell, dim=1, stable=True)
    pay = torch.cat([scan.xyz, rng[..., None], scan.intensity[..., None]],
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
