#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the batched scan-to-map main path of
`feature_base_pointcloud_registration_tpu_torch` (no JAX) at the bench's
size: B=256 distinct full VLP-16 scans of the synthetic world (seed 0),
`Params(map_corner_cap=16384, map_surf_cap=65536)`, cell caps 32/48,
round-0 strides 8/4, 2 rounds x 15 GN iterations.

  build    compiles csrc/*.cu with nvcc into build/ (ops/kernels.py);
  phase 1  the fetch kernel against its plain version on the main path's
           round-1 queries (corner and surf): d2 and candidates bitwise;
  phase 2  the GN-round kernel against its plain version on round 0's
           inputs (strided features, lanes at iteration 0, so the Jacobi
           runs) and on round 1's (phase 1's candidates): pose within 1e-3
           (m / rad), iteration count and n_corr equal on >= 95% of lanes;
  phase 3  the slice end to end: frontend, map tables, batch_register_fused,
           with the kernels' launch counters zeroed just before; each kernel
           must have launched (4 fetches, 2 GN rounds, one a round); ATE
           against ground
           truth and against the serial NumPy oracle (tests/oracle.py) on 8
           scans, which must be <= 1e-3 m;
  phase 4  the resident-fetch kernel against its plain version on phase 1's
           queries routed through the resident tables' rows_index: bitwise;
           and against the raw-table fetch: d2 bitwise, candidates bitwise
           wherever the compact row is not the sentinel;
  phase 5  the main path on resident tables (build_map_planar_tables with
           resident=True, batch_register_fused), counted: 4 resident
           fetches, 0 raw fetches, 2 GN rounds; poses within 1e-6 of phase
           3's; ATE against the oracle <= 1e-3 m;
  phase 6  the rounds-structured solver batch_register_pallas on the
           resident tables, counted: 4 resident fetches, 0 GN rounds; ATE
           against the oracle <= 1e-3 m; batch_register_blocks (plain fetch,
           same solver) on the first 32 scans within 1e-4 of it;
  timing   CUDA events (a GN call through a replayed CUDA graph of its
           calls, since one of a few iterations is shorter than its host
           launch): each kernel beside its plain version at these
           shapes (the GN round at both rounds' inputs), with its bound
           (bytes read once over 3.35 TB/s or operations over 67 TFLOP/s
           fp32, whichever is larger; the GN round reads the mask of every
           point and the xyz and candidates of live ones; also the floor of a
           design that streams the candidates every iteration: lane-
           iterations x live points x (16 + 12K) B over 3.35 TB/s);
           frontend and solve ms/scan, end-to-end scans/s;
  probes   both fetch kernels at phase 4's round-1 surf queries: (a) as
           they are, (b) after a per-lane sort by row (presort_by_row,
           the order of JAX presort_rows), (c) every query at
           the sentinel (the writes alone), (d) every live query on one
           row (the cached ceiling), and K = 6/8/16 on (a); with the live
           queries, the distinct (tile, row) pairs of the kernels' query
           tiles and the row bytes each pattern reads; the GN kernel at
           both rounds' inputs: (a) as they are, with the histogram of
           per-lane iterations and us per lane-iteration, (b) every valid
           lane at exactly 1 and 15 iterations (convergence thresholds 0),
           (c) live features only (each lane's live features and their
           candidates packed to the front, P cut to the batch's largest
           live count), (d) one lane per SM against all B lanes, (e) at
           round 0, one iteration with the 6-sweep Jacobi against none, (f)
           round 1 at K = 6 and 16.

    python3 chip_smoke.py --gn-ab NAME=path/to/gn_round.cu ...

also builds each named GN source (same C entry point, same flags), runs it
through the shipped wrapper, and prints its ptxas lines, its pose
difference from the plain version and the same GN timing and probe lines
beside the shipped kernel's, in this one call (cards of one model differ by
up to 13% between calls).

Any failure raises (exit code 1).  Prints the card's name and power limit
early, a JSON line of per-kernel results second to last, and as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B = 256
CCAP, SCAP = 32, 48
R1S, R1C = 8, 4          # round-0 strides (surf, corner)
K = 8
ITERS = 15
N_ORACLE = 8
PARITY_BUDGET = 1e-3     # m, bench.py's BENCH_PARITY_BUDGET
N_BLOCKS = 32            # scans of phase 6's plain-fetch comparison
# share of lanes whose GN iteration count and n_corr must equal the plain
# version's: FMA contraction may move a lane across the convergence test
# (and then its last n_corr), but a point dropped or counted twice changes
# n_corr on nearly every lane
GN_EQUAL_LANES = 0.95
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores
# operations per slot of a live query's row: 3 sub, 3 mul, 2 add for d2 and
# at least one compare to select from it
FETCH_OPS_PER_SLOT = 9
# operations per valid feature and GN iteration, counted from the plain
# version (ops/gn_round.py) at K=8: transform 18, d2 64, 5-of-K selection
# 120, J row and J*J^T 120, plus the fit (line ~270, Householder plane ~560)
GN_OPS_PER_POINT = {"corner": 600, "surf": 900}


def tpu_kernel_line(file_name, kernel):
    """'path:line' in this checkout of the Pallas kernel a CUDA kernel
    replaces (searched for, so the reported line is the real one)."""
    for path in sorted(glob.glob(os.path.join(REPO, "*", "ops", file_name))):
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if line.startswith(f"def {kernel}("):
                    return f"{os.path.relpath(path, REPO)}:{n}"
    raise FileNotFoundError(f"{kernel} in */ops/{file_name}")


def print_ptxas(src, log):
    """The registers, stack and spill lines of ptxas -v, each with the
    kernel and template arguments (K first) it belongs to."""
    fn = "?"
    with open(log) as f:
        for line in f:
            m = re.search(r"entry function '\w*?([a-z_]+_kernel)I((?:Li\d+E)+)",
                          line)
            if m:
                args = ",".join(re.findall(r"\d+", m.group(2)))
                fn = f"{m.group(1)}<{args}>"
            elif "registers" in line or "spill" in line:
                print(f"ptxas {src} {fn}: {line.strip()}", flush=True)


def gn_variants(named_sources):
    """{name: call(args, iters, K=K, **kw) -> (stat', matP')} for other GN
    sources with the shipped C entry point, built like the shipped ones
    (one nvcc each, all at once), for A/B readings in this run.  A call
    runs the shipped wrapper ops.gn_round.gn_round (its checks and
    defaults) with its launch pointed at the other build."""
    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round)
    sos = kernels._build([Path(src).resolve() for _, src in named_sources])
    shipped = kernels.launch_gn_round
    calls = {}
    for (name, _), so in zip(named_sources, sos):
        print_ptxas(name, kernels.BUILD_DIR / (so.stem + ".log"))
        launch = functools.partial(shipped, lib=kernels.load(so))

        def call(args, iters, K=K, launch=launch, **kw):
            kernels.launch_gn_round = launch
            try:
                return gn_round(*args, K=K, iters=iters, **kw)
            finally:
                kernels.launch_gn_round = shipped
        calls[name] = call
    return calls


def live_only(args):
    """The GN inputs with each lane's live features (and their candidates)
    packed to the front and P cut to the batch's largest live count."""
    import torch
    stat, matP, fc, fs, cc, cs = args
    B = stat.shape[0]
    out = []
    for f, c in ((fc, cc), (fs, cs)):
        live = f[:, 3] != 0
        n = max(int(live.sum(1).max()), 1)
        order = torch.sort((~live).to(torch.int8), dim=1,
                           stable=True).indices[:, :n]
        out.append(torch.gather(f, 2, order[:, None].expand(-1, 4, -1))
                   .contiguous())
        out.append(torch.gather(c.view(3 * K, B, -1), 2,
                                order[None].expand(3 * K, -1, -1))
                   .reshape(3 * K, B * n).contiguous())
    return stat, matP, out[0], out[2], out[1], out[3]


def first_lanes(args, n):
    """The GN inputs of the first n lanes."""
    stat, matP, fc, fs, cc, cs = args
    B = stat.shape[0]

    def cut(c):
        return c.view(3 * K, B, -1)[:, :n].reshape(3 * K, -1).contiguous()
    return (stat[:n].contiguous(), matP[:n].contiguous(),
            fc[:n].contiguous(), fs[:n].contiguous(), cut(cc), cut(cs))


def gn_probes(name, call, rounds, n_sm, other_k):
    """Probe lines of one GN kernel at both rounds' inputs: ms per call for
    (a) the inputs as they are (with the histogram of per-lane iterations
    and us per lane-iteration), (b) convergence thresholds 0, so every
    valid lane runs exactly 1 or ITERS iterations, (c) live features only,
    (d) one lane per SM against all B lanes, (e) round 0 only (its lanes
    are at iteration 0): one iteration with the 6-sweep Jacobi against
    none, which prices the Jacobi; (f) round 1's inputs with the
    candidates of the other supported K (other_k = {K: args})."""
    import torch
    for r, args in enumerate(rounds):
        B = args[0].shape[0]
        ms = cuda_ms(lambda: call(args, ITERS), 10, graph=True)
        its = (call(args, ITERS)[0][:, 6] - args[0][:, 6]).long()
        hist = torch.bincount(its, minlength=ITERS + 1).tolist()
        print(f"probe gn {name} (a) round {r}: {ms:.4f} ms; lane-iterations"
              f" {int(its.sum())}, {ms * 1e3 / max(int(its.sum()), 1):.4f} "
              f"us each; iterations histogram (0..{ITERS}) {hist}",
              flush=True)
        fixed = [cuda_ms(lambda: call(args, n, conv_rot_deg=0.0,
                                      conv_trans_cm=0.0), 10, graph=True)
                 for n in (1, ITERS)]
        print(f"probe gn {name} (b) round {r}: iters 1 {fixed[0]:.4f} ms, "
              f"iters {ITERS} {fixed[1]:.4f} ms; "
              f"{(fixed[1] - fixed[0]) / (ITERS - 1):.4f} ms an iteration",
              flush=True)
        packed = live_only(args)
        ms_c = cuda_ms(lambda: call(packed, ITERS), 10, graph=True)
        print(f"probe gn {name} (c) round {r}: {ms_c:.4f} ms at Pc "
              f"{packed[2].shape[2]} Ps {packed[3].shape[2]} (from "
              f"{args[2].shape[2]} / {args[3].shape[2]})", flush=True)
        few = first_lanes(args, n_sm)
        ms_d = cuda_ms(lambda: call(few, ITERS), 10, graph=True)
        print(f"probe gn {name} (d) round {r}: B={n_sm} {ms_d:.4f} ms, "
              f"B={B} {ms:.4f} ms", flush=True)
        if r == 0:
            sweeps = [cuda_ms(lambda: call(args, 1, jacobi_sweeps=n), 10,
                              graph=True) for n in (6, 0)]
            print(f"probe gn {name} (e) round 0: iters 1 with the Jacobi "
                  f"{sweeps[0]:.4f} ms, without {sweeps[1]:.4f} ms",
                  flush=True)
    for k, args in other_k.items():
        ms = cuda_ms(lambda: call(args, ITERS, K=k), 10, graph=True)
        print(f"probe gn {name} (f) round 1 K={k}: {ms:.4f} ms", flush=True)


def cuda_ms(fn, reps, graph=False):
    """Mean device ms per call of fn over reps calls (after one warm-up).
    graph=True captures the reps calls in a CUDA graph and times one
    replay, so that a call shorter than its host-side launch (a GN round
    of one iteration) is timed on the device alone; fn must then not
    synchronize (the kernels' wrappers do not, the plain versions do)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for _ in range(reps):
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gn_bound(args, stat_out, K):
    """(bound_ms, bound_by, floor_ms) of one GN round on args = (stat,
    matP, featc, feats, candc, cands) that ended at stat_out: read once,
    the mask of every point and the xyz and candidates of each live one (a
    dead point's add nothing, so the kernel never reads them), stat/matP
    read and written; operations for the lane-iterations this run's data
    took.  floor_ms: the candidates and features of every live point
    streamed once per lane-iteration."""
    stat, _, fc, fs = args[:4]
    B = stat.shape[0]
    n_pts = fc.shape[2] + fs.shape[2]
    lane_iters = (stat_out[:, 6] - stat[:, 6]).clamp(min=0)
    live = {kind: (f[:, 3] != 0).sum(1).float()
            for kind, f in (("corner", fc), ("surf", fs))}
    n_live = float(sum(n.sum() for n in live.values()))
    ops = sum(float((lane_iters * n).sum()) * GN_OPS_PER_POINT[kind]
              for kind, n in live.items())
    ms, by = bound(B * n_pts * 4 + n_live * (3 + 3 * K) * 4
                   + B * (16 + 36) * 4 * 2, ops)
    streamed = float((lane_iters * (live["corner"] + live["surf"])).sum())
    return ms, by, streamed * (16 + 12 * K) / HBM_BYTES_PER_S * 1e3


def fetch_bound(table, bcell, K):
    """Bound of one fetch call: inputs (table, bcell, q) read once, d2 and
    candidates written once; 9 operations per slot of each live row."""
    Q = bcell.shape[0]
    W = table.shape[1] // 3
    live = int((bcell != table.shape[0] - 1).sum())
    nbytes = table.numel() * 4 + Q * 16 + Q * K * 16
    return bound(nbytes, live * W * FETCH_OPS_PER_SLOT)


def tile_rows(bcell, sentinel, tile):
    """(live queries, distinct (tile, row) pairs) of a query set cut into
    tiles of `tile` consecutive queries."""
    import torch
    q = torch.nonzero(bcell != sentinel)[:, 0]
    pairs = torch.unique((q // tile) * (sentinel + 1) + bcell[q].long())
    return q.numel(), pairs.numel()


def fetch_probes(raw_tq, rtab, presorted, queries_of):
    """Probe lines for both fetch kernels at one query set (CUDA events):
    (a) the queries as they are, (b) the same features presorted per lane,
    (c) every query at the sentinel, (d) every live query on one row; then
    K = 6/8/16 on (a).  raw_tq = (raw table, queries on raw block ids);
    rtab the same map's PlanarTable; presorted = presort_by_row's output;
    queries_of(xyz, mask) -> the queries of those features at (a)'s
    poses."""
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.ops.fetch import (
        block_fetch, resident_fetch)
    tab, (bc, qx, qy, qz) = raw_tq
    bcb, *qb = queries_of(*presorted[:2])
    tile = kernels.FETCH_TILE
    for name, fn, table, route in (
            ("block_fetch", block_fetch, tab, lambda b: b),
            ("resident_fetch", resident_fetch, rtab.table,
             lambda b: rtab.rows_index[b.long()])):
        W = table.shape[1] // 3
        sent = table.shape[0] - 1
        a = route(bc)
        live = a != sent
        one_row = torch.where(live, a[live][0], sent).to(torch.int32)
        patterns = {"a": (a, qx, qy, qz), "b": (route(bcb), *qb),
                    "c": (torch.full_like(a, sent), qx, qy, qz),
                    "d": (one_row.contiguous(), qx, qy, qz)}
        for p, q in patterns.items():
            n_live, pairs = tile_rows(q[0], sent, tile)
            ms = cuda_ms(lambda: fn(table, *q, K=K), 20)
            print(f"probe {name} ({p}) K={K}: {ms:.4f} ms; Q {q[0].shape[0]}"
                  f" live {n_live} W {W}; tile-row pairs {pairs} (tile "
                  f"{tile}): row bytes {pairs * 12 * W} once per tile-row vs"
                  f" {n_live * 12 * W} once per query", flush=True)
        for k in (6, 8, 16):
            ms = cuda_ms(lambda: fn(table, *patterns["a"], K=k), 20)
            print(f"probe {name} (a) K={k}: {ms:.4f} ms", flush=True)


def main():
    import torch

    from feature_base_pointcloud_registration_tpu_torch import kernels
    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.device import (
        require_cuda)
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, build_feature_map, simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.ops.features import (
        extract_features)
    from feature_base_pointcloud_registration_tpu_torch.ops.fetch import (
        PlanarTable, block_fetch, block_fetch_reference, resident_fetch,
        resident_fetch_reference)
    from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import (
        gn_round, gn_round_reference)
    from feature_base_pointcloud_registration_tpu_torch.ops.hashgrid import (
        grid_overflow_fraction)
    from feature_base_pointcloud_registration_tpu_torch.ops.projection import (
        project_scan)
    from feature_base_pointcloud_registration_tpu_torch.parallel import (
        batch as pbatch)
    from feature_base_pointcloud_registration_tpu_torch.parallel.batch import (
        batch_register_blocks, batch_register_fused, batch_register_pallas,
        build_map_block_tables, build_map_planar_tables, feature_planes,
        fetch_queries, initial_state, presort_by_row)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        FeatureMap, RawScan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (  # noqa: E501
        downsample_features)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gn-ab", action="append", default=[],
                    metavar="NAME=PATH", type=lambda v: v.split("=", 1),
                    help="another gn_round.cu to time beside the shipped one")
    args = ap.parse_args()
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for log in sorted(glob.glob(os.path.join(kernels.BUILD_DIR,
                                             "libfbpr_*.log"))):
        print_ptxas(os.path.basename(log).split("-")[0][len("libfbpr_"):],
                    log)
    variants = gn_variants(args.gn_ab)

    # ---- setup: bench.py's scans, guesses and map, from seeds ----
    params = Params(map_corner_cap=16384, map_surf_cap=65536)
    world = SyntheticWorld()
    rng = np.random.RandomState(0)
    raws, gt = [], []
    for i in range(B):
        pose = np.array([0, 0, rng.uniform(-1, 1), rng.uniform(-6, 6),
                         rng.uniform(-6, 6), 0.0], np.float32)
        s = simulate_scan(world, pose, seed=i)
        raws.append((s["xyz"], s["intensity"], s["ring"], s["time"],
                     s["valid"]))
        gt.append(pose)
    raw = RawScan(*(torch.from_numpy(np.stack(a)).to(dev)
                    for a in zip(*raws)))
    gt = np.stack(gt)
    guesses = gt + rng.uniform(-1, 1, (B, 6)).astype(np.float32) * np.array(
        [0.02, 0.02, 0.05, 0.3, 0.3, 0.1], np.float32)
    guesses_t = torch.from_numpy(guesses).to(dev)
    mcx, mcm, msx, msm = build_feature_map(world, params.map_corner_cap,
                                           params.map_surf_cap)
    fmap = FeatureMap(*(torch.from_numpy(a).to(dev)
                        for a in (mcx, mcm, msx, msm)))
    center = np.array([0.0, 0.0, (world.ground_z + world.ceil_z) / 2],
                      np.float32)
    half = np.array([world.half_x + 1, world.half_y + 1,
                     (world.ceil_z - world.ground_z) / 2 + 1], np.float32)

    def frontend(r):
        return downsample_features(
            params, extract_features(params, project_scan(params, r)))

    def tables(resident=False):
        return build_map_planar_tables(fmap, center, half,
                                       corner_cell_cap=CCAP,
                                       surf_cell_cap=SCAP, resident=resident)

    def solve(feats, tabs):
        ctab, stab, origin, dims = tabs
        return batch_register_fused(
            feats, ctab, stab, origin, guesses_t, grid_dims=dims,
            iters_per_round=ITERS, num_candidates=K,
            round1_surf_stride=R1S, round1_corner_stride=R1C)

    feats = frontend(raw)
    ctab, stab, origin, dims = tabs = tables()
    n_corner = feats.corner_mask.sum(1).float().mean().item()
    n_surf = feats.surf_mask.sum(1).float().mean().item()
    print(f"setup: B={B} corner/scan {n_corner:.0f} surf/scan {n_surf:.0f} "
          f"tables corner {tuple(ctab.shape)} surf {tuple(stab.shape)} "
          f"dims {dims}", flush=True)

    # ---- the main path's round 0 (its inputs kept for phase 2 and the
    # timing), to reach its round-1 queries ----
    stat, matP = initial_state(feats, guesses_t)
    fc = feature_planes(feats.corner_xyz, feats.corner_mask)
    fs = feature_planes(feats.surf_xyz, feats.surf_mask)
    q0c = fetch_queries(stat[:, :6], feats.corner_xyz[:, ::R1C],
                        feats.corner_mask[:, ::R1C], ctab, origin, 2.0, dims)
    q0s = fetch_queries(stat[:, :6], feats.surf_xyz[:, ::R1S],
                        feats.surf_mask[:, ::R1S], stab, origin, 2.0, dims)
    gn_args0 = (stat, matP, fc[:, :, ::R1C].contiguous(),
                fs[:, :, ::R1S].contiguous(), block_fetch(ctab, *q0c, K=K)[1],
                block_fetch(stab, *q0s, K=K)[1])
    stat, matP = gn_round(*gn_args0, K=K, iters=ITERS)
    stat[:, 7] = 0.0
    queries = {
        "corner": (ctab, fetch_queries(stat[:, :6], feats.corner_xyz,
                                       feats.corner_mask, ctab, origin, 2.0,
                                       dims)),
        "surf": (stab, fetch_queries(stat[:, :6], feats.surf_xyz,
                                     feats.surf_mask, stab, origin, 2.0,
                                     dims)),
    }

    # ---- phase 1: fetch kernel vs plain version, bitwise ----
    cands, raw_d2, fetch_err = {}, {}, 0.0
    for kind, (tab, q) in queries.items():
        d2k, ck = block_fetch(tab, *q, K=K)
        torch.cuda.synchronize()
        d2r, cr = block_fetch_reference(tab, *q, K=K)
        live = (q[0] != tab.shape[0] - 1).float().mean().item()
        err = max((d2k - d2r).abs().max().item(),
                  (ck - cr).abs().max().item())
        print(f"phase 1 fetch {kind}: Q={q[0].shape[0]} W={tab.shape[1] // 3}"
              f" live {live:.3f} d2 equal {torch.equal(d2k, d2r)} cand equal"
              f" {torch.equal(ck, cr)} max_abs_err {err}", flush=True)
        if not (torch.equal(d2k, d2r) and torch.equal(ck, cr)):
            raise AssertionError(f"fetch kernel != plain version ({kind})")
        cands[kind] = ck
        raw_d2[kind] = d2k
        fetch_err = max(fetch_err, err)

    # ---- phase 2: GN kernel vs plain version on both rounds' inputs ----
    gn_args = (stat, matP, fc, fs, cands["corner"], cands["surf"])
    gn_rounds = (gn_args0, gn_args)
    gn_out, gn_plain, gn_err = [], [], 0.0
    for r, a in enumerate(gn_rounds):
        sk, mk = gn_round(*a, K=K, iters=ITERS)
        torch.cuda.synchronize()
        sr, mr = gn_round_reference(*a, K=K, iters=ITERS)
        dpose = (sk[:, :6] - sr[:, :6]).abs()
        err = dpose.max().item()
        first = int(((a[0][:, 6] == 0) & (a[0][:, 9] > 0)).sum())
        its_eq = (sk[:, 6] == sr[:, 6]).float().mean().item()
        ncorr_eq = (sk[:, 10] == sr[:, 10]).float().mean().item()
        print(f"phase 2 gn round {r}: Pc={a[2].shape[2]} Ps={a[3].shape[2]}"
              f" lanes at iteration 0 (Jacobi) {first}; pose |diff| max "
              f"{err:.3e} median {dpose.max(1).values.median().item():.3e};"
              f" iterations equal {its_eq:.3f}; n_corr equal {ncorr_eq:.3f};"
              f" matP |diff| max {(mk - mr).abs().max().item():.3e}",
              flush=True)
        if not err <= 1e-3:
            raise AssertionError(f"GN kernel vs plain version, round {r}: "
                                 f"{err} > 1e-3")
        if not min(its_eq, ncorr_eq) >= GN_EQUAL_LANES:
            raise AssertionError(
                f"GN kernel vs plain version, round {r}: iterations equal on"
                f" {its_eq:.3f}, n_corr on {ncorr_eq:.3f} of lanes (want >= "
                f"{GN_EQUAL_LANES})")
        gn_out.append(sk)
        gn_plain.append(sr)
        gn_err = max(gn_err, err)
    for name, call in variants.items():
        errs = [(call(a, ITERS)[0][:, :6] - sr[:, :6]).abs().max().item()
                for a, sr in zip(gn_rounds, gn_plain)]
        print(f"phase 2 gn {name}: pose |diff| max vs plain version "
              f"round 0 {errs[0]:.3e} round 1 {errs[1]:.3e}", flush=True)

    # ---- phase 3: the slice end to end, counted ----
    wrappers = {"block_fetch": block_fetch, "resident_fetch": resident_fetch,
                "gn_round": gn_round}

    def zero_counts():
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0

    def read_counts(phase, want):
        torch.cuda.synchronize()
        got = {name: w.launches for name, w in wrappers.items()}
        print(f"phase {phase} launches: {got}", flush=True)
        if got != want:
            raise AssertionError(f"phase {phase} launches {got}, want {want}")
        return got

    per_round = []

    def counted_gn(*a, **kw):           # GN launches of each round
        before = gn_round.launches
        out = gn_round(*a, **kw)
        per_round.append(gn_round.launches - before)
        return out

    zero_counts()
    feats3 = frontend(raw)
    pbatch.gn_round = counted_gn
    try:
        res = solve(feats3, tables())
    finally:
        pbatch.gn_round = gn_round
    launches = read_counts(3, {"block_fetch": 4, "resident_fetch": 0,
                               "gn_round": 2})
    print(f"phase 3 gn launches per round: {per_round}", flush=True)
    if per_round != [1, 1]:
        raise AssertionError(f"GN launches per round {per_round}")

    pose = res.pose6.cpu().numpy()
    if not (np.isfinite(pose).all() and pose.shape == (B, 6)):
        raise AssertionError("non-finite or misshapen poses")
    err_t = np.linalg.norm(pose[:, 3:] - gt[:, 3:], axis=1)
    ate_gt = float(np.sqrt((err_t ** 2).mean()))
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle
    fe = [a.cpu().numpy() for a in feats3]
    mc, ms = mcx[mcm], msx[msm]
    n_or = min(N_ORACLE, B)
    oracle_poses = np.stack([
        oracle.register_scan(fe[0][i][fe[1][i]], fe[2][i][fe[3][i]], mc, ms,
                             guesses[i])[0] for i in range(n_or)])
    d = pose[:n_or, 3:] - oracle_poses[:, 3:]
    ate_oracle = float(np.sqrt((d ** 2).sum(-1).mean()))
    ovf = [float(grid_overflow_fraction(xyz, m, origin, 2.0, dims=dims,
                                        cell_cap=cap))
           for xyz, m, cap in ((fmap.corner_xyz, fmap.corner_mask, CCAP),
                               (fmap.surf_xyz, fmap.surf_mask, SCAP))]
    n_conv = int(res.converged.sum())
    print(f"phase 3: n_converged {n_conv}/{B} valid {int(res.valid.sum())} "
          f"degenerate {int(res.is_degenerate.sum())} mean iterations "
          f"{res.iterations.float().mean().item():.2f} ate_vs_gt_m {ate_gt} "
          f"ate_vs_oracle_m {ate_oracle} grid_overflow {ovf}", flush=True)
    if not ate_oracle <= PARITY_BUDGET:
        raise AssertionError(f"ate_vs_oracle_m {ate_oracle} > "
                             f"{PARITY_BUDGET}")

    def ate_oracle_of(poses):
        d = poses[:n_or, 3:] - oracle_poses[:, 3:]
        return float(np.sqrt((d ** 2).sum(-1).mean()))

    # ---- phase 4: resident fetch kernel vs plain version, bitwise ----
    rtabs = tables(resident=True)
    if not all(isinstance(t, PlanarTable) for t in rtabs[:2]):
        raise AssertionError("resident=True did not compact both tables")
    rqueries, res_err = {}, 0.0
    for kind, rtab in (("corner", rtabs[0]), ("surf", rtabs[1])):
        tab, q = queries[kind]
        rows = rtab.rows_index[q[0].long()]
        rq = rqueries[kind] = (rtab.table, (rows, *q[1:]))
        d2k, ck = resident_fetch(rq[0], *rq[1], K=K)
        torch.cuda.synchronize()
        d2r, cr = resident_fetch_reference(rq[0], *rq[1], K=K)
        err = max((d2k - d2r).abs().max().item(),
                  (ck - cr).abs().max().item())
        res_err = max(res_err, err)
        Rp = rtab.table.shape[0] - 1
        found = rows != Rp
        print(f"phase 4 resident {kind}: Q={rows.shape[0]} "
              f"W={rtab.table.shape[1] // 3} live {found.float().mean().item():.3f}"
              f" compact rows {Rp} ({rtab.table.numel() * 4} B) raw rows "
              f"{tab.shape[0] - 1} ({tab.numel() * 4} B); d2 equal "
              f"{torch.equal(d2k, d2r)} cand equal {torch.equal(ck, cr)} "
              f"max_abs_err {err}; vs raw fetch: d2 equal "
              f"{torch.equal(d2k, raw_d2[kind])}, cand equal where found "
              f"{torch.equal(ck[:, found], cands[kind][:, found])}",
              flush=True)
        if not (torch.equal(d2k, d2r) and torch.equal(ck, cr)):
            raise AssertionError(f"resident kernel != plain version ({kind})")
        if not (torch.equal(d2k, raw_d2[kind])
                and torch.equal(ck[:, found], cands[kind][:, found])):
            raise AssertionError(f"resident fetch != raw fetch ({kind})")

    # ---- phase 5: the main path on resident tables, counted ----
    zero_counts()
    res5 = solve(feats3, tables(resident=True))
    launches5 = read_counts(5, {"block_fetch": 0, "resident_fetch": 4,
                                "gn_round": 2})
    pose5 = res5.pose6.cpu().numpy()
    d5 = float(np.abs(pose5 - pose).max())
    ate5 = ate_oracle_of(pose5)
    print(f"phase 5: pose |diff| vs phase 3 max {d5}; n_converged "
          f"{int(res5.converged.sum())}/{B} ate_vs_oracle_m {ate5}",
          flush=True)
    if not (np.isfinite(pose5).all() and d5 <= 1e-6):
        raise AssertionError(f"resident main path moved poses by {d5}")
    if not ate5 <= PARITY_BUDGET:
        raise AssertionError(f"phase 5 ate_vs_oracle_m {ate5}")

    # ---- phase 6: the rounds-structured solver, counted ----
    def solve_rounds(feats, tabs_, n=B):
        ctab_, stab_, origin_, dims_ = tabs_
        return batch_register_pallas(
            feats, ctab_, stab_, origin_, guesses_t[:n], grid_dims=dims_,
            corner_cell_cap=CCAP, surf_cell_cap=SCAP, num_rounds=2,
            iters_per_round=ITERS, num_candidates=K)

    zero_counts()
    res6 = solve_rounds(feats3, rtabs)
    read_counts(6, {"block_fetch": 0, "resident_fetch": 4,
                  "gn_round": 0})
    pose6 = res6.pose6.cpu().numpy()
    err6 = np.linalg.norm(pose6[:, 3:] - gt[:, 3:], axis=1)
    ate6_gt = float(np.sqrt((err6 ** 2).mean()))
    ate6 = ate_oracle_of(pose6)
    btabs = build_map_block_tables(fmap, center, half, corner_cell_cap=CCAP,
                                   surf_cell_cap=SCAP)
    sub = type(feats3)(*(a[:N_BLOCKS] for a in feats3))
    res_b = batch_register_blocks(
        sub, btabs[0], btabs[1], btabs[2], guesses_t[:N_BLOCKS],
        grid_dims=btabs[3], corner_cell_cap=CCAP, surf_cell_cap=SCAP,
        num_rounds=2, iters_per_round=ITERS, num_candidates=K)
    d6 = float(np.abs(res_b.pose6.cpu().numpy() - pose6[:N_BLOCKS]).max())
    print(f"phase 6: n_converged {int(res6.converged.sum())}/{B} degenerate "
          f"{int(res6.is_degenerate.sum())} mean iterations "
          f"{res6.iterations.float().mean().item():.2f} ate_vs_gt_m {ate6_gt}"
          f" ate_vs_oracle_m {ate6}; batch_register_blocks on {N_BLOCKS} "
          f"scans: pose |diff| max {d6}", flush=True)
    if not (np.isfinite(pose6).all() and ate6 <= PARITY_BUDGET):
        raise AssertionError(f"phase 6 ate_vs_oracle_m {ate6}")
    if not d6 <= 1e-4:
        raise AssertionError(f"batch_register_blocks vs pallas: {d6}")

    # ---- timing (CUDA events; not counted as main-path launches) ----
    def fetch_times(fn, plain, tab_q):
        return (cuda_ms(lambda: fn(tab_q[0], *tab_q[1], K=K), 20),
                cuda_ms(lambda: plain(tab_q[0], *tab_q[1], K=K), 2))

    kt = {
        "fetch_surf": fetch_times(block_fetch, block_fetch_reference,
                                  queries["surf"]),
        "fetch_corner": fetch_times(block_fetch, block_fetch_reference,
                                    queries["corner"]),
        "resident_surf": fetch_times(resident_fetch, resident_fetch_reference,
                                     rqueries["surf"]),
        "resident_corner": fetch_times(resident_fetch,
                                       resident_fetch_reference,
                                       rqueries["corner"]),
        "gn_round": (cuda_ms(lambda: gn_round(*gn_args, K=K, iters=ITERS),
                             10, graph=True),
                     cuda_ms(lambda: gn_round_reference(*gn_args, K=K,
                                                        iters=ITERS), 2)),
        "gn_round0": (cuda_ms(lambda: gn_round(*gn_args0, K=K,
                                               iters=ITERS), 10, graph=True),
                      cuda_ms(lambda: gn_round_reference(*gn_args0, K=K,
                                                         iters=ITERS), 2)),
    }
    bounds = {name: fetch_bound(tq[0], tq[1][0], K) for name, tq in (
        ("fetch_surf", queries["surf"]), ("fetch_corner", queries["corner"]),
        ("resident_surf", rqueries["surf"]),
        ("resident_corner", rqueries["corner"]))}
    floors = {}
    for name, a, out in (("gn_round0", gn_args0, gn_out[0]),
                         ("gn_round", gn_args, gn_out[1])):
        *bounds[name], floors[name] = gn_bound(a, out, K)
    for name, (ms_k, ms_p) in kt.items():
        floor = (f", streamed floor {floors[name]:.4f} ms"
                 if name in floors else "")
        print(f"time {name}: kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}){floor}",
              flush=True)
    for vname, call in variants.items():
        print(f"time gn_round0 {vname}: "
              f"{cuda_ms(lambda: call(gn_args0, ITERS), 10, True):.3f} ms; "
              f"gn_round {vname}: "
              f"{cuda_ms(lambda: call(gn_args, ITERS), 10, True):.3f} ms",
              flush=True)
    t_front = cuda_ms(lambda: frontend(raw), 3)
    t_tables = cuda_ms(tables, 3)
    t_solve = cuda_ms(lambda: solve(feats3, tabs), 5)
    t_solve5 = cuda_ms(lambda: solve(feats3, rtabs), 5)
    t_solve6 = cuda_ms(lambda: solve_rounds(feats3, rtabs), 1)
    t_e2e = cuda_ms(lambda: solve(frontend(raw), tables()), 3)
    print(f"time: frontend {t_front / B:.4f} ms/scan, tables {t_tables:.2f} "
          f"ms, solve {t_solve / B:.4f} ms/scan ({B * 1e3 / t_solve:.1f} "
          f"scans/s), e2e {B * 1e3 / t_e2e:.1f} scans/s (tables included); "
          f"phase 5 solve (resident tables) {t_solve5 / B:.4f} ms/scan, "
          f"phase 6 solve (batch_register_pallas) {t_solve6 / B:.4f} ms/scan",
          flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    other_k = {k: (stat, matP, fc, fs,
                   *(block_fetch(tq[0], *tq[1], K=k)[1]
                     for tq in (queries["corner"], queries["surf"])))
               for k in kernels.SUPPORTED_K if k != K}
    gn_probes("shipped",
              lambda a, n, K=K, **kw: gn_round(*a, K=K, iters=n, **kw),
              gn_rounds, n_sm, other_k)
    for vname, call in variants.items():
        gn_probes(vname, call, gn_rounds, n_sm, other_k)
    fetch_probes(queries["surf"], rtabs[1],
                 presort_by_row(guesses_t, feats.surf_xyz, feats.surf_mask,
                                stab, origin, 2.0, dims),
                 lambda xyz, m: fetch_queries(stat[:, :6], xyz, m, stab,
                                              origin, 2.0, dims))

    def entry(name, source, replaces, launches_, err, timed, **extra):
        return {"name": name, "route": "cuda",
                "source": "feature_base_pointcloud_registration_tpu_torch/"
                          f"csrc/{source}",
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": kt[timed][0],
                "plain_ms": kt[timed][1], "bound_ms": bounds[timed][0],
                "bound_by": bounds[timed][1], "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        entry("block_fetch", "block_fetch.cu",
              tpu_kernel_line("pallas_fetch.py", "_fetch_kernel"),
              launches["block_fetch"], fetch_err, "fetch_surf"),
        entry("gn_round", "gn_round.cu",
              tpu_kernel_line("pallas_gn.py", "_gn_round_kernel"),
              launches["gn_round"], gn_err, "gn_round",
              ms_round0=kt["gn_round0"][0],
              bound_ms_round0=bounds["gn_round0"][0],
              launches_per_round=per_round),
        entry("resident_fetch", "resident_fetch.cu",
              tpu_kernel_line("pallas_fetch.py", "_resident_kernel"),
              launches5["resident_fetch"], res_err, "resident_surf"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
