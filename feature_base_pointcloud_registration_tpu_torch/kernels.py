"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Each source compiles with `nvcc` into its own shared library with a plain C
interface, bound with ctypes (no PyTorch headers, so a build takes seconds;
the nvcc processes of all sources run at once):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/libfbpr_<source>-<hash>.so csrc/<source>.cu

The build runs at first use, into `build/` beside the package (the file name
carries a hash of the flags, the source and the `csrc/` headers it
includes, so an edited source or header rebuilds).  `SOURCE_FLAGS` adds a
source's own flags (rounds_gn.cu, pose_graph_lm.cu, imu_chain_lm.cu,
preintegration.cu, knn_stream.cu, icp.cu, exact_gn.cu: no FMA
contraction).
Importing this module builds nothing: the CPU tests import every module.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns `cudaGetLastError()`; the launch
helpers below raise when it is not 0.  Validation of shapes, dtypes and
devices is the callers' (`ops/fetch.py`, `ops/gn_round.py`,
`ops/rounds_gn.py`, `ops/features.py`, `graph/pose_graph.py`,
`graph/imu_graph.py`, `imu/preintegration.py`, `ops/knn.py`,
`ops/icp.py`, `ops/exact_gn.py`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from types import SimpleNamespace

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SUPPORTED_K = (6, 8, 16)  # template instances in csrc/*.cu
RESIDENT_MAX_W = 512      # csrc/resident_fetch.cu: W = 128 * (1..4)
BLOCK_FETCH_MAX_W = 16000  # csrc/fetch_tile.cuh kMaxW: one row of 12*W bytes
                           # and a tile's results fit 227 KB of shared memory
FETCH_TILE = 128          # queries per block of both fetch kernels
                          # (csrc/fetch_tile.cuh kTile)
RING_PICK_MAX_W = 8192    # csrc/ring_pick.cu: a window's sort words,
                          # marks and labels (18 B a slot in strict mode)
                          # fit 227 KB of shared memory
POSE_GRAPH_LM_MAX_LIVE = 38  # csrc/pose_graph_lm.cu kMaxLive: route A's H
                             # (6n x (6n + 1) floats) and buffers fit 227 KB
KNN_MAX_K = 16            # csrc/knn_stream.cu: template instances K 1..16
ROUNDS_MAX_CLUSTER = 16   # csrc/rounds_gn.cu kMaxCluster: CTAs a lane
# points (Pc + Ps) a CTA of csrc/rounds_gn.cu keeps at least when a lane is
# spread over a cluster: chip_smoke.py's `probe rounds_gn C sweep` (one
# K=16 lane of 320 to 10240 live points on an H100) ran fastest at 160
# points a CTA at every size up to 2560 points, and at 16 CTAs above
ROUNDS_MIN_SHARE = 160
# feature slots (Pc + Ps) a CTA of csrc/exact_gn.cu keeps at least when a
# lane is spread over a cluster (a lane's work is its live features' scans
# of the map, so a lane takes every CTA the card can give it down to a
# share of 64 slots).  A guess, not measured: at chip_smoke.py's shapes the
# wave (B * C <= SMs) or the 16-CTA cap binds first
EXACT_MIN_SHARE = 64
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Flags of one source on top of NVCC_FLAGS.  rounds_gn.cu,
# pose_graph_lm.cu, imu_chain_lm.cu and preintegration.cu stand for the
# port's plain-PyTorch loop bodies, whose operations round one by one: their
# multiply-adds are not contracted into FMAs (chip_smoke.py's probe (b)
# prints rounds_gn's FMA build beside it; the pose graph's and the IMU
# chain's factors repeat the plain version's dual-number operations, whose
# NaN and infinite Jacobian entries must fall where the plain version's
# do).  knn_stream.cu and icp.cu repeat the plain k-NN's norms and d2, and
# the plain Kabsch's sums, each a separate PyTorch operation
# (chip_smoke.py's `probe knn` / `probe icp` lines print their FMA builds
# beside them); exact_gn.cu repeats both the k-NN's and the loop body's.
SOURCE_FLAGS = {"rounds_gn": ["-fmad=false"], "pose_graph_lm": ["-fmad=false"],
                "imu_chain_lm": ["-fmad=false"],
                "preintegration": ["-fmad=false"],
                "knn_stream": ["-fmad=false"], "icp": ["-fmad=false"],
                "exact_gn": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_D = ctypes.c_double
# a pose graph's factors (csrc/pose_graph_lm.cu Factors): the endpoints
# (prior, between i, between j, GPS), then meas, sigma, mask of each kind,
# Fp, Fb, Fg
_FACTORS = [_P] * 10 + [_I] * 3
# an IMU chain (csrc/imu_chain.cuh ChainData): states, state_mask, the
# twelve preintegration leaves, preint_mask, pose_meas, pose_sigma,
# pose_meas_mask, prior_state, prior_sigma, bias_sigma, gravity; K
_CHAIN = [_P] * 22 + [_I]
_SIGNATURES = {
    # table, rows, W, bcell, qx, qy, qz, Q, K, d2, cand, stream
    "fbpr_block_fetch": [_P, _L, _I, _P, _P, _P, _P, _L, _I, _P, _P, _P],
    # the same arguments, the table a compact one (ops/fetch.PlanarTable)
    "fbpr_resident_fetch": [_P, _L, _I, _P, _P, _P, _P, _L, _I, _P, _P, _P],
    # stat, matP, featc, feats, candc, cands, B, Pc, Ps, K, iters,
    # min_corr, eig_thresh, conv_rot_deg, conv_trans_cm, jacobi_sweeps,
    # min_plane_spread, stream
    "fbpr_gn_round": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                      _F, _I, _F, _P],
    # stat, matP, featc, feats, candc, cands, cd2, sd2, B, Pc, Ps, K, iters,
    # min_corr, eig_thresh, conv_rot_deg, conv_trans_cm, min_plane_spread,
    # cluster, stream
    "fbpr_rounds_gn": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _F, _F, _F, _F, _I, _P],
    # K, cluster, out (int32): resident clusters of that size
    "fbpr_rounds_gn_max_clusters": [_I, _I, _P],
    # out (uint64 [8]), reset: rounds_gn.cu's clock64 sums, defined only
    # by its diagnostic build (-DFBPR_ROUNDS_PROFILE)
    "fbpr_rounds_gn_profile": [_P, _I],
    # curv, col, picked, sp, ep, sector_ok, n_windows, W, edge_threshold,
    # surf_threshold, strict, label, stream
    "fbpr_ring_pick": [_P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _I, _P, _P],
    # out (uint64 [8]), reset: ring_pick.cu's clock64 sums, defined only by
    # its diagnostic build (-DFBPR_RING_PICK_PROFILE)
    "fbpr_ring_pick_profile": [_P, _I],
    # poses, pose_mask, live_idx, rowmap, *_FACTORS, K, n, iterations,
    # out_poses, out_cost, accepts, stream
    "fbpr_pose_graph_lm": [_P, _P, _P, _P, *_FACTORS, _I, _I, _I, _P, _P, _P,
                           _P],
    # live poses, *_FACTORS, n, H, grad, state, it, stream
    "fbpr_pose_graph_assemble": [_P, *_FACTORS, _I, _P, _P, _P, _I, _P],
    # live poses, dx, info, *_FACTORS, n, state, accepts, it, stream
    "fbpr_pose_graph_update": [_P, _P, _P, *_FACTORS, _I, _P, _P, _I, _P],
    # poses, K, *_FACTORS, r_p, J_p, r_b, J_bi, J_bj, r_g, J_g, stream
    "fbpr_pose_graph_blocks": [_P, _I, *_FACTORS, _P, _P, _P, _P, _P, _P, _P,
                               _P],
    # out (uint64 [12]), reset: pose_graph_lm.cu's clock64 stage sums,
    # defined only by its diagnostic build (-DFBPR_LM_PROFILE)
    "fbpr_pose_graph_lm_profile": [_P, _I],
    # *_CHAIN, iterations, scratch, scratch floats, out_states, out_cost,
    # accepts, stream
    "fbpr_imu_chain_lm": [*_CHAIN, _I, _P, _L, _P, _P, _P, _P],
    # out (uint64 [12]), reset: imu_chain_lm.cu's clock64 stage sums,
    # defined only by its diagnostic build (-DFBPR_LM_PROFILE)
    "fbpr_imu_chain_lm_profile": [_P, _I],
    # *_CHAIN, states, r_imu, Ji, Jj, r_b, Jbi, Jbj, r_pp, Jpp, r_0, J_0,
    # stream
    "fbpr_imu_chain_blocks": [*_CHAIN, _P, *[_P] * 10, _P],
    # acc, gyr, dt, mask, bias_acc, bias_gyr, acc_var, gyr_var, int_var, N,
    # the twelve PreintState leaves, stream
    "fbpr_preintegrate": [*[_P] * 6, _F, _F, _F, _I, *[_P] * 12, _P],
    # R0, p0, v0, bias_acc, bias_gyr, acc, gyr, dt, mask, -gravity, N, R, p,
    # v, stream
    "fbpr_propagate_states": [*[_P] * 9, _F, _I, _P, _P, _P, _P],
    # query, center, map, mask, map_stride, mask_stride, S, Q, M, one_chunk,
    # K, d2, idx, stream
    "fbpr_knn": [_P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _P, _P, _P],
    # N, M, out (grid, lanes a row, cell cap, scratch floats: int64 [4])
    "fbpr_icp_plan": [_I, _I, _P],
    # src, src_mask, dst, dst_mask, N, M, chunk, max_d2, max_iterations,
    # eps, scratch, scratch floats, T, fitness, converged, iterations,
    # delta, stream
    "fbpr_icp": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _D, _P, _L, _P, _P, _P,
                 _P, _P, _P],
    # out (uint64 [14]), reset: icp.cu's clock64 stage sums, defined only by
    # its diagnostic build (-DFBPR_ICP_PROFILE)
    "fbpr_icp_profile": [_P, _I],
    # out (uint64 [19]), reset: preintegration.cu's clock64 sums by warp
    # role, defined only by its diagnostic build (-DFBPR_PREINT_PROFILE)
    "fbpr_preintegrate_profile": [_P, _I],
    # pose, cxyz, cmask, sxyz, smask, cmap, cmmask, cmap_stride, smap,
    # smmask, smap_stride, B, Pc, Ps, Mc, Ms, iters, min_corr, eig_thresh,
    # conv_rot_deg, conv_trans_cm, edge_min_valid, surf_min_valid, scratch,
    # stat, nn_idx, nn_d2, cluster, the corner and the surf centroid's (S,
    # H, factor) (exact_gn_mean_order), stream
    "fbpr_exact_gn": [_P, _P, _P, _P, _P, _P, _P, _L, _P, _P, _L, _I, _I, _I,
                      _I, _I, _I, _I, _F, _F, _F, _I, _I, _P, _P, _P, _P, _I,
                      _I, _I, _F, _I, _I, _F, _P],
    # cluster, out (int32): resident clusters of that size
    "fbpr_exact_gn_max_clusters": [_I, _P],
}

# entry points that only a diagnostic build of a source defines
_DIAGNOSTIC = {"fbpr_rounds_gn_profile", "fbpr_ring_pick_profile",
               "fbpr_pose_graph_lm_profile", "fbpr_imu_chain_lm_profile",
               "fbpr_icp_profile", "fbpr_preintegrate_profile"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")


def _local_includes(src: Path) -> list:
    """The headers beside a source that it includes with `#include
    "..."` (the headers include none of their own)."""
    return [src.parent / name for name in re.findall(
        r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M)]


def _flags(stem: str, extra_flags=()) -> list:
    """nvcc's flags for a source: NVCC_FLAGS, its SOURCE_FLAGS entry and
    extra_flags (a diagnostic build's -D...); an -fmad= among extra_flags
    takes the place of the source's own (the FMA builds pass -fmad=true)."""
    own = SOURCE_FLAGS.get(stem, [])
    if any(f.startswith("-fmad=") for f in extra_flags):
        own = [f for f in own if not f.startswith("-fmad=")]
    return [*NVCC_FLAGS, *own, *extra_flags]


def _build(sources, extra_flags=()) -> list:
    """One shared library per source, all nvcc processes started together,
    each with `_flags(stem, extra_flags)`; returns their paths (existing
    ones are reused)."""
    jobs, sos = [], []
    for src in sources:
        flags = _flags(src.stem, extra_flags)
        h = hashlib.sha256(" ".join(flags).encode())
        for path in (src, *_local_includes(src)):
            h.update(path.read_bytes())
        so = BUILD_DIR / f"libfbpr_{src.stem}-{h.hexdigest()[:16]}.so"
        sos.append(so)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *flags, "-o", tmp, str(src)]
        jobs.append((so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for so, tmp, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{so.name}: nvcc failed ({proc.returncode}):\n{out}")
            continue
        (BUILD_DIR / (so.stem + ".log")).write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return sos


def load(so: Path) -> SimpleNamespace:
    """One built library: an attribute per C entry point of `_SIGNATURES`
    that it defines."""
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = fns[name] = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return SimpleNamespace(**fns)


@functools.lru_cache(maxsize=None)
def library() -> SimpleNamespace:
    """Build the kernels (first call per source hash) and load them: one
    attribute per C entry point of `_SIGNATURES`."""
    fns = {}
    for so in _build(sorted(CSRC.glob("*.cu"))):
        fns.update(vars(load(so)))
    missing = set(_SIGNATURES) - set(fns) - _DIAGNOSTIC
    if missing:
        raise RuntimeError(f"csrc/ defines no {sorted(missing)}")
    return SimpleNamespace(**fns)


def _check_k(K: int):
    if K not in SUPPORTED_K:
        raise ValueError(f"K={K}: the CUDA kernels are built for K in "
                         f"{SUPPORTED_K}")


def _check_rc(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_block_fetch(table, bcell, qx, qy, qz, d2, cand, *, K: int):
    """csrc/block_fetch.cu on validated CUDA tensors (see ops/fetch.py);
    W up to BLOCK_FETCH_MAX_W, since a block stages at least one whole row
    in shared memory."""
    _check_k(K)
    W = table.shape[1] // 3
    if W > BLOCK_FETCH_MAX_W:
        raise ValueError(f"W={W}: the block-fetch kernel takes W up to "
                         f"{BLOCK_FETCH_MAX_W}")
    lib = library()
    with torch.cuda.device(table.device):
        rc = lib.fbpr_block_fetch(
            table.data_ptr(), table.shape[0], W,
            bcell.data_ptr(), qx.data_ptr(), qy.data_ptr(), qz.data_ptr(),
            bcell.shape[0], K, d2.data_ptr(), cand.data_ptr(),
            _stream(table))
    _check_rc("fbpr_block_fetch", rc)


def launch_resident_fetch(table, bcell, qx, qy, qz, d2, cand, *, K: int):
    """csrc/resident_fetch.cu on validated CUDA tensors (see ops/fetch.py);
    W is one of the compact tables' widths, a multiple of 128 up to 512."""
    _check_k(K)
    W = table.shape[1] // 3
    if W % 128 or not 128 <= W <= RESIDENT_MAX_W:
        raise ValueError(f"W={W}: the resident kernel takes W in "
                         f"{tuple(range(128, RESIDENT_MAX_W + 1, 128))}")
    lib = library()
    with torch.cuda.device(table.device):
        rc = lib.fbpr_resident_fetch(
            table.data_ptr(), table.shape[0], W, bcell.data_ptr(),
            qx.data_ptr(), qy.data_ptr(), qz.data_ptr(), bcell.shape[0], K,
            d2.data_ptr(), cand.data_ptr(), _stream(table))
    _check_rc("fbpr_resident_fetch", rc)


def launch_gn_round(stat, matP, featc, feats, candc, cands, *, K: int,
                    iters: int, min_corr: int, eig_thresh: float,
                    conv_rot_deg: float, conv_trans_cm: float,
                    jacobi_sweeps: int, min_plane_spread: float,
                    lib: SimpleNamespace | None = None):
    """csrc/gn_round.cu on validated CUDA tensors (see ops/gn_round.py);
    updates stat and matP in place.  lib: another build of the same entry
    point (`load`), for comparisons of kernel versions; by default the
    shipped one."""
    _check_k(K)
    lib = lib or library()
    B, _, Pc = featc.shape
    Ps = feats.shape[2]
    with torch.cuda.device(stat.device):
        rc = lib.fbpr_gn_round(
            stat.data_ptr(), matP.data_ptr(), featc.data_ptr(),
            feats.data_ptr(), candc.data_ptr(), cands.data_ptr(),
            B, Pc, Ps, K, iters, min_corr, eig_thresh, conv_rot_deg,
            conv_trans_cm, jacobi_sweeps, min_plane_spread, _stream(stat))
    _check_rc("fbpr_gn_round", rc)


def check_cluster(cluster: int):
    """Raises unless cluster is a size csrc/rounds_gn.cu and
    csrc/exact_gn.cu launch: a power of two up to ROUNDS_MAX_CLUSTER."""
    if (isinstance(cluster, bool) or not isinstance(cluster, int)
            or not 1 <= cluster <= ROUNDS_MAX_CLUSTER
            or cluster & (cluster - 1)):
        raise ValueError(f"cluster={cluster!r}: a kernel's CTAs a lane are "
                         f"a power of two from 1 to {ROUNDS_MAX_CLUSTER}")


def rounds_gn_cluster(B: int, P: int, n_sm: int, K: int,
                      max_clusters=None) -> int:
    """CTAs a lane of csrc/rounds_gn.cu, from shapes alone (the masks stay
    on the card): the largest power of two C up to ROUNDS_MAX_CLUSTER such
    that the B * C CTAs fit one wave of n_sm SMs (one CTA an SM at K=16,
    two at K <= 8: the kernel's __launch_bounds__), each CTA keeps at
    least ROUNDS_MIN_SHARE of the lane's P = Pc + Ps points, and, given
    max_clusters(C) (the clusters of C that can be resident at once), B
    of them are.  B = 256 gets C = 1; B = 1 at the step's feature caps
    gets 16."""
    slots = n_sm * (1 if K > 8 else 2)
    C = ROUNDS_MAX_CLUSTER
    while C > 1 and (B * C > slots or P < C * ROUNDS_MIN_SHARE
                     or (max_clusters is not None and max_clusters(C) < B)):
        C //= 2
    return C


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def rounds_gn_max_clusters(index: int, K: int, cluster: int) -> int:
    """Clusters of `cluster` CTAs of the shipped rounds_gn.cu (K instance)
    that can be resident at once on CUDA device `index`, at the largest
    live list's shared memory (cudaOccupancyMaxActiveClusters)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = library().fbpr_rounds_gn_max_clusters(K, cluster,
                                                   ctypes.byref(out))
    _check_rc("fbpr_rounds_gn_max_clusters", rc)
    return out.value


def rounds_gn_cluster_on(index: int, B: int, P: int, K: int) -> int:
    """rounds_gn_cluster on CUDA device `index`: its SM count and the
    clusters of each size it can hold resident."""
    return rounds_gn_cluster(B, P, _sm_count(index), K,
                             lambda C: rounds_gn_max_clusters(index, K, C))


def launch_rounds_gn(stat, matP, featc, feats, candc, cands, cd2, sd2, *,
                     K: int, iters: int, min_corr: int, eig_thresh: float,
                     conv_rot_deg: float, conv_trans_cm: float,
                     min_plane_spread: float, cluster: int | None = None,
                     lib: SimpleNamespace | None = None):
    """csrc/rounds_gn.cu on validated CUDA tensors (see ops/rounds_gn.py);
    updates stat and matP in place.  cluster: CTAs a lane, by default
    rounds_gn_cluster's; a size the card cannot co-schedule raises.  lib:
    another build of the same entry point (`load`), for comparisons of
    builds; by default the shipped one."""
    _check_k(K)
    lib = lib or library()
    B, _, Pc = featc.shape
    Ps = feats.shape[2]
    index = stat.device.index
    if index is None:
        index = torch.cuda.current_device()
    if cluster is None:
        cluster = rounds_gn_cluster_on(index, B, Pc + Ps, K)
    check_cluster(cluster)
    if cluster > 1 and rounds_gn_max_clusters(index, K, cluster) < 1:
        raise RuntimeError(f"rounds_gn: a cluster of {cluster} CTAs cannot "
                           f"be resident on this card")
    with torch.cuda.device(stat.device):
        rc = lib.fbpr_rounds_gn(
            stat.data_ptr(), matP.data_ptr(), featc.data_ptr(),
            feats.data_ptr(), candc.data_ptr(), cands.data_ptr(),
            cd2.data_ptr(), sd2.data_ptr(), B, Pc, Ps, K, iters, min_corr,
            eig_thresh, conv_rot_deg, conv_trans_cm, min_plane_spread,
            cluster, _stream(stat))
    _check_rc("fbpr_rounds_gn", rc)


def exact_gn_cluster(B: int, P: int, n_sm: int, max_clusters=None) -> int:
    """CTAs a lane of csrc/exact_gn.cu, from shapes alone: the largest power
    of two C up to ROUNDS_MAX_CLUSTER such that the B * C CTAs fit one wave
    of n_sm SMs (one CTA an SM: the kernel's __launch_bounds__), each CTA
    keeps at least EXACT_MIN_SHARE of the lane's P = Pc + Ps feature
    slots, and, given max_clusters(C), B of them can be resident at once.
    B = 1 at the SLAM step's feature caps gets 16; B = 32, 4 where 32
    clusters of 4 can be resident."""
    C = ROUNDS_MAX_CLUSTER
    while C > 1 and (B * C > n_sm or P < C * EXACT_MIN_SHARE
                     or (max_clusters is not None and max_clusters(C) < B)):
        C //= 2
    return C


EXACT_MAX_GROUPS = 512   # csrc/exact_gn.cu kMaxGroups


def _last_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def exact_gn_mean_order(B: int, P: int, n_sm: int, sm_threads: int):
    """(S, H, factor): the order in which ATen's CUDA reduction sums
    `q.mean(-2)` of a contiguous float32 q [B, P, 3] (ops/knn.py's query
    centroid), as Reduce.cuh's setReduceConfig lays it out for MeanOps on
    a card of n_sm SMs of sm_threads threads: partial s of S sums points
    s, s + S, ...; groups of H partials fold as trees (csrc/exact_gn.cu's
    centroid()); factor is float32(3B) / float32(3BP), MeanOps' factor.
    Raises ValueError past EXACT_MAX_GROUPS groups (more than 2^21 feature
    slots a lane)."""
    outputs, most = 3 * B, 512         # float's MAX_NUM_THREADS
    d0 = _last_pow2(outputs) if outputs < most else most
    d1 = _last_pow2(P) if P < most else most
    width = min(d0, 32)
    height = min(d1, most // width)
    width = min(d0, most // height)
    S = H = 1                          # each thread sums all P points
    if P >= min(height * 16, 256):     # split across the block's rows
        S = H = height
        per_thread = -(-P // H)
        grid = -(-outputs // width)
        target = n_sm * (sm_threads // (width * height))
        if per_thread >= 256 and grid <= target:   # and across CTAs
            ctas = max(min(-(-target // grid), -(-per_thread // 16)),
                       -(-per_thread // 256))
            S = H * ctas
    if S // H > EXACT_MAX_GROUPS:
        raise ValueError(f"exact_gn: {P} feature slots a lane at B={B} "
                         f"take {S // H} centroid groups (at most "
                         f"{EXACT_MAX_GROUPS})")
    f32 = torch.tensor([outputs, outputs * P], dtype=torch.float32)
    return S, H, float(f32[0] / f32[1])


@functools.lru_cache(maxsize=None)
def exact_gn_max_clusters(index: int, cluster: int) -> int:
    """Clusters of `cluster` CTAs of the shipped exact_gn.cu that can be
    resident at once on CUDA device `index`."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = library().fbpr_exact_gn_max_clusters(cluster, ctypes.byref(out))
    _check_rc("fbpr_exact_gn_max_clusters", rc)
    return out.value


def launch_exact_gn(pose, features, local_map, stat, *, iters: int,
                    min_corr: int, eig_thresh: float, edge_min_valid: int,
                    surf_min_valid: int, conv_rot_deg: float,
                    conv_trans_cm: float, cluster: int | None = None,
                    nn=None, lib: SimpleNamespace | None = None):
    """csrc/exact_gn.cu on validated contiguous CUDA tensors (see
    ops/exact_gn.py): pose [B, 6], features (ScanFeatures [B, ...]),
    local_map (FeatureMap, [M, 3] shared or [B, M, 3] one a lane); writes
    stat [B, 16].  cluster: CTAs a lane, by default exact_gn_cluster's; a
    size the card cannot co-schedule raises.  nn: (idx int32, d2 float32),
    each [B, Pc + Ps, 5], to receive the first iteration's neighbours (a
    diagnostic), else None.  lib: another build of the entry point."""
    lib = lib or library()
    B, Pc, _ = features.corner_xyz.shape
    Ps = features.surf_xyz.shape[1]
    Mc = local_map.corner_xyz.shape[-2]
    Ms = local_map.surf_xyz.shape[-2]
    index = pose.device.index
    if index is None:
        index = torch.cuda.current_device()
    if cluster is None:
        cluster = exact_gn_cluster(
            B, Pc + Ps, _sm_count(index),
            lambda C: exact_gn_max_clusters(index, C))
    check_cluster(cluster)
    if cluster > 1 and exact_gn_max_clusters(index, cluster) < 1:
        raise RuntimeError(f"exact_gn: a cluster of {cluster} CTAs cannot "
                           f"be resident on this card")
    props = torch.cuda.get_device_properties(index)
    order = [exact_gn_mean_order(B, P, props.multi_processor_count,
                                 props.max_threads_per_multi_processor)
             for P in (Pc, Ps)]
    scratch = torch.empty(B * (Pc + Ps + Mc + Ms), dtype=torch.int32,
                          device=pose.device)
    nn_idx, nn_d2 = nn if nn is not None else (None, None)
    with torch.cuda.device(pose.device):
        rc = lib.fbpr_exact_gn(
            pose.data_ptr(), features.corner_xyz.data_ptr(),
            features.corner_mask.data_ptr(), features.surf_xyz.data_ptr(),
            features.surf_mask.data_ptr(), local_map.corner_xyz.data_ptr(),
            local_map.corner_mask.data_ptr(),
            Mc if local_map.corner_xyz.dim() == 3 else 0,
            local_map.surf_xyz.data_ptr(), local_map.surf_mask.data_ptr(),
            Ms if local_map.surf_xyz.dim() == 3 else 0, B, Pc, Ps, Mc, Ms,
            iters, min_corr, eig_thresh, conv_rot_deg, conv_trans_cm,
            edge_min_valid, surf_min_valid, scratch.data_ptr(),
            stat.data_ptr(), nn_idx.data_ptr() if nn is not None else None,
            nn_d2.data_ptr() if nn is not None else None, cluster,
            *order[0], *order[1], _stream(pose))
    _check_rc("fbpr_exact_gn", rc)


def launch_ring_pick(curv, col, picked, sp, ep, sector_ok, label, *,
                     edge_threshold: float, surf_threshold: float,
                     strict: bool):
    """csrc/ring_pick.cu on validated CUDA tensors (see ops/features.py);
    writes label.  W up to RING_PICK_MAX_W, since a block holds its whole
    window in shared memory."""
    W = curv.shape[-1]
    if W > RING_PICK_MAX_W:
        raise ValueError(f"W={W}: the ring-pick kernel takes W up to "
                         f"{RING_PICK_MAX_W}")
    lib = library()
    with torch.cuda.device(curv.device):
        rc = lib.fbpr_ring_pick(
            curv.data_ptr(), col.data_ptr(), picked.data_ptr(),
            sp.data_ptr(), ep.data_ptr(), sector_ok.data_ptr(),
            curv.numel() // max(W, 1), W, edge_threshold, surf_threshold,
            int(strict), label.data_ptr(), _stream(curv))
    _check_rc("fbpr_ring_pick", rc)


def _factor_args(g, ends):
    """The pose graph's factor arguments (`_FACTORS`) of a PoseGraphData
    with contiguous tensors; ends: the factors' endpoints, int32 [Fp + 2 Fb
    + Fg]."""
    return (ends.data_ptr(), g.prior_meas.data_ptr(),
            g.prior_sigma.data_ptr(), g.prior_mask.data_ptr(),
            g.btw_meas.data_ptr(), g.btw_sigma.data_ptr(),
            g.btw_mask.data_ptr(), g.gps_meas.data_ptr(),
            g.gps_sigma.data_ptr(), g.gps_mask.data_ptr(),
            g.prior_idx.shape[0], g.btw_i.shape[0], g.gps_idx.shape[0])


def launch_pose_graph_lm(g, ls, iterations, out_poses, out_cost, accepts,
                         lib: SimpleNamespace | None = None):
    """csrc/pose_graph_lm.cu route A on a validated graph (see
    graph/pose_graph.py) and its live set: writes out_poses [K, 6],
    out_cost [] and accepts [iterations] (int32).  lib: another build of
    the same entry point (`load`), for comparisons of kernel versions; by
    default the shipped one."""
    if not 0 < ls.n <= POSE_GRAPH_LM_MAX_LIVE:
        raise ValueError(f"{ls.n} live poses: route A takes 1 to "
                         f"{POSE_GRAPH_LM_MAX_LIVE}")
    lib = lib or library()
    with torch.cuda.device(g.poses.device):
        rc = lib.fbpr_pose_graph_lm(
            g.poses.data_ptr(), g.pose_mask.data_ptr(), ls.idx.data_ptr(),
            ls.rowmap.data_ptr(), *_factor_args(g, ls.rows),
            g.poses.shape[0], ls.n, iterations, out_poses.data_ptr(),
            out_cost.data_ptr(), accepts.data_ptr(), _stream(g.poses))
    _check_rc("fbpr_pose_graph_lm", rc)


def launch_pose_graph_assemble(g, ls, poses, H, grad, state, it):
    """Route B's assemble kernel: H [D, D] and grad [D] at the live poses
    [n, 6]; at it == 0 also the cost into state[0]."""
    lib = library()
    with torch.cuda.device(poses.device):
        rc = lib.fbpr_pose_graph_assemble(
            poses.data_ptr(), *_factor_args(g, ls.rows), ls.n,
            H.data_ptr(), grad.data_ptr(), state.data_ptr(), it,
            _stream(poses))
    _check_rc("fbpr_pose_graph_assemble", rc)


def launch_pose_graph_update(g, ls, poses, dx, info, state, accepts, it):
    """Route B's update kernel: the new cost at poses + dx, accept and lam,
    applied to poses [n, 6], state (cost, lam) and accepts[it]."""
    lib = library()
    with torch.cuda.device(poses.device):
        rc = lib.fbpr_pose_graph_update(
            poses.data_ptr(), dx.data_ptr(), info.data_ptr(),
            *_factor_args(g, ls.rows), ls.n, state.data_ptr(),
            accepts.data_ptr(), it, _stream(poses))
    _check_rc("fbpr_pose_graph_update", rc)


def launch_pose_graph_blocks(g, ends, out):
    """graph_factor_blocks' kernel at g.poses; ends: the factors' pose
    indices (int32 [Fp + 2 Fb + Fg]); out: ((r_p, J_p), (r_b, J_bi, J_bj),
    (r_g, J_g)), written."""
    (rp, Jp), (rb, Jbi, Jbj), (rg, Jg) = out
    lib = library()
    with torch.cuda.device(g.poses.device):
        rc = lib.fbpr_pose_graph_blocks(
            g.poses.data_ptr(), g.poses.shape[0], *_factor_args(g, ends),
            rp.data_ptr(), Jp.data_ptr(), rb.data_ptr(), Jbi.data_ptr(),
            Jbj.data_ptr(), rg.data_ptr(), Jg.data_ptr(), _stream(g.poses))
    _check_rc("fbpr_pose_graph_blocks", rc)


def imu_chain_floats(K: int) -> int:
    """Floats of csrc/imu_chain_lm.cu's chain_floats(K): a solve's states,
    buffers, whitening factors, factor blocks and H's blocks, its global
    scratch (the kernel refuses a smaller one)."""
    return 1182 * K + 240


def _chain_args(d):
    """The IMU chain's arguments (`_CHAIN`) of an ImuChainData with
    contiguous tensors."""
    p = d.preint
    return (d.states.data_ptr(), d.state_mask.data_ptr(), p.dR.data_ptr(),
            p.dv.data_ptr(), p.dp.data_ptr(), p.dt.data_ptr(),
            p.dR_dbg.data_ptr(), p.dv_dba.data_ptr(), p.dv_dbg.data_ptr(),
            p.dp_dba.data_ptr(), p.dp_dbg.data_ptr(), p.cov.data_ptr(),
            p.bias_acc.data_ptr(), p.bias_gyr.data_ptr(),
            d.preint_mask.data_ptr(), d.pose_meas.data_ptr(),
            d.pose_sigma.data_ptr(), d.pose_meas_mask.data_ptr(),
            d.prior_state.data_ptr(), d.prior_sigma.data_ptr(),
            d.bias_sigma.data_ptr(), d.gravity.data_ptr(),
            d.states.shape[0])


def launch_imu_chain_lm(d, iterations, out_states, out_cost, accepts,
                        scratch, lib: SimpleNamespace | None = None):
    """csrc/imu_chain_lm.cu on a validated chain (see graph/imu_graph.py):
    writes out_states [K, 15], out_cost [] and accepts [iterations]
    (int32).  scratch: imu_chain_floats(K) float32 of global memory, the
    solve's working set.  lib: another build of the same entry point
    (`load`), for comparisons of kernel versions; by default the shipped
    one."""
    K = d.states.shape[0]
    if scratch is None or scratch.numel() < imu_chain_floats(K):
        raise ValueError(f"K={K}: the chain LM needs {imu_chain_floats(K)} "
                         f"floats of scratch")
    lib = lib or library()
    with torch.cuda.device(d.states.device):
        rc = lib.fbpr_imu_chain_lm(
            *_chain_args(d), iterations, scratch.data_ptr(), scratch.numel(),
            out_states.data_ptr(), out_cost.data_ptr(), accepts.data_ptr(),
            _stream(d.states))
    _check_rc("fbpr_imu_chain_lm", rc)


def launch_imu_chain_blocks(d, states, out):
    """chain_factor_blocks' kernel at states [K, 15]; out: ((r_imu, Ji,
    Jj), (r_b, Jbi, Jbj), (r_pp, Jpp), (r_0, J_0)), written."""
    lib = library()
    with torch.cuda.device(states.device):
        rc = lib.fbpr_imu_chain_blocks(
            *_chain_args(d), states.data_ptr(),
            *(t.data_ptr() for grp in out for t in grp), _stream(states))
    _check_rc("fbpr_imu_chain_blocks", rc)


def launch_preintegrate(acc, gyr, dt, mask, bias_acc, bias_gyr, out, *,
                        acc_var: float, gyr_var: float, int_var: float,
                        lib: SimpleNamespace | None = None):
    """csrc/preintegration.cu's fbpr_preintegrate on validated CUDA tensors
    (see imu/preintegration.py); mask: bool [N] or None (every sample
    live); out: the twelve PreintState leaves, written.  lib: another build
    of the source (chip_smoke.py's --imu-ab), else the shipped one."""
    lib = lib or library()
    with torch.cuda.device(acc.device):
        rc = lib.fbpr_preintegrate(
            acc.data_ptr(), gyr.data_ptr(), dt.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            bias_acc.data_ptr(), bias_gyr.data_ptr(), acc_var, gyr_var,
            int_var, acc.shape[0], *(t.data_ptr() for t in out),
            _stream(acc))
    _check_rc("fbpr_preintegrate", rc)


def launch_propagate_states(nav, bias_acc, bias_gyr, acc, gyr, dt, mask,
                            out, *, gravity: float,
                            lib: SimpleNamespace | None = None):
    """csrc/preintegration.cu's fbpr_propagate_states on validated CUDA
    tensors (see imu/preintegration.py); nav: (R [3, 3], p [3], v [3]);
    out: (R [N, 3, 3], p [N, 3], v [N, 3]), written.  lib: another build
    of the source, else the shipped one."""
    lib = lib or library()
    with torch.cuda.device(acc.device):
        rc = lib.fbpr_propagate_states(
            *(t.data_ptr() for t in nav), bias_acc.data_ptr(),
            bias_gyr.data_ptr(), acc.data_ptr(), gyr.data_ptr(),
            dt.data_ptr(), mask.data_ptr() if mask is not None else None,
            -gravity, acc.shape[0], *(t.data_ptr() for t in out),
            _stream(acc))
    _check_rc("fbpr_propagate_states", rc)


def launch_knn(query, center, ref, mask, d2, idx, *, one_chunk: bool,
               lib: SimpleNamespace | None = None):
    """csrc/knn_stream.cu on validated contiguous CUDA tensors (see
    ops/knn.py): query [S, Q, 3], center [S, 3], ref [M, 3] (shared) or
    [S, M, 3], mask [M] or [S, M] (bool); writes d2 and idx [S, Q, K].
    lib: another build of the same entry point (`load`); by default the
    shipped one."""
    S, Q, _ = query.shape
    M = ref.shape[-2]
    K = d2.shape[-1]
    if not 1 <= K <= KNN_MAX_K:
        raise ValueError(f"k={K}: the k-NN kernel takes k in 1..{KNN_MAX_K}")
    lib = lib or library()
    with torch.cuda.device(query.device):
        rc = lib.fbpr_knn(
            query.data_ptr(), center.data_ptr(), ref.data_ptr(),
            mask.data_ptr(), 3 * M if ref.dim() == 3 else 0,
            M if mask.dim() == 2 else 0, S, Q, M, int(one_chunk), K,
            d2.data_ptr(), idx.data_ptr(), _stream(query))
    _check_rc("fbpr_knn", rc)


def icp_plan(N: int, M: int, device,
             lib: SimpleNamespace | None = None) -> tuple:
    """(grid, lanes a row, cell cap, scratch floats) of csrc/icp.cu at N
    source and M target points on device (a build's own plan: lib's);
    raises where it cannot launch cooperatively."""
    lib = lib or library()
    out = (ctypes.c_int64 * 4)()
    with torch.cuda.device(device):
        rc = lib.fbpr_icp_plan(N, M, ctypes.addressof(out))
    _check_rc("fbpr_icp_plan", rc)
    return tuple(out)


def launch_icp(src, src_mask, dst, dst_mask, out, *, chunk: int,
               max_d2: float, max_iterations: int, eps: float,
               lib: SimpleNamespace | None = None):
    """csrc/icp.cu, one cooperative launch, on validated contiguous CUDA
    tensors (see ops/icp.py): src [N, 3], src_mask [N], dst [M, 3],
    dst_mask [M] (bool); out: (T [4, 4], fitness [], converged [] bool,
    iterations [] int32, delta []), written."""
    N, M = src.shape[0], dst.shape[0]
    lib = lib or library()
    scratch = torch.empty(icp_plan(N, M, src.device, lib)[3],
                          dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        rc = lib.fbpr_icp(
            src.data_ptr(), src_mask.data_ptr(), dst.data_ptr(),
            dst_mask.data_ptr(), N, M, chunk, max_d2, max_iterations, eps,
            scratch.data_ptr(), scratch.numel(),
            *(t.data_ptr() for t in out), _stream(src))
    _check_rc("fbpr_icp", rc)
