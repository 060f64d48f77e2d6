"""Ring windows for the picking tests, made with NumPy from seeds (no JAX, so
the GPU tests and chip_smoke.py use them too).

  * `stream_windows()`: tests/test_features.py::
    test_strict_pick_equals_reference_stream's ring data (random curvature
    with exact ties and flat runs, pre-suppressed points, uneven sectors);
  * `stride_window(trial)`: tests/test_features.py::
    test_mis_stride_fastforward_equivalence's adversarial key patterns (flat
    runs, ramps, random ties);
  * `gap_window(trial)`: sectors whose corner pass reaches the first-20
    cap (column gaps > 10 between many neighbours stop the suppression),
    ties above the edge threshold, flat runs of -0.0 and +0.0 mixed.

Each is a dict of one window's curv f32 [W], col i32 [W], picked bool [W],
sp, ep i32 [6] and sector_ok bool [6], as `ops/features.py::_ring_windows`
gives them per ring.  `hdl64_scan(seed)` is a 64-ring scan of the
synthetic world, for the ring windows of an HDL-64 (W = 1816).
"""

import numpy as np

from feature_base_pointcloud_registration_tpu_torch.io import kitti
from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
    SyntheticWorld, simulate_scan)

N_STREAM = 8
N_STRIDE = 6
N_GAP = 4


def _sectors(start, end):
    """The reference's sector split of slots start..end, as window slots."""
    sp = np.array([(start * (6 - j) + end * j) // 6 for j in range(6)],
                  np.int32)
    ep = np.array([(start * (5 - j) + end * (j + 1)) // 6 - 1
                   for j in range(6)], np.int32)
    return sp, ep


def _stream_window(trial, rng):
    W = 512
    curv = (rng.uniform(0, 1, W) ** 4 * 30).astype(np.float32)
    curv[rng.uniform(0, 1, W) < 0.3] = 0.0
    col = np.sort(rng.randint(0, 1800, W)).astype(np.int32)
    picked0 = rng.uniform(0, 1, W) < 0.1
    sp, ep = _sectors(5 + trial, W - 8 - trial * 29)
    return dict(curv=curv, col=col, picked=picked0, sp=sp, ep=ep,
                sector_ok=sp < ep)


def stream_windows():
    """The N_STREAM reference-stream windows (one rng, advanced in order)."""
    rng = np.random.RandomState(23)
    return [_stream_window(t, rng) for t in range(N_STREAM)]


def stride_window(trial):
    """Window `trial` of the stride fast-forward's adversarial patterns."""
    W = 384
    rng = np.random.RandomState(77 + trial)
    kind = trial % 3
    if kind == 0:
        curv = np.zeros(W, np.float32)
        bump = rng.uniform(0, 1, W) < 0.05
        curv[bump] = rng.uniform(0, 0.09, bump.sum())
    elif kind == 1:
        curv = (np.abs(np.sin(np.linspace(0, 6, W))) * 0.09).astype(
            np.float32)
        curv[rng.uniform(0, 1, W) < 0.2] = 0.0
    else:
        curv = (rng.uniform(0, 1, W) ** 3 * 0.3).astype(np.float32)
        curv[rng.uniform(0, 1, W) < 0.4] = 0.0
    return dict(curv=curv,
                col=np.sort(rng.randint(0, 1800, W)).astype(np.int32),
                picked=rng.uniform(0, 1, W) < 0.05 * (trial % 4),
                sp=np.array([0, 64, 128, 192, 256, 320], np.int32),
                ep=np.array([63, 127, 191, 255, 319, W - 1], np.int32),
                sector_ok=np.ones(6, bool))


def gap_window(trial):
    """Window `trial` of the cap and signed-zero patterns: a column gap > 10
    before 60% (even trials) or 10% (odd) of the slots."""
    W = 512
    rng = np.random.RandomState(131 + trial)
    curv = (rng.uniform(0, 1, W) ** 2 * 4).astype(np.float32)
    curv[rng.uniform(0, 1, W) < 0.2] = 2.0
    zero = rng.uniform(0, 1, W) < 0.25
    curv[zero] = np.where(rng.uniform(0, 1, zero.sum()) < 0.5, -0.0, 0.0)
    gap = rng.uniform(0, 1, W) < (0.6 if trial % 2 == 0 else 0.1)
    col = np.cumsum(np.where(gap, rng.randint(11, 30, W),
                             rng.randint(0, 3, W))).astype(np.int32)
    sp, ep = _sectors(5 + 3 * trial, W - 8 - 17 * trial)
    return dict(curv=curv, col=col, picked=rng.uniform(0, 1, W) < 0.05,
                sp=sp, ep=ep, sector_ok=sp < ep)


def hdl64_scan(seed):
    """A noisy 64-ring scan of the synthetic world at a pose from `seed`
    (ring elevations spaced as io/kitti.py derives rings), as
    simulate_scan's dict."""
    rng = np.random.RandomState(seed)
    pose = [0.0, 0.0, rng.uniform(-1, 1), rng.uniform(-6, 6),
            rng.uniform(-6, 6), 0.0]
    return simulate_scan(
        SyntheticWorld(), pose, n_scan=kitti.HDL64_RINGS, seed=seed,
        noise=0.02, elev_deg=np.linspace(kitti.HDL64_ELEV_MIN,
                                         kitti.HDL64_ELEV_MAX,
                                         kitti.HDL64_RINGS))
