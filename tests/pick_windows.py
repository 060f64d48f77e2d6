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
  * `edge_window(trial)` (W = EDGE_W, thresholds 1.0 / 0.1): the edges of
    a walk 32 candidates a step: (0) exactly 20 corners a sector, 21 with
    the 21st first or last in its 32-candidate step, a corner pick and a
    surf pick whose suppression reaches the next step's first candidate,
    a sector of equal corner keys; (1) sectors of 600 and 2000 slots
    (lists longer than 512); (2) sectors of equal keys: corners, zeros,
    -0.0 and +0.0 mixed, corners with a column gap before every slot; (3)
    and (4) all six sectors full of corner candidates (95% of the slots),
    with a column gap before half the slots or none.

Each is a dict of one window's curv f32 [W], col i32 [W], picked bool [W],
sp, ep i32 [6] and sector_ok bool [6], as `ops/features.py::_ring_windows`
gives them per ring.  `hdl64_scan(seed)` is a 64-ring scan of the
synthetic world, for the ring windows of an HDL-64 (W = 1816).
`serial_pick(window, ...)` is the reference's serial greedy on one window
in NumPy, the ring-pick kernel's contract (`sort_words` its sort order).
"""

import numpy as np

from feature_base_pointcloud_registration_tpu_torch.io import kitti
from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
    SyntheticWorld, simulate_scan)

CORNER_CAP = 20   # corner picks a sector (ref :221)
SUPPRESS = 5      # neighbours a pick marks each way (ref :227-240)
N_STREAM = 8
N_STRIDE = 6
N_GAP = 4
N_EDGE = 5
EDGE_W = 2640


def sort_words(key, slots):
    """The kernel's sort words: order-preserving bits of the f32 key (both
    zeros as +0.0) in the high half, the slot in the low half."""
    u = key.astype(np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return (u.astype(np.uint64) << np.uint64(32)) | slots.astype(np.uint64)


def _suppress(marks, brk, i, lo, hi):
    marks[i] = True
    for l in range(1, SUPPRESS + 1):
        p = i + l
        if p > hi or brk[p]:
            break
        marks[p] = True
    for l in range(1, SUPPRESS + 1):
        p = i - l
        if p < lo or brk[p + 1]:
            break
        marks[p] = True


def serial_pick(window, edge_threshold, surf_threshold, strict):
    """The reference's serial greedy (the ring-pick kernel's contract), in
    NumPy, on one window: label [W] int8.  Per sector in order the slots
    sorted by sort word; the corner pass from the end, the 21st qualifying
    slot ending it unmarked; the surf pass (strict) from the start; marks
    carried across passes and sectors, clipped to the window (strict) or
    the sector (fast)."""
    curv = np.asarray(window["curv"], np.float32)
    col = np.asarray(window["col"]).astype(np.int64)
    W = curv.shape[0]
    brk = np.zeros(W, bool)
    brk[1:] = np.abs(col[1:] - col[:-1]) > 10
    marks = np.asarray(window["picked"], bool).copy()
    label = np.zeros(W, np.int8)
    edge, surf = np.float32(edge_threshold), np.float32(surf_threshold)
    for j in range(6):
        e = int(window["ep"][j])
        lo, hi = max(int(window["sp"][j]), 0), min(e, W - 1)
        if not window["sector_ok"][j] or lo > hi:
            continue
        slots = np.arange(lo, hi + 1)
        key = np.where(slots == e, np.float32(np.inf), curv[slots])
        words = np.sort(sort_words(key, slots))
        order = (words & np.uint64(0xFFFFFFFF)).astype(np.int64)
        s_lo, s_hi = (0, W - 1) if strict else (lo, hi)
        taken = 0
        for s in order[::-1]:
            if not marks[s] and curv[s] > edge:
                taken += 1
                if taken > CORNER_CAP:
                    break
                label[s] = 1
                _suppress(marks, brk, s, s_lo, s_hi)
        if strict:
            for s in order:
                if not marks[s] and curv[s] < surf:
                    label[s] = -1
                    _suppress(marks, brk, s, 0, W - 1)
    return label


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


def _plan_corners(curv, slots, victims):
    """Corner keys on `slots` (a sector's run, no column gaps) for a walk
    from the list's end: a pick every 13 slots, in descending key order,
    pick i followed in the list by its next victims[i] slots, which it
    suppresses."""
    rank = 0
    for i, v in enumerate(victims):
        for s in range(slots[13 * i], slots[13 * i] + v + 1):
            curv[s] = np.float32(100.0 - 0.25 * rank)
            rank += 1


def edge_window(trial):
    """Window `trial` of the walk's edge cases (see the module docstring),
    at edge / surf thresholds 1.0 / 0.1."""
    W = EDGE_W
    rng = np.random.RandomState(211 + trial)
    curv = np.full(W, 0.5, np.float32)           # neither corner nor surf
    col = np.arange(W, dtype=np.int32)           # no column gaps
    picked = np.zeros(W, bool)
    if trial == 0:
        sizes = [437] * 5 + [W - 16 - 5 * 437]
    elif trial == 1:
        sizes = [600, 2000, 6, 6, 6, W - 16 - 2618]
    else:
        sizes = [437] * 5 + [W - 16 - 5 * 437]
    sp = np.cumsum([8] + sizes[:-1]).astype(np.int32)
    ep = (sp + np.array(sizes) - 1).astype(np.int32)
    sec = [np.arange(a, b + 1) for a, b in zip(sp, ep)]
    if trial == 0:
        _plan_corners(curv, sec[0], [1] * 12 + [0] * 9)   # 21st: entry 32
        _plan_corners(curv, sec[1], [1] * 12 + [0] * 8)   # exactly 20
        _plan_corners(curv, sec[2], [1] * 11 + [0] * 10)  # 21st: entry 31
        # the 12th pick is entry 31 (the first step's last lane), its
        # victim entry 32
        _plan_corners(curv, sec[3], [2] * 10 + [0, 1])
        # surf picks: 31 slots 13 apart ascending, then a pick at the
        # first step's last lane whose neighbour is the next step's first
        surf = list(sec[4][:13 * 31:13]) + [sec[4][13 * 31]]
        surf.append(surf[-1] + 1)
        curv[surf] = np.float32(0.001) * np.arange(1, 34, dtype=np.float32)
        curv[sec[4][-25:-10]] = np.float32(3.0)    # some corners
        curv[sec[5][:-1]] = np.float32(7.0)        # equal corner keys
    elif trial == 1:
        curv = (rng.uniform(0, 1, W) ** 4 * 30).astype(np.float32)
        curv[rng.uniform(0, 1, W) < 0.3] = 0.0
        col = np.cumsum(np.where(rng.uniform(0, 1, W) < 0.2,
                                 rng.randint(11, 20, W), 1)).astype(np.int32)
        picked = rng.uniform(0, 1, W) < 0.05
    elif trial == 2:
        curv[sec[0]] = np.float32(2.0)
        curv[sec[1]] = np.float32(0.0)
        curv[sec[2]] = np.where(rng.uniform(0, 1, sizes[2]) < 0.5,
                                np.float32(-0.0), np.float32(0.0))
        curv[sec[3]] = np.float32(2.0)
        inc = np.ones(W, np.int32)
        inc[sec[3]] = 12                 # a column gap before every slot
        col = np.cumsum(inc).astype(np.int32)
        curv[sec[4]] = (rng.uniform(0, 1, sizes[4]) * 3).astype(np.float32)
        curv[sec[5]] = np.where(rng.uniform(0, 1, sizes[5]) < 0.5,
                                np.float32(4.0), np.float32(0.05))
    else:
        curv = rng.uniform(1.5, 30, W).astype(np.float32)
        curv[rng.uniform(0, 1, W) < 0.05] = np.float32(0.0)
        if trial == 3:
            gap = rng.uniform(0, 1, W) < 0.5
            col = np.cumsum(np.where(gap, 12, 1)).astype(np.int32)
        else:
            curv[rng.uniform(0, 1, W) < 0.3] = np.float32(9.0)
    return dict(curv=curv, col=col, picked=picked, sp=sp, ep=ep,
                sector_ok=sp < ep)
