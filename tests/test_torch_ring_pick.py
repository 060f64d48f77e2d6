"""The ring-pick kernel's contract on the CPU (`ops/features.py::ring_pick`).

`csrc/ring_pick.cu` runs only on a card, so its contract and its algorithm
are transcribed here in NumPy.  The contract (`transcribe`,
tests/pick_windows.py's `serial_pick`), the reference's serial greedy: per
sector the slots sp..ep packed as 64-bit words (order-preserving key bits,
then the slot; the key curv, +inf at ep, -0.0 as +0.0) and sorted once; the
corner pass walks the list from its end and stops at the 21st qualifying
slot without marking it, the surf pass (strict only) walks it from its
start; a pick marks itself and up to 5 neighbours each way, a direction
stopping at the first column gap > 10 and at the window's ends (strict) or
the sector's (fast).  The kernel's walk (`transcribe_warp`): a pass's list
holds the slots it can take, walked 32 candidates a step; the step's
unmarked candidates in lane order, the first the next pick, every later one
that the pick would mark (within 5 slots, equal gap-break prefix counts
bcum, inside the clip) dropped, the cap of 20 corners counted across steps;
the step's picks then mark.  Bitwise throughout:

  * both transcriptions (the `-warp` cases the kernel's walk) equal the
    plain version (`_pick` on CPU tensors, the MIS rounds) in both modes on
    the reference-stream, stride, gap and edge windows of
    tests/pick_windows.py (the stride windows also with every slot a corner
    candidate, so that flat runs of equal keys tie in the corner pass; the
    edge windows at the walk's step edges: the 21st corner first or last in
    a step, suppression into the next step, equal keys, lists past 512), on
    tests/test_torch_strict.py's multi-ring scans (seeds as there) and on an
    HDL-64 scan of tests/data/kitti_mini (64 rings, W = 1816);
  * the kernel's range of a pick's marks, read from the break bits around
    it, is the bcum rule's set at every slot;
  * on CPU tensors `ring_pick` runs the plain version: no kernel launch
    counted, the plain rounds' host syncs counted, labels equal to JAX
    `_ring_pick`'s in both modes;
  * the wrapper rejects windows of the wrong dtype, shape or layout.

The same windows go through the kernel on a card in
tests/test_torch_kernels_cuda.py.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pick_windows
from feature_base_pointcloud_registration_tpu.ops import features as jfeat
from feature_base_pointcloud_registration_tpu_torch.config import Params
from feature_base_pointcloud_registration_tpu_torch.convert import to_torch
from feature_base_pointcloud_registration_tpu_torch.ops import (
    features as tfeat, projection as tproj)
from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
    RawScan)
from test_torch_batch import one_torch_thread  # noqa: F401
from test_torch_strict import _multi_ring_scan

PARAMS = Params()
HDL64 = dataclasses.replace(PARAMS, n_scan=64, horizon_scan=1800)
CORNER_CAP = pick_windows.CORNER_CAP
SUPPRESS = pick_windows.SUPPRESS


_sort_words = pick_windows.sort_words
transcribe = pick_windows.serial_pick


def _marked(p, lo, hi, bcum):
    """The slots a pick at p marks: |q - p| <= 5, no column gap > 10
    between them (equal gap-break prefix counts bcum), inside [lo, hi];
    a run of slots, as (first, last)."""
    q = [q for q in range(p - SUPPRESS, p + SUPPRESS + 1)
         if lo <= q <= hi and bcum[q] == bcum[p]]
    return q[0], q[-1]


def _warp_walk(order, cap, lo, hi, marks, bcum, pick):
    """One pass of the kernel's warp walk over the sorted candidates
    `order`: 32 a step, lane l the step's l-th; the live lanes (unmarked at
    the step's start) in lane order, the first the next pick, every later
    lane inside its marked range dropped, until none is live or the cap
    (counted across steps) is reached; then the step's picks mark their
    ranges."""
    taken = 0
    for t0 in range(0, len(order), 32):
        if taken >= cap:
            break
        lanes = order[t0:t0 + 32]
        live = [not marks[s] for s in lanes]
        ranges = [_marked(s, lo, hi, bcum) if ok else None
                  for s, ok in zip(lanes, live)]
        picks = []
        while any(live):
            src = live.index(True)
            a, b = ranges[src]
            picks.append(src)
            taken += 1
            if taken == cap:
                break
            live = [ok and not a <= s <= b for s, ok in zip(lanes, live)]
        for src in picks:
            a, b = ranges[src]
            marks[a:b + 1] = True
            pick[lanes[src]] = True


def transcribe_warp(window, edge_threshold, surf_threshold, strict):
    """csrc/ring_pick.cu's block as redesigned, in NumPy, on one window:
    label [W] int8.  Per sector a pass's list holds the slots it can take
    (unmarked at the start, past its threshold) in sort-word order, walked
    by `_warp_walk`: corners from the end (cap 20), surfs from the start;
    the marks clipped to the window (strict) or the sector (fast)."""
    curv = np.asarray(window["curv"], np.float32)
    col = np.asarray(window["col"]).astype(np.int64)
    W = curv.shape[0]
    brk = np.zeros(W, bool)
    brk[1:] = np.abs(col[1:] - col[:-1]) > 10
    bcum = np.cumsum(brk)
    marks = np.asarray(window["picked"], bool).copy()
    start = marks.copy()
    corner, surf = np.zeros(W, bool), np.zeros(W, bool)
    edge, surf_t = np.float32(edge_threshold), np.float32(surf_threshold)
    for j in range(6):
        e = int(window["ep"][j])
        lo, hi = max(int(window["sp"][j]), 0), min(e, W - 1)
        if not window["sector_ok"][j] or lo > hi:
            continue
        slots = np.arange(lo, hi + 1)
        slots = slots[~start[slots]]
        key = np.where(slots == e, np.float32(np.inf), curv[slots])
        order = slots[np.argsort(_sort_words(key, slots), kind="stable")]
        c_lo, c_hi = (0, W - 1) if strict else (lo, hi)
        _warp_walk(order[curv[order] > edge][::-1], CORNER_CAP, c_lo, c_hi,
                   marks, bcum, corner)
        if strict:
            _warp_walk(order[curv[order] < surf_t], len(order) + 1, 0, W - 1,
                       marks, bcum, surf)
    return np.where(corner, 1, np.where(surf, -1, 0)).astype(np.int8)


def _one_ring(window):
    """A window dict of numpy arrays as [1, 1, ...] CPU tensors."""
    return {k: torch.from_numpy(np.asarray(v))[None, None]
            for k, v in window.items()}


def _cloud_windows(params, raw):
    """The port's ring windows of one raw scan (a batch of 1) on the CPU."""
    cloud = tproj.project_scan(params, RawScan(*(a[None] for a in raw)))
    return tfeat._ring_windows(cloud, params.n_scan, params.horizon_scan)


def _windows(name):
    """(batched windows, thresholds (edge, surf)) of one named case."""
    kind, _, n = name.partition("-")
    if kind == "stream":
        return _one_ring(pick_windows.stream_windows()[int(n)]), (1.0, 0.1)
    if kind == "stride":
        return _one_ring(pick_windows.stride_window(int(n))), (0.05, 0.1)
    if kind == "ties":      # every slot a corner candidate: flat runs tie
        return _one_ring(pick_windows.stride_window(int(n))), (-1.0, 0.1)
    if kind == "gap":
        return _one_ring(pick_windows.gap_window(int(n))), (1.0, 0.1)
    if kind == "edge":
        return _one_ring(pick_windows.edge_window(int(n))), (1.0, 0.1)
    th = (PARAMS.edge_threshold, PARAMS.surf_threshold)
    if kind == "multi_ring":
        raw = to_torch(jax.tree.map(np.asarray, _multi_ring_scan(int(n))),
                       device="cpu")
        return _cloud_windows(PARAMS, raw), th
    s = pick_windows.hdl64_scan(int(n))
    raw = RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             device="cpu")._replace(
        valid=torch.from_numpy(s["valid"]))
    return _cloud_windows(HDL64, raw), th


CASES = ([f"stream-{t}" for t in range(pick_windows.N_STREAM)]
         + [f"stride-{t}" for t in range(pick_windows.N_STRIDE)]
         + [f"ties-{t}" for t in range(pick_windows.N_STRIDE)]
         + [f"gap-{t}" for t in range(pick_windows.N_GAP)]
         + [f"edge-{t}" for t in range(pick_windows.N_EDGE)]
         + [f"multi_ring-{s}" for s in range(6)] + ["hdl64-0"])
WARP = "-warp"   # a case's suffix: the warp walk's transcription


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "fast"])
@pytest.mark.parametrize("case", CASES + [c + WARP for c in CASES])
def test_transcription_equals_plain_pick(one_torch_thread, case,  # noqa: F811
                                         strict):
    warp = case.endswith(WARP)
    case = case.removesuffix(WARP)
    transcription = transcribe_warp if warp else transcribe
    win, (edge, surf) = _windows(case)
    label, _ = tfeat._pick(win, edge, surf, strict)
    label = label.numpy().reshape(-1, label.shape[-1])
    n_rings = label.shape[0]
    assert n_rings == {"multi_ring": 16, "hdl64": 64}.get(
        case.split("-")[0], 1)
    if n_rings == 64:
        assert label.shape[1] == 1816
    rings = {k: v.numpy().reshape(n_rings, *v.shape[2:])
             for k, v in win.items() if k in ("curv", "col", "picked", "sp",
                                              "ep", "sector_ok")}
    want = np.stack([transcription({k: v[r] for k, v in rings.items()},
                                   edge, surf, strict)
                     for r in range(n_rings)])
    np.testing.assert_array_equal(label, want)
    assert (label == 1).any()
    if not strict:
        assert not (label == -1).any()
    elif not case.startswith("ties"):   # there corner marks cover every slot
        assert (label == -1).any()


def _range_from_break_bits(p, lo, hi, brk):
    """csrc/ring_pick.cu's marked_range: the run around p inside [p-5,
    p+5] and [lo, hi], cut at the last break among slots p-4..p and before
    the first among p+1..p+5."""
    first, last = max(lo, p - SUPPRESS), min(hi, p + SUPPRESS)
    back = [q for q in range(p - SUPPRESS + 1, p + 1) if q >= 0 and brk[q]]
    fwd = [q for q in range(p + 1, p + SUPPRESS + 1) if q < len(brk)
           and brk[q]]
    if back:
        first = max(first, back[-1])
    if fwd:
        last = min(last, fwd[0] - 1)
    return first, last


@pytest.mark.parametrize("case", ["gap-0", "gap-1", "edge-2", "stream-0"])
def test_break_bit_range_is_the_bcum_rule(case):
    """The kernel's range of a pick's marks, read from the break bits
    around it, is the set of the bcum rule (_marked) at every slot, with
    the window's and each sector's clip."""
    win, _ = _windows(case)
    col = win["col"][0, 0].numpy().astype(np.int64)
    W = col.shape[0]
    brk = np.zeros(W, bool)
    brk[1:] = np.abs(col[1:] - col[:-1]) > 10
    bcum = np.cumsum(brk)
    clips = [(0, W - 1)] + [
        (max(int(a), 0), min(int(b), W - 1)) for a, b, ok in zip(
            win["sp"][0, 0], win["ep"][0, 0], win["sector_ok"][0, 0]) if ok]
    for lo, hi in clips:
        for p in range(lo, hi + 1):
            assert (_range_from_break_bits(p, lo, hi, brk)
                    == _marked(p, lo, hi, bcum)), (p, lo, hi)


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "fast"])
def test_ring_pick_on_cpu_runs_the_plain_version(one_torch_thread,  # noqa: F811
                                                 strict):
    jax_pick = jax.jit(functools.partial(
        jfeat._ring_pick, sector_cap=304, edge_threshold=1.0,
        surf_threshold=0.1, strict=strict))
    tfeat.ring_pick.launches = 0
    tfeat.extract_features.host_syncs = 0
    for window in pick_windows.stream_windows():
        label = tfeat.ring_pick(_one_ring(window), 1.0, 0.1, strict)
        want, _ = jax_pick({k: jnp.asarray(v) for k, v in window.items()})
        np.testing.assert_array_equal(label[0, 0].numpy(), np.asarray(want))
    assert tfeat.ring_pick.launches == 0
    assert tfeat.extract_features.host_syncs > 0


def _bad(win, name):
    """A copy of `win` broken in one way."""
    win = dict(win)
    if name == "curv_f64":
        win["curv"] = win["curv"].double()
    elif name == "sp_i64":
        win["sp"] = win["sp"].long()
    elif name == "picked_u8":
        win["picked"] = win["picked"].to(torch.uint8)
    elif name == "col_shape":
        win["col"] = win["col"][..., :-1]
    elif name == "ep_shape":
        win["ep"] = win["ep"][..., :5]
    elif name == "curv_strided":
        win["curv"] = torch.stack([win["curv"]] * 2, -1)[..., 0]
    return win


@pytest.mark.parametrize("name,error", [
    ("curv_f64", TypeError), ("sp_i64", TypeError), ("picked_u8", TypeError),
    ("col_shape", ValueError), ("ep_shape", ValueError),
    ("curv_strided", ValueError)])
def test_ring_pick_rejects_bad_windows(name, error):
    win = _one_ring(pick_windows.stream_windows()[0])
    with pytest.raises(error):
        tfeat.ring_pick(_bad(win, name), 1.0, 0.1, True)
