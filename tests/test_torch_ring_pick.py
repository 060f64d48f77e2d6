"""The ring-pick kernel's contract on the CPU (`ops/features.py::ring_pick`).

`csrc/ring_pick.cu` runs only on a card, so its algorithm is transcribed here
in NumPy, step for step: per sector the slots sp..ep packed as 64-bit words
(order-preserving key bits, then the slot; the key curv, +inf at ep, -0.0 as
+0.0) and sorted once; the corner pass walks the list from its end and stops
at the 21st qualifying slot without marking it, the surf pass (strict only)
walks it from its start; a pick marks itself and up to 5 neighbours each
way, a direction stopping at the first column gap > 10 and at the window's
ends (strict) or the sector's (fast).  Bitwise throughout:

  * the transcription equals the plain version (`_pick` on CPU tensors, the
    MIS rounds) in both modes on the reference-stream and stride windows of
    tests/pick_windows.py (the stride windows also with every slot a corner
    candidate, so that flat runs of equal keys tie in the corner pass), on
    tests/test_torch_strict.py's multi-ring scans (seeds as there) and on an
    HDL-64 scan of tests/data/kitti_mini (64 rings, W = 1816);
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
CORNER_CAP = 20
SUPPRESS = 5


def _sort_words(key, slots):
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


def transcribe(window, edge_threshold, surf_threshold, strict):
    """csrc/ring_pick.cu's block, in NumPy, on one window: label [W] int8."""
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
        words = np.sort(_sort_words(key, slots))
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
         + [f"multi_ring-{s}" for s in range(6)] + ["hdl64-0"])


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "fast"])
@pytest.mark.parametrize("case", CASES)
def test_transcription_equals_plain_pick(one_torch_thread, case,  # noqa: F811
                                         strict):
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
    want = np.stack([transcribe({k: v[r] for k, v in rings.items()}, edge,
                                surf, strict) for r in range(n_rings)])
    np.testing.assert_array_equal(label, want)
    assert (label == 1).any()
    if not strict:
        assert not (label == -1).any()
    elif not case.startswith("ties"):   # there corner marks cover every slot
        assert (label == -1).any()


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
