"""LOAM edge/planar feature extraction, batched over scans and rings.

Port of the JAX package's `ops/features.py`.  Rebuild of FeatureExtraction
(ref: src/featureExtraction.h):

  * curvature (calculateSmoothness, ref :109-131): an 11-tap shifted sum over
    the flat compacted range array, adds in the reference's order;
  * occlusion / parallel-beam masking (markOccludedPoints, ref :134-176):
    shifted comparisons + mask dilation;
  * picking (extractFeatures, ref :178-294): each greedy pass with +-5
    path-clear suppression is a greedy maximal independent set, computed as
    rounds of "pick every alive candidate that beats all alive conflicting
    neighbours, suppress their neighbours".  Strict mode reproduces the
    reference's serialized stream bit for bit: 6 sequential sector stages
    of a corner pass (descending, first 20, ref :221) and a surf pass
    (ascending, with a stride-6 fast-forward), marks carried across passes
    and sectors.  Fast mode runs one corner-only pass with conflicts
    restricted to the same sector, then keeps the first 20 picks a sector;
  * per-ring surface voxel thinning (ref :288-292).

Ring lanes share no state, which is exact in strict mode too: the
reference's only cross-ring write (a pick at a ring's first sector slot
marking the previous ring's last point, ref :236) lands outside every
pickable range (the JAX package's module docstring has the argument).

Where the JAX package vmaps `_ring_pick` over 16 ring lanes per scan and
compiles its rounds into one device loop, the port's `ring_pick` launches
the CUDA kernel `csrc/ring_pick.cu` on CUDA tensors: one block a ring window
runs the reference's greedy, so one launch picks every ring of a batch with
no host sync.  The block sorts its six sectors' candidate lists at once, a
warp each, and walks each list on a warp 32 candidates a step (a ballot
orders the step's live candidates; each pick drops the later ones it would
suppress); strict mode walks the sectors in order on one warp, fast mode
walks all six side by side.  On CPU tensors it runs its plain version,
`ring_pick_reference`: the MIS rounds above on every ring of the batch as
one [B, n_scan, W] tensor, one host sync (`any()`) a round.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..config import Params
from ..pipeline.cloud_info import CloudInfo, ScanFeatures
from .voxel import voxel_downsample

_MARGIN = 8
_SHIFTS = [s for s in range(-5, 6) if s != 0]


def _curvature_flat(point_range, num_points):
    """diffRange = r[i-5]+...+r[i-1] - 10*r[i] + r[i+1]+...+r[i+5];
    curvature = diffRange^2 (ref: src/featureExtraction.h:115-122), valid
    for i in [5, size-5).  point_range [B, P], num_points [B]."""
    r = point_range
    acc = torch.roll(r, 5, dims=1)
    for k in (4, 3, 2, 1):
        acc = acc + torch.roll(r, k, dims=1)
    acc = acc - 10.0 * r
    for k in (1, 2, 3, 4, 5):
        acc = acc + torch.roll(r, -k, dims=1)
    i = torch.arange(r.shape[1], device=r.device)[None, :]
    in_win = (i >= 5) & (i < num_points[:, None] - 5)
    return torch.where(in_win, acc * acc, 0.0)


def _occlusion_mask(point_range, point_col, num_points):
    """Initial neighbor-picked mask (markOccludedPoints,
    ref: src/featureExtraction.h:134-176); loop range i in [5, size-6)."""
    r, c = point_range, point_col
    i = torch.arange(r.shape[1], device=r.device)[None, :]
    in_win = (i >= 5) & (i < num_points[:, None] - 6)

    r_next = torch.roll(r, -1, dims=1)
    col_diff = torch.abs(torch.roll(c, -1, dims=1) - c)
    occ_a = in_win & (col_diff < 10) & (r - r_next > 0.3)  # marks i-5..i
    occ_b = in_win & (col_diff < 10) & (r_next - r > 0.3)  # marks i+1..i+6

    picked = torch.zeros_like(in_win)
    for j in range(0, 6):
        picked = picked | torch.roll(occ_a, -j, dims=1)
    for j in range(1, 7):
        picked = picked | torch.roll(occ_b, j, dims=1)

    diff1 = torch.abs(torch.roll(r, 1, dims=1) - r)
    diff2 = torch.abs(r_next - r)
    parallel = in_win & (diff1 > 0.02 * r) & (diff2 > 0.02 * r)
    return picked | parallel


def _ring_windows(cloud: CloudInfo, n_scan: int, horizon_scan: int):
    """Per-ring local windows [B, n_scan, W] (W = horizon_scan + 2*MARGIN)
    of the flat compacted arrays.  Window slot w of ring r is flat index
    ring_first[r] - MARGIN + w (ring_first inverts ref :650, count-1+5)."""
    B, P = cloud.point_range.shape
    dev = cloud.point_range.device
    W = horizon_scan + 2 * _MARGIN

    curv = _curvature_flat(cloud.point_range, cloud.num_points)
    picked0 = _occlusion_mask(cloud.point_range, cloud.point_col_ind,
                              cloud.num_points)
    packed = torch.cat([
        curv[..., None],
        cloud.point_col_ind.to(torch.float32)[..., None],
        picked0.to(torch.float32)[..., None],
        cloud.point_valid.to(torch.float32)[..., None],
        cloud.points], dim=-1)                                 # [B, P, 7]
    packed = torch.nn.functional.pad(packed, (0, 0, W, W))

    ring_first = cloud.start_ring_index + 1 - 5               # [B, n_scan]
    ws = ring_first - _MARGIN
    w_idx = torch.arange(W, device=dev)
    start = torch.clamp(ws + W, 0, P + W).to(torch.int64)
    gidx = (start[..., None] + w_idx).reshape(B, n_scan * W)
    win = torch.gather(packed, 1, gidx[..., None].expand(-1, -1, 7))
    win = win.reshape(B, n_scan, W, 7)

    idx = ws[..., None] + w_idx
    ok = (idx >= 0) & (idx < P)
    # sector split with C truncation (ref: src/featureExtraction.h:195-197)
    s_idx = cloud.start_ring_index.to(torch.int64)[..., None]
    e_idx = cloud.end_ring_index.to(torch.int64)[..., None]
    j = torch.arange(6, device=dev)
    sp = torch.div(s_idx * (6 - j) + e_idx * j, 6, rounding_mode="trunc")
    ep = torch.div(s_idx * (5 - j) + e_idx * (j + 1), 6,
                   rounding_mode="trunc") - 1
    sp = (sp - ws[..., None]).to(torch.int32)
    ep = (ep - ws[..., None]).to(torch.int32)
    return dict(
        curv=torch.where(ok, win[..., 0], 0.0),
        col=torch.where(ok, win[..., 1].to(torch.int32), -(10 ** 6)),
        picked=torch.where(ok, win[..., 2] > 0, True),
        xyz=torch.where(ok[..., None], win[..., 4:7], 0.0),
        pvalid=ok & (win[..., 3] > 0),
        sp=sp,                       # [B, n_scan, 6] local sector starts
        ep=ep,                       # [B, n_scan, 6]
        sector_ok=sp < ep,           # ref :199 skips sp >= ep
    )


def _pick_setup(win):
    """Loop-invariant tensors of the picking passes on ring windows [..., W]:
    (w_idx, key, sec, conf, bcum).

    key: curvature, +inf at each sector's last slot `ep` (std::sort's range
    excludes ep while the pick loops include it, ref :203 vs :208: ep is
    examined first in the descending corner pass and last in the ascending
    surf pass).  sec: the sector of each slot, -1 outside every sector.
    conf[s]: the neighbour at i-s conflicts with i: |s| <= 5 without index
    wrap and no column gap > 10 between them, i.e. equal gap-break prefix
    counts bcum (the path check of ref :227-240)."""
    curv, col = win["curv"], win["col"]
    W = curv.shape[-1]
    w_idx = torch.arange(W, device=curv.device)
    gap_break = torch.abs(col - torch.roll(col, 1, dims=-1)) > 10
    bcum = torch.cumsum(gap_break.to(torch.int32), dim=-1)

    sec = torch.full_like(col, -1)
    is_ep = torch.zeros_like(win["picked"])
    for j in range(6):
        ok_j = win["sector_ok"][..., j:j + 1]
        span = (ok_j & (w_idx >= win["sp"][..., j:j + 1])
                & (w_idx <= win["ep"][..., j:j + 1]))
        sec = torch.where(span, j, sec)
        is_ep = is_ep | (ok_j & (w_idx == win["ep"][..., j:j + 1]))
    key = torch.where(is_ep, float("inf"), curv)
    conf = {s: ((torch.roll(bcum, s, dims=-1) == bcum)
                & (torch.abs(torch.roll(w_idx, s) - w_idx) <= 5))
            for s in _SHIFTS}
    return w_idx, key, sec, conf, bcum


def _beats(key, w_idx, conf, descending):
    """Per shift s: the conflicting neighbour at i-s comes before i in the
    pass's order: descending (key, pos) for corners (larger pos wins ties,
    the reversed stable sort of the reference), ascending (key, pos) for
    surfaces (smaller pos wins ties)."""
    out = {}
    for s, c in conf.items():
        k_s = torch.roll(key, s, dims=-1)
        i_s = torch.roll(w_idx, s)
        if descending:
            b = (k_s > key) | ((k_s == key) & (i_s > w_idx))
        else:
            b = (k_s < key) | ((k_s == key) & (i_s < w_idx))
        out[s] = c & b
    return out


def _dilate(p, adj):
    """Positions suppressed by picks p (the picks included)."""
    out = p.clone()
    for s, a in adj.items():
        out |= torch.roll(p, s, dims=-1) & a
    return out


def _mis(alive, beats_me, adj, bcum=None):
    """The exact greedy pick set of every ring window at once, as rounds of
    "pick every alive candidate that no alive conflicting neighbour beats,
    suppress their neighbours" (a greedy maximal independent set on the +-5
    conflict graph; for totally ordered keys it equals the serial greedy).
    One host sync (`any()`) a round for the whole batch.

    bcum given: the stride-6 chain fast-forward.  Plain rounds advance ~1
    pick a round along a chain of dependencies (flat rings: equal-key runs
    hundreds long).  A pick at i-6 suppresses all of i-5..i-1, so i is
    serially picked when the window [i-6, i] is path-clear (one bcum
    equality), i is alive, and no alive conflicting neighbour on i's far
    side beats it; that relation is a stride-6 reachability along the ring,
    closed in log2(W/6) doubling steps, forward (a pick on the left resolves
    rightward) and backward."""
    W = alive.shape[-1]
    w_idx = torch.arange(W, device=alive.device)
    if bcum is not None:
        hop_f = ((torch.roll(bcum, 6, dims=-1) == bcum)
                 & (torch.roll(w_idx, 6) == w_idx - 6))
        hop_b = ((torch.roll(bcum, -6, dims=-1) == bcum)
                 & (torch.roll(w_idx, -6) == w_idx + 6))
        n_dbl = max(1, (W // 6).bit_length())
    alive = alive.clone()
    pick = torch.zeros_like(alive)
    for _ in range(W):   # every round picks >= 1 point of each live ring
        extract_features.host_syncs += 1
        if not bool(alive.any()):
            break
        # ext_r: no alive beater on the right (neighbour j > i <=> s < 0)
        ext_r, ext_l = alive.clone(), alive.clone()
        for s, b in beats_me.items():
            clear = ~(torch.roll(alive, s, dims=-1) & b)
            if s < 0:
                ext_r &= clear
            else:
                ext_l &= clear
        ext = ext_r & ext_l
        if bcum is not None:
            rf, rb = ext, ext
            pf, pb = ext_r & hop_f, ext_l & hop_b
            d = 6
            for _ in range(n_dbl):
                rf = rf | (torch.roll(rf, d, dims=-1) & pf)
                rb = rb | (torch.roll(rb, -d, dims=-1) & pb)
                pf = pf & torch.roll(pf, d, dims=-1)
                pb = pb & torch.roll(pb, -d, dims=-1)
                d *= 2
            ext = rf | rb
        pick |= ext
        alive &= ~_dilate(ext, adj)
    return pick


def _first20(pick, order):
    """The first 20 picks in `order` (descending (key, pos)): the per-sector
    cap, where the 21st qualifying candidate ends the corner phase
    (ref :221), so the capped picks are the first 20 of the uncapped
    greedy.  pick must lie within one sector."""
    pick_o = torch.gather(pick, -1, order)
    kept_o = pick_o & (torch.cumsum(pick_o.to(torch.int32), -1) <= 20)
    return torch.zeros_like(kept_o).scatter_(-1, order, kept_o)


def ring_pick_reference(win, edge_threshold, surf_threshold, strict,
                        stride=True):
    """The plain version of `ring_pick`: greedy feature picking on every
    ring window at once as MIS rounds, label [..., W] int8 (1 corner, -1
    surface pick, 0 neither).  One host sync a round, counted in
    `extract_features.host_syncs`.

    strict (the reference's serialized stream, bit for bit): 6 sequential
    sector stages, each a corner pass (descending, capped at 20) then a
    surf pass (ascending), with the suppression marks carried across the
    passes and the sectors.  stride: the surf pass's chain fast-forward
    (`_mis`); off gives the same picks in more rounds.  fast: one corner
    pass over all sectors at once with conflicts inside a sector only, then
    the first 20 picks of each sector; it loses the cross-sector suppression
    spill (<= 5 points a seam) and the surf pass's marks."""
    curv = win["curv"]
    w_idx, key, sec, conf, bcum = _pick_setup(win)
    # descending (key, pos): a stable sort by key of the reversed positions
    rev = torch.flip(w_idx, [0])
    order = rev[torch.sort(key[..., rev], dim=-1, descending=True,
                           stable=True)[1]]
    label = torch.zeros(curv.shape, dtype=torch.int8, device=curv.device)
    if strict:
        beats_c = _beats(key, w_idx, conf, descending=True)
        beats_s = _beats(key, w_idx, conf, descending=False)
        marks = win["picked"].clone()
        for j in range(6):
            in_sec = sec == j
            pick_c = _first20(_mis(in_sec & ~marks & (curv > edge_threshold),
                                   beats_c, conf), order)
            marks |= _dilate(pick_c, conf)
            pick_s = _mis(in_sec & ~marks & (curv < surf_threshold),
                          beats_s, conf, bcum if stride else None)
            marks |= _dilate(pick_s, conf)
            label.masked_fill_(pick_c, 1)
            label.masked_fill_(pick_s, -1)
    else:
        same = {s: c & (torch.roll(sec, s, dims=-1) == sec)
                for s, c in conf.items()}
        pick = _mis((sec >= 0) & ~win["picked"] & (curv > edge_threshold),
                    _beats(key, w_idx, same, descending=True), same)
        for j in range(6):
            label.masked_fill_(_first20(pick & (sec == j), order), 1)
    return label


def _check_windows(win):
    """Dtypes, shapes, devices and contiguity `ring_pick` takes."""
    curv = win["curv"]
    want = {"curv": (torch.float32, curv.shape),
            "col": (torch.int32, curv.shape),
            "picked": (torch.bool, curv.shape),
            "sp": (torch.int32, curv.shape[:-1] + (6,)),
            "ep": (torch.int32, curv.shape[:-1] + (6,)),
            "sector_ok": (torch.bool, curv.shape[:-1] + (6,))}
    for name, (dtype, shape) in want.items():
        t = win[name]
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.device != curv.device:
            raise ValueError(f"{name} is on {t.device}, curv on "
                             f"{curv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ring_pick(win, edge_threshold, surf_threshold, strict, stride=True):
    """Greedy feature picking on every ring window at once (the JAX
    package's `_ring_pick`): label [..., W] int8, 1 corner, -1 surface
    pick, 0 neither.

    win: `_ring_windows`' curv f32, col i32, picked bool [..., W]; sp, ep
    i32 and sector_ok bool [..., 6].  CPU tensors run the plain version
    (`ring_pick_reference`; stride is its surf pass's fast-forward, which
    changes no pick); CUDA tensors launch the kernel `csrc/ring_pick.cu`,
    one block a window, a warp a sector's sort and walk, W up to
    kernels.RING_PICK_MAX_W."""
    _check_windows(win)
    curv = win["curv"]
    if curv.device.type == "cpu":
        return ring_pick_reference(win, edge_threshold, surf_threshold,
                                   strict, stride)
    if curv.device.type != "cuda":
        raise ValueError(f"unsupported device {curv.device}")
    label = torch.empty(curv.shape, dtype=torch.int8, device=curv.device)
    kernels.launch_ring_pick(
        curv, win["col"], win["picked"], win["sp"], win["ep"],
        win["sector_ok"], label, edge_threshold=edge_threshold,
        surf_threshold=surf_threshold, strict=strict)
    ring_pick.launches += 1
    return label


ring_pick.launches = 0


def _sector_span(win):
    """Slots inside a picked sector [..., W] (surface gathering covers every
    non-skipped sector span, ref :279-284)."""
    w_idx = torch.arange(win["curv"].shape[-1], device=win["curv"].device)
    span = torch.zeros_like(win["picked"])
    for j in range(6):
        span |= (win["sector_ok"][..., j:j + 1]
                 & (w_idx >= win["sp"][..., j:j + 1])
                 & (w_idx <= win["ep"][..., j:j + 1]))
    return span


def _pick(win, edge_threshold, surf_threshold, strict, stride=True):
    """Greedy feature picking on every ring window at once: (label [..., W]
    int8 from `ring_pick`; sector span [..., W])."""
    return (ring_pick(win, edge_threshold, surf_threshold, strict, stride),
            _sector_span(win))


def window_labels(params: Params, cloud: CloudInfo, strict: bool = True):
    """Ring windows and their picks: (win, label [B, n_scan, W] int8,
    surf_span [B, n_scan, W], ring_first [B, n_scan]).  Window slot w of
    ring r is flat index ring_first[r] - 8 + w of the compacted cloud."""
    win = _ring_windows(cloud, params.n_scan, params.horizon_scan)
    label, surf_span = _pick(win, params.edge_threshold,
                             params.surf_threshold, strict)
    return win, label, surf_span, cloud.start_ring_index + 1 - 5


def extract_features(params: Params, cloud: CloudInfo,
                     strict: bool = True) -> ScanFeatures:
    """Feature extraction (laserCloudInfoHandler body, ref:
    src/featureExtraction.h:88-103) for a batch of clouds; strict=False
    picks fast (see `ring_pick_reference`).  On CUDA tensors the picking is
    one `ring_pick` launch; on CPU tensors each MIS round of its plain
    version is one host sync, counted in `extract_features.host_syncs`."""
    n_scan = params.n_scan
    win, label, surf_span, _ = window_labels(params, cloud, strict)
    B = label.shape[0]

    # corner set: picked & valid, compacted per ring (stable: valid first)
    ring_corner_cap = params.corner_cap // n_scan
    corner_m = (label == 1) & win["pvalid"]
    _, order = torch.sort((~corner_m).to(torch.uint8), dim=-1, stable=True)
    order = order[..., :ring_corner_cap]
    cm = torch.gather(corner_m, -1, order)
    cxyz = torch.gather(win["xyz"], -2, order[..., None].expand(-1, -1, -1, 3))
    cxyz = torch.where(cm[..., None], cxyz, 0.0)

    # surface set: unpicked within sector spans, per-ring voxel thinning
    ring_surf_cap = params.surf_cap // n_scan
    surf_m = surf_span & (label <= 0) & win["pvalid"]
    sxyz, sm, _ = voxel_downsample(win["xyz"], surf_m,
                                   params.odometry_surf_leaf_size,
                                   ring_surf_cap)
    return ScanFeatures(
        corner_xyz=cxyz.reshape(B, -1, 3),
        corner_mask=cm.reshape(B, -1),
        surf_xyz=sxyz.reshape(B, -1, 3),
        surf_mask=sm.reshape(B, -1),
    )


extract_features.host_syncs = 0
