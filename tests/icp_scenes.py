"""Inputs of the streamed k-NN (`ops/knn.py`) and of ICP (`ops/icp.py`),
made from seeds with numpy: no JAX, so the GPU tests and chip_smoke.py use
them.

k-NN scenes (`knn_scene(name, M, chunk)` -> (query [Q, 3], ref [M, 3],
mask [M]), every map padded to M, a multiple of chunk):

  random        queries and map points 100 m out, 80% of the map live
  duplicates    the random scene with map points 4..8 one point and
                query 0 on it: exact ties, which go to the lower index
  few_live      3 live map points (0, M // 2, M - 1): k > 3 leaves
                no-neighbour slots, whose index is the lowest masked one
                (1, 2, ...) with one chunk (M == chunk) and 0 with more
                (the plain version's running best starts at (3e38, 0))
  all_masked    no live map point: every slot a no-neighbour slot

ICP scenes (`icp_scene(name, N, M, chunk)` -> (src [N, 3], src_mask [N],
dst [M, 3], dst_mask [M], icp_align's keywords)):

  room          SLAM-shaped: a room's walls, floor and pillars (1 cm of
                noise) 40 m out in the world frame; the source 60% of the
                live target points seen from a small pose error, so that
                ICP settles (its matches stop changing, or swap between
                two sets: a 2-cycle of 1e-5 at the merge's caps); both
                padded with zero rows masked, as the loop closure's
                submaps are (the padding pulls knn's centre towards the
                origin, so each d2 carries the rounding of a |q - c|^2 of
                hundreds of m^2); max_corr_dist 100 and 100 iterations
  pair          the room at the pair alignment's settings (2 m, 50
                iterations)
  merge         the room at the session merge's (5 m, 60 iterations)
  far           every target 1000 m away with max_corr_dist 1: no
                correspondence, so H = 0 and the transform stays I
  one_match     one source point within reach of the target: H = 0 again
                (one centred point), R = I and t its offset

Edge scenes of the cell search in csrc/icp.cu (`edge_scene(name, N, M,
chunk)`, the same tuple, at OFFSET; tests/knn_cells.py transcribes the
search):

  face          the target a 16^3 lattice at 0.4 m whose cells (the
                kernel's rule: ~8 live points a cell) are 0.75 m, a third
                of its points moved onto a cell face or one float32 ulp
                (~4e-6 m) off it, and the source rows likewise
  tie           a 1 m lattice and source rows at the midpoints of lattice
                edges, in pairs symmetric about a lattice point, so that
                the centroid and every key are exact: each row has two
                nearest points at equal keys, often in two cells (ties go
                to the lower index)
  duplicates    the room with runs of five target points at one place
  far_row       the room with one live source row 300 m outside the box
  few_live      the room with 3 live target points
  no_live       the room with none
"""

import numpy as np

F32 = np.float32
KNN_BIG = 3.0e38
KNN_SCENES = ("random", "duplicates", "few_live", "all_masked")
ICP_SCENES = ("room", "pair", "merge", "far", "one_match")
EDGE_SCENES = ("face", "tie", "duplicates", "far_row", "few_live", "no_live")
ICP_KW = {"room": dict(max_corr_dist=100.0, max_iterations=100),
          "pair": dict(max_corr_dist=2.0, max_iterations=50),
          "merge": dict(max_corr_dist=5.0, max_iterations=60),
          "far": dict(max_corr_dist=1.0, max_iterations=5),
          "one_match": dict(max_corr_dist=0.5, max_iterations=5)}
OFFSET = np.array([40.0, -25.0, 1.5])   # m, the scenes' world position


def knn_scene(name, M, chunk, Q=300, seed=0):
    if M % chunk:
        raise ValueError(f"M {M} not a multiple of chunk {chunk}")
    r = np.random.RandomState(seed)
    q = (r.uniform(-20, 20, (Q, 3)) + 100.0).astype(F32)
    ref = (r.uniform(-20, 20, (M, 3)) + 100.0).astype(F32)
    mask = r.uniform(size=M) < 0.8
    if name == "duplicates":
        ref[5:9] = ref[4]
        q[0] = ref[4]
        mask[4:9] = True
    elif name == "few_live":
        mask[:] = False
        mask[[0, M // 2, M - 1]] = True
    elif name == "all_masked":
        mask[:] = False
    elif name != "random":
        raise ValueError(name)
    return q, ref, mask


def rotation(rpy):
    cr, sr, cp, sp, cy, sy = (np.cos(rpy[0]), np.sin(rpy[0]), np.cos(rpy[1]),
                              np.sin(rpy[1]), np.cos(rpy[2]), np.sin(rpy[2]))
    return np.array([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                     [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                     [-sp, cp * sr, cp * cr]])


def room_points(n, r):
    """n points of a 16 x 12 x 3 m room (walls, floor) with four pillars,
    0.01 m of noise, centred on the origin."""
    kind = r.randint(0, 7, n)
    u, v = r.uniform(0, 1, n), r.uniform(0, 1, n)
    p = np.empty((n, 3))
    p[:, 0] = (u - 0.5) * 16.0
    p[:, 1] = (v - 0.5) * 12.0
    p[:, 2] = r.uniform(0, 3.0, n)
    p[kind == 0, 0] = -8.0
    p[kind == 1, 0] = 8.0
    p[kind == 2, 1] = -6.0
    p[kind == 3, 1] = 6.0
    p[kind == 4, 2] = 0.0
    pil = kind >= 5
    a = r.uniform(0, 2 * np.pi, pil.sum())
    cx = np.where(r.uniform(size=pil.sum()) < 0.5, -3.0, 3.0)
    cy = np.where(r.uniform(size=pil.sum()) < 0.5, -2.0, 2.0)
    p[pil, 0] = cx + 0.3 * np.cos(a)
    p[pil, 1] = cy + 0.3 * np.sin(a)
    return p + r.normal(0, 0.01, p.shape)


def icp_scene(name, N=256, M=1024, chunk=256, seed=0):
    if M % chunk:
        raise ValueError(f"M {M} not a multiple of chunk {chunk}")
    r = np.random.RandomState(seed)
    n_dst, n_src = int(0.7 * M), int(0.6 * N)
    dst = np.zeros((M, 3), F32)
    dst_mask = np.zeros(M, bool)
    dst[:n_dst] = room_points(n_dst, r) + OFFSET
    dst_mask[:n_dst] = True
    # the source: target points seen from a pose error
    R = rotation([0.004, -0.006, 0.015])
    t = np.array([0.06, -0.04, 0.02])
    pick = r.choice(n_dst, n_src, replace=n_src > n_dst)
    body = dst[pick] - OFFSET
    src = np.zeros((N, 3), F32)
    src_mask = np.zeros(N, bool)
    src[:n_src] = (body - t) @ R + OFFSET
    src_mask[:n_src] = True
    if name == "far":
        dst[:n_dst] += 1000.0
    elif name == "one_match":
        dst[:n_dst] += 1000.0
        dst[0] = src[0] + np.array([0.1, -0.05, 0.02])
    elif name not in ("room", "pair", "merge"):
        raise ValueError(name)
    return src, src_mask, dst, dst_mask, dict(ICP_KW[name], chunk=chunk)


def _lattice(n, step, r):
    """An n^3 lattice at step m from OFFSET, in random order."""
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    return (g.reshape(-1, 3)[r.permutation(n ** 3)] * step + OFFSET)


def _onto_faces(p, lo, hi, h, r, share):
    """share of the rows of p [n, 3] (float32) with one coordinate moved
    onto its nearest inner face lo + k h (lo < face < hi), or one ulp off
    it; the box [lo, hi] stays as it is."""
    p = p.copy()
    for i in np.nonzero(r.uniform(size=len(p)) < share)[0]:
        ax = r.randint(3)
        k = np.clip(np.round((p[i, ax] - lo[ax]) / h), 1,
                    np.round((hi[ax] - lo[ax]) / h) - 1)
        face = np.float32(lo[ax] + h * k)
        side = r.randint(3)
        p[i, ax] = face if side == 0 else np.nextafter(
            face, np.float32(np.inf if side == 1 else -np.inf))
    return p


def edge_scene(name, N=256, M=4096, chunk=1024, seed=0):
    if M % chunk:
        raise ValueError(f"M {M} not a multiple of chunk {chunk}")
    kw = dict(max_corr_dist=100.0, max_iterations=10, chunk=chunk)
    r = np.random.RandomState(seed)
    if name in ("face", "tie"):
        n, step = (16, 0.4) if name == "face" else (16, 1.0)
        if M < n ** 3:
            raise ValueError(f"M {M} below the lattice's {n ** 3} points")
        dst = np.zeros((M, 3), F32)
        dst_mask = np.zeros(M, bool)
        dst[:n ** 3] = _lattice(n, step, r)
        dst_mask[:n ** 3] = True
        src = np.zeros((N, 3), F32)
        src_mask = np.zeros(N, bool)
        n_src = int(0.8 * N) // 2 * 2
        src_mask[:n_src] = True
        lo, hi = dst[:n ** 3].min(0), dst[:n ** 3].max(0)
        if name == "face":
            # 8 points a cell: 0.75 m cells over the 6 m lattice
            dst[:n ** 3] = _onto_faces(dst[:n ** 3], lo, hi, 0.75, r, 1 / 3)
            src[:n_src] = _onto_faces(
                (lo + r.uniform(0, 6.0, (n_src, 3))).astype(F32), lo, hi,
                0.75, r, 2 / 3)
        else:
            # midpoints of lattice edges in pairs about the lattice point P
            P = OFFSET + 8 * step
            ax = r.randint(3, size=n_src // 2)
            base = r.randint(1, n - 2, size=(n_src // 2, 3))
            v = base * step + OFFSET - P
            v[np.arange(n_src // 2), ax] += 0.5 * step
            src[:n_src:2] = P + v
            src[1:n_src:2] = P - v
            src[n_src:] = P
        return src, src_mask, dst, dst_mask, kw
    src, src_mask, dst, dst_mask, _ = icp_scene("room", N, M, chunk, seed)
    n_dst = int(dst_mask.sum())
    if name == "duplicates":
        for k in range(0, n_dst - 5, 50):
            dst[k + 1:k + 5] = dst[k]
    elif name == "far_row":
        src[0] = OFFSET + np.array([300.0, -20.0, 5.0])
    elif name == "few_live":
        dst_mask[:] = False
        dst_mask[[0, n_dst // 2, n_dst - 1]] = True
    elif name == "no_live":
        dst_mask[:] = False
    else:
        raise ValueError(name)
    return src, src_mask, dst, dst_mask, kw


def fitness_tol(src, src_mask, T):
    """The tolerance of an ICP fitness (the mean d2 of the matches) at the
    transform T: the k-NN's 1e-6 of the terms each d2 cancels, |q - c|^2 +
    |m - c|^2 ~ 2 |q - c|^2 for a match m ~ q, averaged over the live
    source rows (c: the centroid of all N rows of T src, knn's centre)."""
    src, T = np.asarray(src, np.float64), np.asarray(T, np.float64)
    q = src @ T[:3, :3].T + T[:3, 3]
    r2 = ((q - q.mean(0)) ** 2).sum(-1)[np.asarray(src_mask, bool)]
    return 2e-6 * float(r2.mean()) if r2.size else 0.0


def knn_agreement(q, ref, d2k, ik, d2p, ip, d2p1=None):
    """Hold a k-NN result (d2k, ik) of one query set q [Q, 3] against ref
    [M, 3] to the plain version's (d2p, ip) (torch tensors; d2p1: the plain
    version's k+1 nearest distances, or None): the no-neighbour slots (3e38)
    exactly; d2 within 1e-6 of the terms the formula cancels (|q-c|^2 +
    |m-c|^2, c the query centroid); a differing index only at a near-tie
    (both candidates' exact d2 within twice that); with d2p1, the index
    sets equal wherever the plain k-th and (k+1)-th distances lie farther
    apart than twice that.  Raises AssertionError where it fails; returns
    (max |d2 diff| on live slots, index differences)."""
    q, ref = q.double(), ref.double()
    c = q.mean(0)
    empty = d2p >= KNN_BIG
    if not ((d2k >= KNN_BIG) == empty).all() or not (
            (d2k[empty] == KNN_BIG).all() and (ik[empty] == ip[empty]).all()):
        raise AssertionError("knn: no-neighbour slots differ")
    live = ~empty
    tol = 1e-6 * (((q - c) ** 2).sum(-1)[:, None]
                  + ((ref[ip.long()] - c) ** 2).sum(-1))
    diff = (d2k.double() - d2p.double()).abs()
    if not (diff[live] <= tol[live]).all():
        raise AssertionError(f"knn: d2 |diff| {float(diff[live].max())}")
    swapped = (ik != ip) & live
    for i, j in swapped.nonzero().tolist():
        a, b = ref[int(ik[i, j])], ref[int(ip[i, j])]
        exact = float(((a - q[i]) ** 2).sum() - ((b - q[i]) ** 2).sum())
        if not abs(exact) <= 2 * float(tol[i, j]):
            raise AssertionError(f"knn: query {i} slot {j}: {int(ik[i, j])}"
                                 f" for {int(ip[i, j])}, {exact} apart")
    k = d2p.shape[-1]
    if d2p1 is not None:
        sep = ((d2p1[:, k].double() - d2p1[:, k - 1].double())
               > 2 * tol[:, k - 1]) & live[:, k - 1]
        if not (ik[sep].sort(-1).values == ip[sep].sort(-1).values).all():
            raise AssertionError("knn: neighbour sets differ")
    return (float(diff[live].max()) if bool(live.any()) else 0.0,
            int(swapped.sum()))
