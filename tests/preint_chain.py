"""numpy float32 transcriptions of the orders in which csrc/preintegration.cu
walks a sample buffer, made to be held bit for bit to each other on the CPU
(no JAX; every product and sum rounds to float32, no FMA, as the kernels
build with -fmad=false).

Both orders take the state-free terms of a slot (a, Exp(w dt), Jr(w dt),
the noise densities) from the port's `_sample_terms` on the CPU, so that
sinf and cosf do not enter the comparison.

  preint_parent   the one-CTA kernel the redesign replaced: chunks of 128
                  slots, the live slots in buffer order, a step in three
                  stages (the 3x3 products of the running state; T1 = A cov
                  over all nine q, A's zeros included, `trans_A`'s entries;
                  cov = (T1 A^T + (B noise) B^T) + int_noise over nine and
                  six q; the bias Jacobians, dv, dp, dt)
  preint_split    the redesign: chunks of 32 slots, the live slots of a
                  chunk compacted in slot order (a ballot and a prefix
                  count); the dR and dR_dbg chains on their own, recording
                  the state each step reads; a sample's terms from them (dR
                  [a]x, dR a, X, A's first block column, (B noise) B^T's 45
                  structural nonzeros, the flag); cov on A's structure
                  (A cov 5 terms an entry, zero coefficients where a row has
                  fewer; T1 A^T 3, 4 or 5 by the column's block), the step
                  done again in the parent's dense order where the flag is
                  off or T1 is not finite; the sums
  propagate_parent, propagate_warp
                  the propagation's slot walk: the parent's (a chunk of 128
                  slots, R Exp and R a + g from the old R, then p and v) and
                  the redesign's (the same 3-term product on every lane, R
                  Exp and R a from the old R, p and v computed at every slot
                  and kept at the live ones)

Each preintegration returns the twelve PreintState leaves as float32
arrays (and, for preint_split, the count of dense steps); each propagation
R [N, 3, 3], p [N, 3], v [N, 3].
"""

import numpy as np
import torch

from feature_base_pointcloud_registration_tpu_torch.geom.se3 import so3_exp
from feature_base_pointcloud_registration_tpu_torch.imu.preintegration import (  # noqa: E501
    _sample_terms)

F = np.float32
Z = F(0.0)
HALF = F(0.5)
EYE3 = np.eye(3, dtype=F)
PARENT_CHUNK = 128
SPLIT_CHUNK = 32
PROP_CHUNK = 128
LEAVES = ("dR", "dv", "dp", "dt", "dR_dbg", "dv_dba", "dv_dbg", "dp_dba",
          "dp_dbg", "cov", "bias_acc", "bias_gyr")


def sample_terms(acc, gyr, dt, ba, bg, acc_var, gyr_var):
    """Every slot's state-free terms (numpy float32): a [N, 3], Exp(w dt)
    [N, 3, 3], Jr [N, 3, 3], the gyro and accel noise densities [N]."""
    T = torch.from_numpy
    a, dRk, Jr, _, noise, _ = _sample_terms(
        T(acc), T(gyr), T(dt), T(ba), T(bg), acc_var, gyr_var, 0.0)
    return (a.numpy(), dRk.numpy(), Jr.numpy(), noise[:, 0].numpy(),
            noise[:, 3].numpy())


def _mm3(X, Y):
    """X Y for 3x3 float32: ((x_i0 y_0j + x_i1 y_1j) + x_i2 y_2j)."""
    return (X[:, 0:1] * Y[0:1, :] + X[:, 1:2] * Y[1:2, :]) + X[:, 2:3] * Y[2:3, :]


def _mv3(X, v):
    return (X[:, 0] * v[0] + X[:, 1] * v[1]) + X[:, 2] * v[2]


def _hat(v):
    return np.array([[Z, -v[2], v[1]], [v[2], Z, -v[0]], [-v[1], v[0], Z]],
                    F)


def _trans_A(dRk, dRA, d):
    """The 9x9 A of `_integrate` as the kernels' trans_A gives its entries
    (eye * dt off the diagonal is 0 * dt)."""
    A = np.zeros((9, 9), F)
    A[0:3, 0:3] = dRk.T
    A[3:6, 0:3] = (-dRA) * d
    A[3:6, 3:6] = EYE3
    A[6:9, 0:3] = ((F(-0.5) * dRA) * d) * d
    A[6:9, 3:6] = EYE3 * d
    A[6:9, 6:9] = EYE3
    return A


def _noise_B(Jr, R, d):
    """The 9x6 B of `_integrate` (noise_B)."""
    B = np.zeros((9, 6), F)
    B[0:3, 0:3] = Jr * d
    dRdt = R * d
    B[3:6, 3:6] = dRdt
    B[6:9, 3:6] = (HALF * dRdt) * d
    return B


def _dense_cov(cov, A, B, noise6, int_var, d):
    """The parent's cov step: T1 = A cov over every q from +0, then (T1 A^T
    over every q + (B noise) B^T over every q) + (e int_var) d."""
    T1 = np.zeros((9, 9), F)
    for q in range(9):
        T1 = T1 + A[:, q:q + 1] * cov[q:q + 1, :]
    x = np.zeros((9, 9), F)
    y = np.zeros((9, 9), F)
    for q in range(9):
        x = x + T1[:, q:q + 1] * A[:, q][None, :]
    for q in range(6):
        y = y + (B[:, q:q + 1] * noise6[q]) * B[:, q][None, :]
    E = np.zeros((9, 9), F)
    E[6:, 6:] = EYE3
    return (x + y) + (E * F(int_var)) * d


def _sums(st, R, X, dR_a, d):
    """The bias Jacobians, dv, dp and dt of a step (the parent's stage 3)."""
    va, vg, v = st["dv_dba"], st["dv_dbg"], st["dv"]
    st["dp_dba"] = (st["dp_dba"] + va * d) - ((HALF * R) * d) * d
    st["dp_dbg"] = (st["dp_dbg"] + vg * d) - ((HALF * X) * d) * d
    st["dv_dba"] = va - R * d
    st["dv_dbg"] = vg - X * d
    st["dv"] = v + dR_a * d
    st["dp"] = (st["dp"] + v * d) + ((HALF * dR_a) * d) * d
    st["dt"] = st["dt"] + d


def _zero_state(ba, bg):
    z3, z33 = np.zeros(3, F), np.zeros((3, 3), F)
    return dict(dR=EYE3.copy(), dv=z3, dp=z3, dt=Z, dR_dbg=z33, dv_dba=z33,
                dv_dbg=z33, dp_dba=z33, dp_dbg=z33, cov=np.zeros((9, 9), F),
                bias_acc=np.asarray(ba, F), bias_gyr=np.asarray(bg, F))


def _live_of(mask, n):
    return np.ones(n, bool) if mask is None else np.asarray(mask, bool)


def preint_parent(acc, gyr, dt, mask, ba, bg, acc_var, gyr_var,
                  int_var=1e-8):
    """The parent kernel's order: {leaf: float32 array}."""
    n = acc.shape[0]
    a_, dRk_, Jr_, ng_, na_ = sample_terms(acc, gyr, dt, ba, bg, acc_var,
                                           gyr_var)
    live = _live_of(mask, n)
    st = _zero_state(ba, bg)
    with np.errstate(all="ignore"):
        for base in range(0, n, PARENT_CHUNK):
            for s in range(base, min(n, base + PARENT_CHUNK)):
                if not live[s]:
                    continue
                d, av, dRk, Jr = F(dt[s]), a_[s], dRk_[s], Jr_[s]
                R, G = st["dR"], st["dR_dbg"]
                # stage 1
                dRA = _mm3(R, _hat(av))
                st["dR"] = _mm3(R, dRk)
                st["dR_dbg"] = _mm3(dRk.T, G) - Jr * d
                dR_a = _mv3(R, av)
                # stage 2 and 3
                X = _mm3(dRA, G)
                noise6 = np.array([ng_[s]] * 3 + [na_[s]] * 3, F)
                st["cov"] = _dense_cov(st["cov"], _trans_A(dRk, dRA, d),
                                       _noise_B(Jr, R, d), noise6, int_var,
                                       d)
                _sums(st, R, X, dR_a, d)
    return {k: np.asarray(v, F) for k, v in st.items()}


def _sparse_cov(cov, A3, y, ie, d):
    """The redesign's cov step on A's structure: (T1, cov').  A3 [3, 3, 3]:
    A's first block column by row block.  A cov: every row 5 terms, its 4th
    and 5th (eye, eye dt) times cov rows 3 + i % 3 and 6 + i % 3, with zero
    coefficients in the rows that have fewer (the cov lanes' rows differ);
    T1 A^T: a column of block 0, 1, 2 (the same in every lane) its 3, 4, 5
    nonzero terms; both sums from their first term, not from +0; +
    int_noise where it is not zero (columns 6-8)."""
    Arow = A3.reshape(9, 3)
    one = F(1.0)
    k3 = np.array([Z] * 3 + [one] * 3 + [d] * 3, F)
    k6 = np.array([Z] * 6 + [one] * 3, F)
    i3 = 3 + np.arange(9) % 3
    i6 = 6 + np.arange(9) % 3
    T1 = Arow[:, 0:1] * cov[0:1, :]
    for m in (1, 2):
        T1 = T1 + Arow[:, m:m + 1] * cov[m:m + 1, :]
    T1 = T1 + k3[:, None] * cov[i3, :]
    T1 = T1 + k6[:, None] * cov[i6, :]
    x = T1[:, 0:1] * Arow[:, 0][None, :]
    for m in (1, 2):
        x = x + T1[:, m:m + 1] * Arow[:, m][None, :]
    x[:, 3:6] = x[:, 3:6] + T1[:, 3:6] * one
    x[:, 6:9] = (x[:, 6:9] + T1[:, 3:6] * d) + T1[:, 6:9] * one
    out = x + y
    out[:, 6:9] = out[:, 6:9] + ie[:, 6:9] * d
    return T1, out


def preint_split(acc, gyr, dt, mask, ba, bg, acc_var, gyr_var,
                 int_var=1e-8):
    """The redesign's order: ({leaf: float32 array}, dense steps)."""
    n = acc.shape[0]
    a_, dRk_, Jr_, ng_, na_ = sample_terms(acc, gyr, dt, ba, bg, acc_var,
                                           gyr_var)
    live = _live_of(mask, n)
    iv = F(int_var)
    E = np.zeros((9, 9), F)
    E[6:, 6:] = EYE3
    st = _zero_state(ba, bg)
    dense = 0
    with np.errstate(all="ignore"):
        for base in range(0, n, SPLIT_CHUNK):
            # stage 0: the chunk's live slots, in slot order
            rows = [s for s in range(base, min(n, base + SPLIT_CHUNK))
                    if live[s]]
            # stage 1: the two chains, each recording the state it reads
            Rs, Gs = [], []
            for s in rows:
                Rs.append(st["dR"])
                Gs.append(st["dR_dbg"])
                st["dR"] = _mm3(st["dR"], dRk_[s])
                st["dR_dbg"] = _mm3(dRk_[s].T, st["dR_dbg"]) \
                    - Jr_[s] * F(dt[s])
            # stages 2 and 3, a sample's terms then the cov step and sums
            for s, R, G in zip(rows, Rs, Gs):
                d, av, dRk, Jr = F(dt[s]), a_[s], dRk_[s], Jr_[s]
                ng, na = ng_[s], na_[s]
                dRA = _mm3(R, _hat(av))
                dR_a = _mv3(R, av)
                X = _mm3(dRA, G)
                A3 = np.stack([dRk.T, (-dRA) * d,
                               ((F(-0.5) * dRA) * d) * d])
                Bt = Jr * d
                Btn = Bt * ng
                Bv = R * d
                Bvp = np.concatenate([Bv, (HALF * Bv) * d])
                Bvpn = Bvp * na
                flag = all(np.isfinite(v).all() for v in (
                    d, ng, na, iv, Bt, Btn, Bvp, Bvpn))
                y = np.zeros((9, 9), F)
                yth = np.zeros((3, 3), F)
                yvp = np.zeros((6, 6), F)
                for q in range(3):
                    yth = yth + Btn[:, q:q + 1] * Bt[:, q][None, :]
                    yvp = yvp + Bvpn[:, q:q + 1] * Bvp[:, q][None, :]
                y[0:3, 0:3] = yth
                y[3:9, 3:9] = yvp
                T1, cov = _sparse_cov(st["cov"], A3, y, E * iv, d)
                if not (flag and np.isfinite(T1).all()):
                    dense += 1
                    noise6 = np.array([ng] * 3 + [na] * 3, F)
                    cov = _dense_cov(st["cov"], _trans_A(dRk, dRA, d),
                                     _noise_B(Jr, R, d), noise6, int_var, d)
                st["cov"] = cov
                _sums(st, R, X, dR_a, d)
    return {k: np.asarray(v, F) for k, v in st.items()}, dense


def _prop_terms(acc, gyr, dt, ba, bg):
    a_c = (torch.from_numpy(acc) - torch.from_numpy(ba)).numpy()
    w_c = torch.from_numpy(gyr) - torch.from_numpy(bg)
    dRs = so3_exp(w_c * torch.from_numpy(dt)[:, None]).numpy()
    return a_c, dRs


def propagate_parent(nav, ba, bg, acc, gyr, dt, mask, gravity):
    """The parent kernel's slot walk: (R [N, 3, 3], p [N, 3], v [N, 3])."""
    n = acc.shape[0]
    a_c, dRs = _prop_terms(acc, gyr, dt, ba, bg)
    g = np.array([0.0, 0.0, -gravity], F)
    live = _live_of(mask, n)
    R, p, v = (np.asarray(x, F) for x in nav)
    Rs, ps, vs = [], [], []
    with np.errstate(all="ignore"):
        for base in range(0, n, PROP_CHUNK):
            for s in range(base, min(n, base + PROP_CHUNK)):
                if live[s]:
                    d = F(dt[s])
                    acc_w = _mv3(R, a_c[s]) + g
                    R = _mm3(R, dRs[s])
                    p = (p + v * d) + ((HALF * acc_w) * d) * d
                    v = v + acc_w * d
                Rs.append(R)
                ps.append(p)
                vs.append(v)
    return np.stack(Rs), np.stack(ps), np.stack(vs)


def propagate_warp(nav, ba, bg, acc, gyr, dt, mask, gravity):
    """The redesign's walk: every lane the product (r_0 x_0 + r_1 x_1) +
    r_2 x_2 of its row of the old R with its column of Exp(w dt) (lanes
    0-8) or with a (lanes 9-11, then + g, p and v)."""
    n = acc.shape[0]
    a_c, dRs = _prop_terms(acc, gyr, dt, ba, bg)
    g = np.array([0.0, 0.0, -gravity], F)
    live = _live_of(mask, n)
    R, p, v = (np.asarray(x, F) for x in nav)
    out = np.zeros((n, 15), F)
    with np.errstate(all="ignore"):
        for base in range(0, n, PROP_CHUNK):
            for s in range(base, min(n, base + PROP_CHUNK)):
                if live[s]:
                    d = F(dt[s])
                    X = np.concatenate([dRs[s], a_c[s][:, None]], 1)
                    prod = _mm3(R, X)       # [3, 4]: R Exp, then R a
                    acc_w = prod[:, 3] + g
                    R = prod[:, :3]
                    p, v = (p + v * d) + ((HALF * acc_w) * d) * d, \
                        v + acc_w * d
                out[s] = np.concatenate([R.ravel(), p, v])
    return out[:, :9].reshape(n, 3, 3), out[:, 9:12], out[:, 12:]
