"""The IMU odometry's plain loops (the chain LM, its factor blocks, the
preintegration and the propagation) against the JAX package, their
dispatch, and the renamed loops bitwise the loops they were, on the CPU.

On CUDA tensors `optimize_imu_chain`, `chain_factor_blocks`,
`preintegrate` and `propagate_states` launch csrc/imu_chain_lm.cu and
csrc/preintegration.cu; the kernels run only on a GPU
(tests/test_torch_kernels_cuda.py).  Here, on tests/imu_chain_scenes.py's
windows (one JAX compile a shape: K 16 and K 1):

  * `optimize_imu_chain_reference` (4 iterations, as ImuOdometry runs it)
    against JAX's `optimize_imu_chain`: states within 1e-4 (the bound of
    tests/test_torch_imu.py), NaN where JAX has NaN; the cost within 1e-4
    relative or 1e-4 absolute (a converged window's cost is float32 noise
    of residuals whitened by ~1e-5 sigmas); the accept flags;
  * `chain_factor_blocks_reference` against JAX's on the finite scenes:
    blocks within 1e-4 of their largest entry (tests/test_torch_imu.py's
    bound);
  * `preintegrate_reference` and `propagate_states_reference` against JAX on
    buffers with interior masked samples and with no live sample: dt
    within 1e-7, cov within rtol 1e-5 with a floor of 1e-7 of its largest
    entry (tests/test_torch_imu.py's bounds), the other leaves within 5e-6
    of max(1, their largest entry) (XLA contracts the multiply-adds into
    FMAs and the port does not: over a 64-sample interval of 10 ms samples
    the bias Jacobians, ~0.5-1, part by up to 3e-6; tests/test_torch_imu.py
    holds 1e-6 on 49 samples of 5 ms), the propagated states within 1e-6;
  * the renamed plain loops bitwise the loops they were (kept here);
  * the dispatch: CPU tensors run the plain versions, the same bits;
    another device raises, as do the wrapper's checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu.graph import imu_graph as jg
from feature_base_pointcloud_registration_tpu.imu import (
    preintegration as jp)
from feature_base_pointcloud_registration_tpu_torch import kernels
from feature_base_pointcloud_registration_tpu_torch.graph import (
    imu_graph as tg)
from feature_base_pointcloud_registration_tpu_torch.imu import (
    preintegration as tp)

import imu_chain_scenes as ics
from test_torch_batch import one_torch_thread  # noqa: F401

ITERATIONS = 4


def _jax_chain(d):
    return jg.ImuChainData(*(
        jp.PreintState(*(jnp.asarray(t.numpy()) for t in x))
        if isinstance(x, tp.PreintState) else jnp.asarray(x.numpy())
        for x in d))


@pytest.mark.parametrize("name", ics.CPU_SCENES)
def test_plain_chain_lm_matches_jax(name):
    d = ics.scene(name)
    want, cost_j = map(np.asarray, jg.optimize_imu_chain(_jax_chain(d),
                                                         ITERATIONS))
    acc = []
    got, cost_t = tg.optimize_imu_chain_reference(d, ITERATIONS, acc)
    got, cost_t = got.numpy(), float(cost_t)
    assert got.shape == want.shape and len(acc) == ITERATIONS
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if np.isnan(cost_j):
        assert np.isnan(cost_t) and not any(bool(a) for a in acc)
        np.testing.assert_array_equal(got, d.states.numpy())
    else:
        assert cost_t == pytest.approx(float(cost_j), rel=1e-4, abs=1e-4)
    if name == "near_pi_axis":     # H not finite: every step rejected
        assert not any(bool(a) for a in acc)
        np.testing.assert_array_equal(got, d.states.numpy())
    if name in ("full", "dbg_nonzero", "interior_masked", "reset"):
        assert all(bool(a) for a in acc)
        assert cost_t < float(tg._cost(d, d.states, tg._whitener(d))) * 1e-2
    if name == "interior_masked":  # the inactive state is pinned
        np.testing.assert_array_equal(got[7], d.states[7].numpy())


@pytest.mark.parametrize("name", ["full", "interior_masked", "no_preint",
                                  "dbg_nonzero", "k1"])
def test_plain_chain_blocks_match_jax(name):
    d = ics.scene(name)
    want = [np.asarray(a) for a in jax.tree.leaves(
        jg.chain_factor_blocks(_jax_chain(d), jnp.asarray(d.states.numpy())))]
    got = [t.numpy() for grp in tg.chain_factor_blocks_reference(d, d.states)
           for t in grp]
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and np.isfinite(a).all()
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale)


def _jax_buffer(kind):
    acc, gyr, dt, mask, ba, bg = ics.buffer_arrays(kind)
    m = np.ones(len(dt), bool) if mask is None else mask
    return [jnp.asarray(x) for x in (acc, gyr, dt, m, ba, bg)]


@pytest.mark.parametrize("kind", ["phase9", "cap64", "none_live"])
def test_plain_preintegrate_matches_jax(kind):
    acc, gyr, dt, m, ba, bg = _jax_buffer(kind)
    want = jp.preintegrate(acc, gyr, dt, m, ba, bg, ics.ACC_VAR, ics.GYR_VAR)
    got = tp.preintegrate_reference(*ics.buffer(kind), ics.ACC_VAR,
                                    ics.GYR_VAR)
    for f, a, b in zip(tp.PreintState._fields, got, want):
        a, b = a.numpy(), np.asarray(b)
        if f == "cov":
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-7 * max(np.abs(b).max(), 1e-30),
                err_msg=f)
        else:
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(
                a, b, atol=1e-7 if f == "dt" else 5e-6 * scale, rtol=0,
                err_msg=f)
    if kind == "none_live":
        assert float(got.dt) == 0.0 and torch.equal(got.dR, torch.eye(3))


@pytest.mark.parametrize("kind", ["phase9", "cap64", "none_live"])
def test_plain_propagate_states_matches_jax(kind):
    acc, gyr, dt, m, ba, bg = _jax_buffer(kind)
    R0 = ics.rot((0.1, -0.2, 0.7)).astype(np.float32)
    p0 = np.array([1.0, -2.0, 0.5], np.float32)
    v0 = np.array([1.2, 0.1, 0.0], np.float32)
    want = jp.propagate_states(
        jp.NavState(jnp.asarray(R0), jnp.asarray(p0), jnp.asarray(v0)), ba,
        bg, acc, gyr, dt, m, gravity=ics.G)
    tacc, tgyr, tdt, tm, tba, tbg = ics.buffer(kind)
    got = tp.propagate_states_reference(
        tp.NavState(*(torch.from_numpy(x) for x in (R0, p0, v0))), tba, tbg,
        tacc, tgyr, tdt, tm, gravity=ics.G)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    if kind == "none_live":
        assert torch.equal(got.R[-1], torch.from_numpy(R0))


# ---------------------------------------------- the loops they replaced

def _parent_chain_loop(d, iterations):
    """graph/imu_graph.py's optimize_imu_chain before the kernel."""
    K = d.states.shape[0]
    L = tg._whitener(d)
    active = d.state_mask.repeat_interleave(tg.STATE_DIM)
    pin = torch.where(active, 0.0, 1.0)
    states = d.states
    cost = tg._cost(d, states, L)
    lam = torch.tensor(1e-4, device=states.device)
    for _ in range(iterations):
        H, grad = tg._assemble(d, states, L)
        dg = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12)) + pin
        A = H / (dg[:, None] * dg[None, :]) + torch.diag(lam + pin)
        Lc, info = torch.linalg.cholesky_ex(A)
        dy = torch.cholesky_solve((-grad / dg)[:, None], Lc)[:, 0]
        dx = torch.where(active, dy / dg, 0.0)
        new_states = states + dx.reshape(K, tg.STATE_DIM)
        new_cost = tg._cost(d, new_states, L)
        accept = (info == 0) & (new_cost < cost)
        states = torch.where(accept, new_states, states)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-6),
                          torch.clamp(lam * 4.0, max=1e6))
    return states, cost


def _parent_preintegrate(acc, gyr, dt, mask, bias_acc, bias_gyr,
                         acc_noise_var, gyr_noise_var, int_noise_var=1e-8):
    """imu/preintegration.py's preintegrate before the kernel."""
    live = tp._live(mask, acc.shape[0])
    state = tp.PreintState.zero(bias_acc, bias_gyr, device=acc.device)
    if len(live) == 0:
        return state
    idx = torch.from_numpy(live).to(acc.device)
    dts = dt[idx]
    a, dRk, Jr, A_hat, noise, int_noise = tp._sample_terms(
        acc[idx], gyr[idx], dts, bias_acc, bias_gyr, acc_noise_var,
        gyr_noise_var, int_noise_var)
    for k in range(len(live)):
        state = tp._integrate(state, a[k], dts[k], dRk[k], Jr[k], A_hat[k],
                              noise[k], int_noise[k])
    return state


def _parent_propagate(nav, bias_acc, bias_gyr, acc, gyr, dt, mask,
                      gravity=9.80511):
    """imu/preintegration.py's propagate_states before the kernel."""
    n = acc.shape[0]
    live = set(tp._live(mask, n).tolist())
    g = torch.tensor([0.0, 0.0, -gravity], device=acc.device)
    a_c = acc - bias_acc
    w_c = gyr - bias_gyr
    dRs = tp.so3_exp(w_c * dt[:, None])
    out = []
    for k in range(n):
        if k in live:
            d = dt[k]
            acc_w = nav.R @ a_c[k] + g
            nav = tp.NavState(R=nav.R @ dRs[k],
                              p=nav.p + nav.v * d + 0.5 * acc_w * d * d,
                              v=nav.v + acc_w * d)
        out.append(nav)
    return tp.NavState(*(torch.stack(f) for f in zip(*out)))


def _equal(a, b):
    return all(torch.equal(x, y) or (torch.isnan(x).any() and torch.equal(
        torch.isnan(x), torch.isnan(y)) and torch.equal(
        torch.nan_to_num(x), torch.nan_to_num(y))) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["full", "interior_masked", "nan_cov"])
def test_plain_loops_are_the_parent_loops_bitwise(name):
    d = ics.scene(name)
    want = _parent_chain_loop(d, ITERATIONS)
    assert _equal(tg.optimize_imu_chain_reference(d, ITERATIONS), want)
    # the dispatch on CPU tensors: the plain version, the same bits
    assert _equal(tg.optimize_imu_chain(d, ITERATIONS), want)
    for a, b in zip(tg.chain_factor_blocks(d, d.states),
                    tg.chain_factor_blocks_reference(d, d.states)):
        assert _equal(a, b)
    kind = {"full": "phase9", "interior_masked": "cap64"}.get(name,
                                                              "none_live")
    buf = ics.buffer(kind)
    want = _parent_preintegrate(*buf, ics.ACC_VAR, ics.GYR_VAR)
    assert _equal(tp.preintegrate_reference(*buf, ics.ACC_VAR, ics.GYR_VAR),
                  want)
    assert _equal(tp.preintegrate(*buf, ics.ACC_VAR, ics.GYR_VAR), want)
    acc, gyr, dt, m, ba, bg = buf
    nav = tp.NavState.identity(device="cpu")
    want = _parent_propagate(nav, ba, bg, acc, gyr, dt, m, gravity=ics.G)
    assert _equal(tp.propagate_states_reference(nav, ba, bg, acc, gyr, dt, m,
                                                gravity=ics.G), want)
    assert _equal(tp.propagate_states(nav, ba, bg, acc, gyr, dt, m,
                                      gravity=ics.G), want)


def test_dispatch_rejects_what_it_cannot_run():
    d = ics.scene("full")
    meta = tg.ImuChainData(*(
        tp.PreintState(*(t.to("meta") for t in x))
        if isinstance(x, tp.PreintState) else x.to("meta") for x in d))
    with pytest.raises(ValueError, match="unsupported device"):
        tg.optimize_imu_chain(meta, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tg.chain_factor_blocks(meta, meta.states)
    acc, gyr, dt, m, ba, bg = (None if t is None else t.to("meta")
                               for t in ics.buffer("cap64"))
    with pytest.raises(ValueError, match="unsupported device"):
        tp.preintegrate(acc, gyr, dt, m, ba, bg, 1e-4, 1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        tp.propagate_states(tp.NavState.identity(device="meta"), ba, bg,
                            acc, gyr, dt, m)
    # the kernel's contract, checked before a launch
    tg._check_chain(d)
    with pytest.raises(ValueError, match="state_mask"):
        tg._check_chain(d._replace(state_mask=d.state_mask.int()))
    with pytest.raises(ValueError, match="preint.cov"):
        tg._check_chain(d._replace(preint=d.preint._replace(
            cov=d.preint.cov[:, :6])))
    with pytest.raises(ValueError, match="gravity"):
        tg._check_chain(d._replace(gravity=d.gravity[None]))
    # every window size needs the solve's global scratch, whole
    K = d.states.shape[0]
    with pytest.raises(ValueError, match="scratch"):
        kernels.launch_imu_chain_lm(d, 4, None, None, None, None)
    with pytest.raises(ValueError, match="scratch"):
        kernels.launch_imu_chain_lm(d, 4, None, None, None, torch.empty(
            kernels.imu_chain_floats(K) - 1))
    with pytest.raises(ValueError, match="dt"):
        tp._samples(*ics.buffer("cap64")[:2], ics.buffer("cap64")[2][:5])
    with pytest.raises(ValueError, match="mask"):
        tp._device_mask(np.ones(5, bool), 6, torch.device("cpu"))


def _first_step(d, lam=1e-4):
    """The scaled, damped matrix and right-hand side of the chain LM's
    first step (`optimize_imu_chain_reference`'s), float32 numpy."""
    L = tg._whitener(d)
    H, grad = tg._assemble(d, d.states, L)
    pin = torch.where(d.state_mask.repeat_interleave(tg.STATE_DIM), 0.0,
                      1.0)
    dg = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12)) + pin
    A = H / (dg[:, None] * dg[None, :]) + torch.diag(lam + pin)
    return A.numpy(), (-grad / dg).numpy()


def _chain_factor(A, b, S=15):
    """csrc/imu_chain_lm.cu's chain_factor (the forward solve inside) and
    chain_backward_warp, transcribed: block k's step factors the panel
    [A_kk; A_k+1,k] column by column (each row's entries, b's too, updated
    in column order), then the Schur update of A_k+1,k+1, each entry's 15
    subtractions in column order; the backward solve over the band.  (A
    with L in its band, x, failed)."""
    A, b = A.copy(), b.copy()
    D = len(A)
    for lo in range(0, D, S):
        hi = lo + S
        for c in range(lo, hi):
            p = A[c, c]
            if not p > 0:
                return A, None, True
            rows = np.arange(c + 1, min(hi + S, D))
            l = np.sqrt(p)
            y = b[c] / l
            col = A[rows, c] / l
            A[rows, c] = col
            A[c, c] = l
            b[c] = y
            b[rows] = b[rows] - col * y
            for u, r in enumerate(rows):
                cols = np.arange(c + 1, min(r, hi - 1) + 1)
                A[r, cols] = A[r, cols] - col[u] * A[cols, c]
        for i in range(hi, min(hi + S, D)):
            for j in range(hi, i + 1):
                v = A[i, j]
                for c in range(lo, hi):
                    v = v - A[i, c] * A[j, c]
                A[i, j] = v
    for k in range(D - 1, -1, -1):
        x = b[k] / A[k, k]
        b[k] = x
        lo = max(S * (k // S - 1), 0)
        b[lo:k] = b[lo:k] - A[k, lo:k] * x
    return A, b, False


def _band(D, S=15):
    i = np.arange(D)[:, None]
    j = np.arange(D)[None, :]
    return (j <= i) & (j >= S * np.maximum(i // S - 1, 0))


@pytest.mark.parametrize("name", ["full", "reset", "interior_masked", "k1",
                                  "pitch_half_pi"])
def test_chain_block_factor_is_the_dense_one_bitwise(name):
    """The chain kernel's block steps (a panel a block, then the Schur
    update) give the dense right-looking Cholesky's bits: L in the band,
    exact zeros outside it, and the step."""
    from test_torch_pose_graph_lm import _dense_factor
    A, b = _first_step(ics.scene(name))
    Ad, xd, fd = _dense_factor(A, b)
    Ac, xc, fc = _chain_factor(A, b)
    assert not fd and not fc
    band = _band(len(A))
    np.testing.assert_array_equal(Ac[band], Ad[band])
    assert np.all(Ad[np.tril(np.ones_like(band)) & ~band] == 0.0)
    np.testing.assert_array_equal(xc, xd)
    assert np.all(np.isfinite(xc))


@pytest.mark.parametrize("name", ["nan_cov", "near_pi_axis"])
def test_chain_block_factor_fails_as_the_dense_one(name):
    """A non-finite H (every step rejected, in the GPU tests): the block
    steps fail as the dense factorization does."""
    from test_torch_pose_graph_lm import _dense_factor
    A, b = _first_step(ics.scene(name))
    assert not np.all(np.isfinite(A))
    with np.errstate(all="ignore"):
        assert _dense_factor(A, b)[2] and _chain_factor(A, b)[2]
