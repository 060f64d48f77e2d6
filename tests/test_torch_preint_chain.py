"""The walk orders of csrc/preintegration.cu, transcribed in numpy float32
(tests/preint_chain.py), held bit for bit to each other; no JAX.

  * the redesign's preintegration order (chunks of 32 slots compacted by
    the mask, the dR and dR_dbg chains split off, the per-sample terms,
    cov on A's structure with the dense step where the flag is off or T1
    is not finite) bit for bit the parent kernel's (chunks of 128, three
    stages a step, every 9x9 product over all nine terms) on every leaf,
    on tests/imu_chain_scenes.py's buffers and edge buffers (one live
    sample, none, a masked first and last slot, dt 0, a rotation near pi,
    97 slots, an accel that overflows cov, a dt that overflows B);
  * the dense step runs only where a skipped zero would meet a term that is
    not finite (never on the finite buffers);
  * the parent's order held to `preintegrate_reference` by
    imu_chain_scenes.preint_agreement on the finite buffers, and with the
    same non-finite entries on the others;
  * the propagation's two walks bit for bit each other, and the parent's
    against `propagate_states_reference`: within 1e-5 of max(1, the leaf's
    largest entry) up to imu_chain_scenes.PREINT_SHORT live samples (the
    bound of chip_smoke.py's propagation probe); above, as near a float64
    run of the plain version as the plain version is, within a factor of 2
    (the CPU's matmul rounds its own way: on the 1024-slot buffer the
    transcription is 3.0e-06, 2.9e-06, 6.5e-06 of max(1, largest) from
    float64 in R, p, v, the plain version 3.4e-06, 4.1e-06, 6.7e-06, and
    the two 1.1e-05 apart in v).
"""

import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu_torch.imu import (
    preintegration as tp)

import imu_chain_scenes as ics
import preint_chain as pc

KINDS = ics.BUFFERS + ics.EDGE_BUFFERS
NAV = (ics.rot((0.1, -0.2, 0.7)).astype(np.float32),
       np.array([1.0, -2.0, 0.5], np.float32),
       np.array([1.2, 0.1, 0.0], np.float32))


def _args(kind):
    return (*ics.buffer_arrays(kind), ics.ACC_VAR, ics.GYR_VAR)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_split_order_is_the_parent_bitwise(kind):
    want = pc.preint_parent(*_args(kind))
    got, dense = pc.preint_split(*_args(kind))
    for leaf in pc.LEAVES:
        assert np.array_equal(_bits(got[leaf]), _bits(want[leaf])), leaf
    if kind in ics.NONFINITE_BUFFERS:
        assert dense > 0 and not np.isfinite(want["cov"]).all()
    else:
        assert dense == 0 and np.isfinite(want["cov"]).all()


@pytest.mark.parametrize("kind", KINDS)
def test_parent_order_is_the_plain_version(kind):
    args = _args(kind)
    targs = tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                  for x in args)
    want = tp.preintegrate_reference(*targs)
    got = tp.PreintState(**{k: torch.from_numpy(v) for k, v in
                            pc.preint_parent(*args).items()})
    if kind in ics.NONFINITE_BUFFERS:
        for f, a, b in zip(got._fields, got, want):
            assert torch.equal(torch.isfinite(a), torch.isfinite(b)), f
        return
    ok, rep = ics.preint_agreement(got, want, targs, {})
    assert ok, rep


@pytest.mark.parametrize("kind", KINDS)
def test_propagation_orders(kind):
    acc, gyr, dt, mask, ba, bg = ics.buffer_arrays(kind)
    args = (NAV, ba, bg, acc, gyr, dt, mask, ics.G)
    want = pc.propagate_parent(*args)
    got = pc.propagate_warp(*args)
    for a, b in zip(got, want):
        assert np.array_equal(_bits(a), _bits(b))
    ref = _plain_propagation(args)
    live = acc.shape[0] if mask is None else int(mask.sum())
    exact = _plain_propagation(args, torch.float64) \
        if live > ics.PREINT_SHORT else None
    for a, b, e in zip(want, ref, exact or ref):
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin)
        if not fin.any():
            continue
        if exact is None:
            tol = 1e-5 * max(1.0, float(np.abs(b[fin]).max()))
            assert float(np.abs(a[fin] - b[fin]).max()) <= tol
        else:
            scale = max(1.0, float(np.abs(e).max()))
            mine = float(np.abs(a - e).max()) / scale
            plain = float(np.abs(b - e).max()) / scale
            assert mine <= 2 * plain, (mine, plain)


def _plain_propagation(args, dtype=torch.float32):
    """propagate_states_reference on the CPU in dtype: (R, p, v) numpy."""
    nav, ba, bg, acc, gyr, dt, mask, gravity = args

    def t(x):
        return torch.from_numpy(x).to(dtype)

    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        out = tp.propagate_states_reference(
            tp.NavState(*(t(x) for x in nav)), t(ba), t(bg), t(acc), t(gyr),
            t(dt), mask, gravity=gravity)
    finally:
        torch.set_default_dtype(old)
    return tuple(x.numpy() for x in out)
