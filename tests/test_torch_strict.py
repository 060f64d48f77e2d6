"""Port parity: strict feature picking (`ops/features.py`, strict=True).

Bitwise throughout: strict picking is the reference's serialized stream bit
for bit in the JAX package, and the port's must give the same picks.

  * multi-ring scans (tests/test_features.py's strict multi-ring scenes:
    noisy scans with randomly truncated rings): the port's labels equal the
    JAX package's `_window_labels(strict=True)` on the JAX package's cloud,
    run eagerly as the JAX suite runs it (under jit, XLA's CPU backend
    computes the curvature sums in another order: ROADMAP Queue 3), and the
    corner picks and surface candidates on the port's own cloud equal the
    serial NumPy oracle's (tests/oracle.py) as index sets;
  * the reference-stream ring data of tests/test_features.py (random
    curvature with exact ties and flat runs, pre-suppressed points, uneven
    sectors; tests/pick_windows.py): labels equal JAX
    `_ring_pick(strict=True)`;
  * the stride-6 fast-forward is a pure acceleration: with and without it
    the labels are equal (and equal JAX's) on flat runs, ramps and ties.

`process_scan(Params())` (strict) against the JAX package's is in
tests/test_torch_frontend.py.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
import pick_windows
from feature_base_pointcloud_registration_tpu.config import Params
from feature_base_pointcloud_registration_tpu.io.synthetic import (
    SyntheticWorld, simulate_scan)
from feature_base_pointcloud_registration_tpu.ops import features as jfeat
from feature_base_pointcloud_registration_tpu.ops.projection import (
    project_scan)
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    RawScan)
from feature_base_pointcloud_registration_tpu_torch.convert import (
    to_numpy, to_torch)
from feature_base_pointcloud_registration_tpu_torch.ops import (
    features as tfeat, projection as tproj)
from test_torch_batch import one_torch_thread  # noqa: F401

PARAMS = Params()
MARGIN = 8


def _multi_ring_scan(seed):
    """tests/test_features.py::test_strict_multi_ring_bit_exact_vs_oracle's
    scan for `seed`: noise 0.02 and five rings cut at random spans."""
    s = simulate_scan(SyntheticWorld(), [0.02, -0.01, 0.3 + 0.5 * seed,
                                         1.0, 2.0, 0.0], seed=seed,
                      noise=0.02)
    r = np.random.RandomState(seed + 100)
    valid = np.array(s["valid"])
    ring = s["ring"]
    for rr in r.choice(16, 5, replace=False):
        a0 = r.randint(0, 1700)
        span = r.randint(50, 900)
        col = np.arange(len(ring)) % 1800
        valid &= ~((ring == rr) & (col >= a0) & (col < a0 + span))
    return RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"],
                              s["time"])._replace(valid=jnp.asarray(valid))


def _batch(cloud):
    return to_torch(jax.tree.map(lambda a: np.asarray(a)[None], cloud),
                    device="cpu")


@pytest.mark.parametrize("seed", range(6))
def test_strict_labels_multi_ring(seed):
    raw = _multi_ring_scan(seed)
    cloud = project_scan(PARAMS, raw, None)
    _, jlabel, jspan, _ = jfeat._window_labels(
        cloud, jnp.float32(PARAMS.edge_threshold),
        jnp.float32(PARAMS.surf_threshold), n_scan=PARAMS.n_scan,
        horizon_scan=PARAMS.horizon_scan, sector_cap=PARAMS.sector_cap,
        strict=True)
    win, label, span, _ = tfeat.window_labels(PARAMS, _batch(cloud))
    np.testing.assert_array_equal(label[0].numpy(), np.asarray(jlabel))
    np.testing.assert_array_equal(span[0].numpy(), np.asarray(jspan))

    # the port's own cloud against the serial oracle, in flat index space
    tcloud = to_numpy(tproj.project_scan(
        PARAMS, to_torch(jax.tree.map(lambda a: np.asarray(a)[None], raw),
                         device="cpu")))
    win, label, span, ring_first = tfeat.window_labels(
        PARAMS, to_torch(tcloud, device="cpu"))
    num = int(tcloud.num_points[0])
    ref = oracle.extract_features(dict(
        point_range=tcloud.point_range[0, :num],
        point_col_ind=tcloud.point_col_ind[0, :num],
        start_ring_index=tcloud.start_ring_index[0],
        end_ring_index=tcloud.end_ring_index[0],
        points=tcloud.points[0, :num]), PARAMS.edge_threshold,
        PARAMS.surf_threshold)
    label, pvalid = label[0].numpy(), win["pvalid"][0].numpy()
    surf = span[0].numpy() & (label <= 0) & pvalid
    flat = ring_first[0].numpy()[:, None] - MARGIN + np.arange(
        label.shape[1])
    got_corner = set(flat[(label == 1) & pvalid].tolist())
    got_surf = set(flat[surf].tolist())
    assert got_corner == {i for idx in ref["corner_idx"] for i in idx}
    assert got_surf == {i for idx in ref["surf_idx"] for i in idx}
    assert len(got_corner) > 100


# the picking alone (its inputs are the curvatures, so jit changes nothing)
_jax_ring_pick = jax.jit(functools.partial(
    jfeat._ring_pick, sector_cap=304, edge_threshold=1.0, surf_threshold=0.1,
    strict=True))


def _pick_both(window, stride=True):
    """(port labels, JAX labels) of one ring window."""
    jlabel, _ = _jax_ring_pick({k: jnp.asarray(v) for k, v in
                                window.items()})
    twin = {k: torch.from_numpy(np.asarray(v))[None, None]
            for k, v in window.items()}
    label, _ = tfeat._pick(twin, 1.0, 0.1, strict=True, stride=stride)
    return label[0, 0].numpy(), np.asarray(jlabel)


@pytest.fixture(scope="module")
def stream_windows():
    return pick_windows.stream_windows()


@pytest.mark.parametrize("trial", range(pick_windows.N_STREAM))
def test_strict_pick_reference_stream(stream_windows, trial):
    got, want = _pick_both(stream_windows[trial])
    np.testing.assert_array_equal(got, want)
    assert (got == 1).any() and (got == -1).any()


@pytest.mark.parametrize("trial", range(pick_windows.N_STRIDE))
def test_mis_stride_on_off_equal(trial):
    window = pick_windows.stride_window(trial)
    on, want = _pick_both(window, stride=True)
    off, _ = _pick_both(window, stride=False)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, want)
    assert (on == -1).sum() > 20

