"""Rehearse chip_smoke.py's phase 11 on the CPU, and hold its fast-grid
solve against the JAX package's.

    python tests/rehearse_phase11.py port   # phase 11 (a)-(e) at B=8
    python tests/rehearse_phase11.py jax    # JAX batch_register_fast_grid
                                            # on (d)'s inputs (~8 min)

`port` builds phase 3's inputs (the bench's scans, guesses and map, its
frontend and tables, phase 6's `batch_register_pallas` poses and the NumPy
oracle on 8 scans) for the first 8 of the card's 256 scans and runs
`chip_smoke.sharded_phase` on the CPU:
a gloo group in place of NCCL, CPU meshes, the kernels' plain versions
counted as launches by wrappers, host clocks in place of CUDA events, and
(e) as a 1-rank gloo dry run; `batch_register_fast` runs on 4 scans.
`jax` runs the JAX package's `batch_register_fast_grid` on (d)'s inputs
(the same 8 scans, the packed 1 m tables at cap 48) and prints its ATE
against the oracle beside the port's.  Run from the repository's root;
`jax` needs the JAX package.
"""

from __future__ import annotations

import os
import sys
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
B = 8


def bench(cs):
    """Phase 3's inputs at B scans on the CPU, as chip_smoke.main makes
    them, in the namespace sharded_phase takes (counts left to the
    caller)."""
    import oracle

    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, build_feature_map, simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.ops.features import (
        extract_features)
    from feature_base_pointcloud_registration_tpu_torch.ops.projection import (  # noqa: E501
        project_scan)
    from feature_base_pointcloud_registration_tpu_torch.parallel import (
        batch as pb)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        FeatureMap, RawScan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (  # noqa: E501
        downsample_features)

    params = Params(map_corner_cap=16384, map_surf_cap=65536,
                    strict_feature_pick=False)
    world = SyntheticWorld()
    # the card's random stream (cs.B scans, then their guesses); the first
    # B scans simulated: the same inputs as the card's first B lanes
    rng = np.random.RandomState(0)
    gt = np.stack([np.array([0, 0, rng.uniform(-1, 1), rng.uniform(-6, 6),
                             rng.uniform(-6, 6), 0.0], np.float32)
                   for _ in range(cs.B)])
    guesses = (gt + rng.uniform(-1, 1, (cs.B, 6)).astype(np.float32)
               * np.array([0.02, 0.02, 0.05, 0.3, 0.3, 0.1], np.float32))[:B]
    raws = []
    for i in range(B):
        s = simulate_scan(world, gt[i], seed=i)
        raws.append((s["xyz"], s["intensity"], s["ring"], s["time"],
                     s["valid"]))
    raw = RawScan(*(torch.from_numpy(np.stack(a)) for a in zip(*raws)))
    g = torch.from_numpy(guesses)
    mcx, mcm, msx, msm = build_feature_map(world, params.map_corner_cap,
                                           params.map_surf_cap)
    fmap = FeatureMap(*(torch.from_numpy(a) for a in (mcx, mcm, msx, msm)))
    center = np.array([0.0, 0.0, (world.ground_z + world.ceil_z) / 2],
                      np.float32)
    half = np.array([world.half_x + 1, world.half_y + 1,
                     (world.ceil_z - world.ground_z) / 2 + 1], np.float32)
    feats = downsample_features(params, extract_features(
        params, project_scan(params, raw), strict=False))
    caps = dict(corner_cell_cap=cs.CCAP, surf_cell_cap=cs.SCAP)
    tabs = pb.build_map_planar_tables(fmap, center, half, **caps)
    rtabs = pb.build_map_planar_tables(fmap, center, half, resident=True,
                                       **caps)
    stat, _ = pb.initial_state(feats, g)
    q = pb.fetch_queries(stat[:, :6], feats.surf_xyz, feats.surf_mask,
                         tabs[1], tabs[2], 2.0, tabs[3])
    fe = [a.numpy() for a in feats]
    mc, ms = mcx[mcm], msx[msm]
    oracle_poses = np.stack([
        oracle.register_scan(fe[0][i][fe[1][i]], fe[2][i][fe[3][i]], mc, ms,
                             guesses[i])[0] for i in range(cs.N_ORACLE)])

    def ate_oracle_of(poses):
        d = poses[:cs.N_ORACLE, 3:] - oracle_poses[:len(poses), 3:]
        return float(np.sqrt((d ** 2).sum(-1).mean()))

    pose6 = pb.batch_register_pallas(
        feats, rtabs[0], rtabs[1], rtabs[2], g, grid_dims=rtabs[3],
        num_rounds=2, iters_per_round=cs.ITERS, num_candidates=cs.K,
        **caps).pose6.numpy()
    print(f"phase 6 ate_vs_oracle_m {ate_oracle_of(pose6)}", flush=True)
    return types.SimpleNamespace(
        feats=feats, guesses=g, fmap=fmap, center=center, half=half,
        tabs=tabs, rtabs=rtabs, queries_surf=q, ate_oracle_of=ate_oracle_of,
        oracle_poses=oracle_poses, pose6=pose6, gpu="CPU rehearsal")


def rehearse_port(cs):
    import torch.distributed as dist

    from feature_base_pointcloud_registration_tpu_torch.ops import (
        features, fetch, register)
    from feature_base_pointcloud_registration_tpu_torch.parallel import (
        batch as pb, dryrun, map_sharded as pms)

    ns = bench(cs)
    cs.B, cs.N_FAST = B, 4
    torch.cuda.set_device = lambda dev: None
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0

    class Event:
        def __init__(self, **kw):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    def host_ms(fn, reps, graph=False):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps

    torch.cuda.Event = Event
    cs.cuda_ms = host_ms
    init = dist.init_process_group
    dist.init_process_group = lambda backend, **kw: init("gloo", **kw)
    mesh = pb.init_mesh
    pb.init_mesh = pms.init_mesh = lambda dt, shape, names: mesh(
        "cpu", shape, names)
    gloo_dryrun = dryrun.dryrun_multichip
    dryrun.dryrun_multichip = lambda n, backend="gloo": gloo_dryrun(n)

    counts = {"block_fetch": 0, "resident_fetch": 0, "gn_round": 0,
              "ring_pick": 0, "rounds_gn": 0}

    def counting(mod, name):
        real = getattr(mod, name)

        def f(*a, **kw):
            counts[name] += 1
            return real(*a, **kw)
        setattr(mod, name, f)

    counting(fetch, "block_fetch")
    counting(fetch, "resident_fetch")
    counting(pb, "gn_round")
    counting(features, "ring_pick")
    counting(register, "rounds_gn")

    def zero_counts():
        for k in counts:
            counts[k] = 0

    def read_counts(phase, want):
        print(f"phase {phase} launches: {counts}", flush=True)
        if counts != want:
            raise AssertionError(f"phase {phase} launches {counts}, want "
                                 f"{want}")
        return dict(counts)

    ns.zero_counts, ns.read_counts = zero_counts, read_counts
    print(cs.sharded_phase(torch.device("cpu"), ns), flush=True)


def rehearse_jax(cs):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from feature_base_pointcloud_registration_tpu.ops import hashgrid as jh
    from feature_base_pointcloud_registration_tpu.parallel import batch as jb
    from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
        FeatureMap, ScanFeatures)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        hashgrid as th)
    from feature_base_pointcloud_registration_tpu_torch.parallel import (
        batch as pb)

    ns = bench(cs)
    cap = cs.FAST_GRID_CAP
    dims = th.default_grid_spec(ns.half, 1.0)
    org = th.grid_origin(ns.center, ns.half, device="cpu")
    port = [th.build_grid_packed(x, m, org, 1.0, dims=dims, cell_cap=cap)
            for x, m in ((ns.fmap.corner_xyz, ns.fmap.corner_mask),
                         (ns.fmap.surf_xyz, ns.fmap.surf_mask))]
    res = pb.batch_register_fast_grid(ns.feats, ns.fmap, port[0], port[1],
                                      org, ns.guesses, grid_dims=dims,
                                      cell_size=1.0, cell_cap=cap)
    jf = ScanFeatures(*(jnp.asarray(a.numpy()) for a in ns.feats))
    jm = FeatureMap(*(jnp.asarray(a.numpy()) for a in ns.fmap))
    jorg = jnp.asarray(org.numpy())
    tabs = [jh.build_grid_packed(x, m, jorg, 1.0, dims=dims, cell_cap=cap)
            for x, m in ((jm.corner_xyz, jm.corner_mask),
                         (jm.surf_xyz, jm.surf_mask))]
    t = time.perf_counter()
    want = jb.batch_register_fast_grid(
        jf, jm, tabs[0], tabs[1], jorg, jnp.asarray(ns.guesses.numpy()),
        grid_dims=dims, cell_size=1.0, cell_cap=cap)
    pose = np.asarray(want.pose6)
    print(f"batch_register_fast_grid B={B}: ate_vs_oracle_m JAX "
          f"{ns.ate_oracle_of(pose)} port "
          f"{ns.ate_oracle_of(res.pose6.numpy())}; iterations JAX "
          f"{np.asarray(want.iterations).tolist()} port "
          f"{res.iterations.tolist()}; pose |diff| "
          f"{np.abs(pose - res.pose6.numpy()).max():.3e}; JAX "
          f"{time.perf_counter() - t:.1f} s", flush=True)


def main():
    import chip_smoke as cs

    torch.set_num_threads(4)
    {"port": rehearse_port, "jax": rehearse_jax}[sys.argv[1]](cs)


if __name__ == "__main__":
    main()
