"""Rehearse chip_smoke.py's phase 10 on the CPU, and hold its alignments
against the JAX package's.

    python tests/rehearse_phase10.py kitti          # phase 10 (a)-(c)
    python tests/rehearse_phase10.py multisession   # phase 10 (d)
    python tests/rehearse_phase10.py jax            # the JAX package on
                                                    # the same inputs

`kitti` and `multisession` run `chip_smoke.kitti_phase` /
`multisession_phase` on the CPU (the kernels' plain versions, counted as
launches by wrappers around `ops.fetch.block_fetch` / `resident_fetch`,
`ops.rounds_gn.rounds_gn`, `ops.knn.knn`, `ops.icp.icp_align` and
`graph.pose_graph.optimize_pose_graph` (one route-A launch a solve) /
`graph_factor_blocks`)
with `Params`' registration grid at +-(40, 40, 9) m instead of +-(60, 60,
25) m: a whole number of 2 m cells off the default, so every table holds
the same points in the same cells (the same poses) at a size a CPU host
builds quickly.  `jax` runs phase 10 (d)'s two SLAM sessions with the port
on the CPU, then `align_sessions` of both packages on those same sessions
(ICP alone, and coarse with keys / seeds 0-3), and the JAX package's
`examples/run_kitti.py` on the first 6 scans of phase 10's generated drive.
Run from the repository's root; `jax` needs the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
HALF = (40.0, 40.0, 9.0)


def cpu_params():
    """Replace the port's Params with one whose default grid is HALF."""
    import feature_base_pointcloud_registration_tpu_torch as port
    from feature_base_pointcloud_registration_tpu_torch import config

    @dataclasses.dataclass(frozen=True)
    class Params(config.Params):
        register_grid_half_extent: tuple = HALF

    config.Params = port.Params = Params
    return Params


def counted_fetches():
    """Count the plain fetches, GN rounds, k-NN calls and ICP runs as
    chip_smoke counts kernel launches."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fetch, fpfh, icp, knn, register, rounds_gn)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        multisession, slam)

    def counting(real):
        def f(*a, **kw):
            f.launches += 1
            return real(*a, **kw)
        f.launches = 0
        return f

    for name in ("block_fetch", "resident_fetch"):
        setattr(fetch, name, counting(getattr(fetch, name)))
    rounds_gn.rounds_gn = register.rounds_gn = counting(rounds_gn.rounds_gn)
    knn.knn = fpfh.knn = register.knn = counting(knn.knn)
    icp.icp_align = slam.icp_align = multisession.icp_align = counting(
        icp.icp_align)
    # the pose-graph LM: every solve counted as one route-A launch
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        pose_graph)
    lm = counting(pose_graph.optimize_pose_graph_reference)
    lm.launches_b = 0
    pose_graph.optimize_pose_graph = slam.optimize_pose_graph = \
        multisession.optimize_pose_graph = lm
    blocks = counting(pose_graph.graph_factor_blocks)
    pose_graph.graph_factor_blocks = blocks


def offset_error(T, true_ab):
    e = T @ np.linalg.inv(true_ab) - np.eye(4)
    return float(np.abs(e[:3, 3]).max()), float(np.abs(e[:3, :3]).max())


def jax_comparison(cpu):
    import jax

    from feature_base_pointcloud_registration_tpu.pipeline import (
        multisession as jms)
    from feature_base_pointcloud_registration_tpu_torch.examples import (
        run_kitti, run_multisession as rms)
    from feature_base_pointcloud_registration_tpu_torch.io import (
        kitti, kitti_drive)
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, pose6_to_matrix_np)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        multisession as tms)

    Params = cpu_params()
    params = Params(map_corner_cap=8192, map_surf_cap=65536)
    world = SyntheticWorld()
    sa, sb = (tms.session_from_pipeline(
        rms.run_session(params, world, fn, 10, seed0=s0, device=cpu))
        for fn, s0 in ((rms.track_a, 100), (rms.track_b, 500)))
    true_ab = (np.linalg.inv(pose6_to_matrix_np(rms.track_a(0)))
               @ pose6_to_matrix_np(rms.track_b(0)))
    ja, jb = jms.Session(*sa), jms.Session(*sb)
    print("align_sessions on phase 10 (d)'s sessions, offset error (m, "
          "rotation) and fitness:")
    for name, fn in (
            ("JAX ICP alone", lambda: jms.align_sessions(
                jax.random.PRNGKey(0), ja, jb, coarse=False)),
            ("port ICP alone", lambda: tms.align_sessions(
                None, sa, sb, coarse=False, device=cpu))):
        r = fn()
        print(f"  {name}: {offset_error(r.transform, true_ab)} "
              f"{r.fitness:.4f}", flush=True)
    for seed in range(4):
        rj = jms.align_sessions(jax.random.PRNGKey(seed), ja, jb)
        rt = tms.align_sessions(torch.Generator().manual_seed(seed), sa, sb,
                                device=cpu)
        print(f"  coarse, JAX key {seed}: "
              f"{offset_error(rj.transform, true_ab)}; port CPU seed "
              f"{seed}: {offset_error(rt.transform, true_ab)}", flush=True)
    with tempfile.TemporaryDirectory() as drive:
        kitti_drive.make_drive(drive, n_scans=6)
        gt = kitti.load_oxts_poses(os.path.join(drive, "oxts"))
        still = run_kitti.chained_ate(np.zeros((6, 3)), gt)
        # HOME in the drive's directory: the example's compile cache goes
        # there and goes with it
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "examples", "run_kitti.py"),
             "--data", drive, "--scans", "6"], capture_output=True,
            text=True, check=True,
            env=dict(os.environ, JAX_PLATFORMS="cpu", HOME=drive)).stdout
        print("the JAX package's examples/run_kitti.py on the generated "
              f"drive's first 6 scans (standing still: ATE {still:.4f} m):")
        print("  " + "\n  ".join(out.strip().splitlines()[-6:]))


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "kitti"
    torch.set_num_threads(4)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    if which == "jax":
        jax_comparison(cpu)
    else:
        cpu_params()
        import chip_smoke

        counted_fetches()
        torch.cuda.synchronize = lambda *a, **kw: None
        phase = {"kitti": chip_smoke.kitti_phase,
                 "multisession": chip_smoke.multisession_phase}[which]
        print(phase(cpu))
    print(f"elapsed {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
