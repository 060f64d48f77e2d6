"""Import guard: the PyTorch port runs on a machine without JAX.

A fresh interpreter blocks `jax`, `jaxlib` and the JAX package
(`sys.modules[name] = None` makes any import of them raise), imports every
module of the port, runs `project_scan` on a tiny CPU batch, and runs the
localization path at a small size: strict picking, deskew and one
`LocalizationPipeline.step` against a map loaded through `write_pcd` and
`GlobalMap.from_pcd_dir`; then `icp_align` and two `SlamPipeline.step`s
(the first saves a keyframe and solves its graph, the second registers on
the local map built from it) and `save_map`; then the LIO topology: four
clouds and the raw IMU between them through `LioTopology`, whose buffer
emits two steps (the IMU chain corrected after each), a checkpoint of its
SLAM state saved and loaded, and one EKF update and GPS fix; then FPFH and
RANSAC on a tiny cloud, `load_scan` on tests/data/kitti_mini and a
one-link `merge_sessions` of the SLAM run's session with itself; then one
`batch_register_rounds` solve on `build_map_grids`' tables and a one-rank
gloo group (a `FileStore`) running `shard_register_tables(solver="blocks")`.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "feature_base_pointcloud_registration_tpu"):
    sys.modules[name] = None

import numpy as np
import torch
import feature_base_pointcloud_registration_tpu_torch as port

for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)

from feature_base_pointcloud_registration_tpu_torch import Params, RawScan
from feature_base_pointcloud_registration_tpu_torch.ops.projection import (
    project_scan)

params = Params(n_scan=2, horizon_scan=8)
r = np.random.RandomState(0)
xyz = r.uniform(-10, 10, (12, 3)).astype(np.float32)
raw = RawScan.from_numpy(xyz, np.ones(12), r.randint(0, 2, 12),
                         np.zeros(12), max_points=16,
                         device=torch.device("cpu"))
cloud = project_scan(params, RawScan(*(a[None] for a in raw)))
assert cloud.points.shape == (1, 16, 3), cloud.points.shape
assert 0 < int(cloud.num_points[0]) <= 12
import os, tempfile
from feature_base_pointcloud_registration_tpu_torch.io.pcd import write_pcd
from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
    SyntheticWorld, simulate_scan)
from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (
    make_deskew_info)
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    localization)
cpu = torch.device("cpu")
params = Params(n_scan=16, horizon_scan=360, map_corner_cap=2048,
                map_surf_cap=8192, local_map_half_extent=(10.0, 10.0, 6.0),
                register_grid_half_extent=(10.0, 10.0, 6.0))
world = SyntheticWorld()
s = simulate_scan(world, [0, 0, 0.2, 1.0, 0.5, 0], horizon_scan=360,
                  spin_rpy_rate=(0, 0, 0.3), vel_world=(1.0, 0, 0))
with tempfile.TemporaryDirectory() as d:
    for name, pts in (("cloudCorner.pcd", world.corner_map_points(0.5)),
                      ("cloudSurf.pcd", world.surf_map_points(1.0))):
        write_pcd(os.path.join(d, name), dict(x=pts[:, 0], y=pts[:, 1],
                                              z=pts[:, 2]))
    gm = localization.GlobalMap.from_pcd_dir(
        params, d, device=cpu, corner_cap=4096, surf_cap=8192)
dsk = make_deskew_info(params, np.linspace(-0.01, 0.11, 13),
                       np.tile([0, 0, 0.3], (13, 1)), 0.0, 0.1, device=cpu)
pipe = localization.LocalizationPipeline(params, gm)
assert params.strict_feature_pick
pose = pipe.step(RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"],
                                    s["time"], device=cpu), 0.0, dsk)
assert pose.shape == (6,) and np.isfinite(pose).all(), pose
assert bool(dsk.imu_available[0]) and pipe.last_result is not None
from feature_base_pointcloud_registration_tpu_torch.ops.icp import icp_align
from feature_base_pointcloud_registration_tpu_torch.pipeline.slam import (
    SlamPipeline)
src = torch.from_numpy(r.uniform(-2, 2, (64, 3)).astype(np.float32))
res = icp_align(src, torch.ones(64, dtype=torch.bool), src + 0.05,
                torch.ones(64, dtype=torch.bool), chunk=64)
assert bool(res.converged) and float(res.fitness) < 1e-4, res
slam = SlamPipeline(params, max_keyframes=4, opt_window=2, device=cpu)
for k in range(2):
    s = simulate_scan(world, [0, 0, 0.02 * k, 1.0 + 0.2 * k, 0.5, 0],
                      horizon_scan=360, seed=k)
    pose = slam.step(RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"],
                                        s["time"], device=cpu), 0.5 * k)
assert slam.n_keyframes == 1 and slam.last_result is not None
assert np.isfinite(pose).all(), pose
with tempfile.TemporaryDirectory() as d:
    slam.save_map(d)
    assert os.path.exists(os.path.join(d, "keyframes.npz"))
from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
    constant_twist_platform)
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    checkpoint, lio, navsat)
imu, states = constant_twist_platform(
    0.7, ext_rot=params.ext_rot, ext_rpy=params.ext_rpy,
    gravity=params.imu_gravity)
topo = lio.LioTopology(params, max_keyframes=4, imu_window=4,
                       imu_max_samples=32, device=cpu)
ests = []
for k in range(4):
    st = 0.2 * k
    batch = [b for b in imu if st - 0.2 < b[0] <= st]
    topo.handle_imu(*(np.stack([b[i] for b in batch]) for i in range(4)))
    _, R, p = states[int(round(st * 100))]
    rpy = [np.arctan2(R[2, 1], R[2, 2]), np.arcsin(-R[2, 0]),
           np.arctan2(R[1, 0], R[0, 0])]
    s = simulate_scan(world, np.concatenate([rpy, p]), horizon_scan=360,
                      seed=20 + k)
    ests.append(topo.handle_cloud(st, RawScan.from_numpy(
        s["xyz"], s["intensity"], s["ring"], s["time"], device=cpu)))
assert ests[0] is None and ests[1] is None, ests
assert all(np.isfinite(e).all() for e in ests[2:]), ests
assert topo.slam.n_keyframes >= 1 and topo.odo.system_initialized
with tempfile.TemporaryDirectory() as d:
    checkpoint.save_checkpoint(topo.slam, d)
    back = checkpoint.load_checkpoint(
        SlamPipeline(params, max_keyframes=4, device=cpu), d)
    assert back.n_keyframes == topo.slam.n_keyframes
ekf = navsat.EkfGps(device=cpu)
ekf.add_odometry(0.0, ests[-1])
fix = navsat.NavsatTransform(ekf).handle_fix(0.1, [1.0, 2.0, 0.0],
                                             [0.05, 0.05, 0.1])
assert np.isfinite(fix[0]).all()
from feature_base_pointcloud_registration_tpu_torch.io import kitti
from feature_base_pointcloud_registration_tpu_torch.ops import fpfh, ransac
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    multisession)
pts = torch.from_numpy(r.uniform(-2, 2, (64, 3)).astype(np.float32))
ones = torch.ones(64, dtype=torch.bool)
desc, dvalid = fpfh.fpfh(pts, ones, k=8, chunk=64)
assert desc.shape == (64, 33) and bool(dvalid.all())
fit = ransac.ransac_align(torch.Generator().manual_seed(0), pts, pts + 0.1,
                          dvalid, num_hypotheses=16, inlier_threshold=0.3)
assert torch.isfinite(fit.transform).all() and int(fit.inliers) == 64, fit
vdir = os.path.join("tests", "data", "kitti_mini", "velodyne_points", "data")
scan = kitti.load_scan(kitti.scan_files(vdir)[0], 512, device=cpu)
assert int(scan.valid.sum()) == 320, int(scan.valid.sum())
sess = multisession.session_from_pipeline(slam)
merged = multisession.merge_sessions(
    None, sess, sess, params=params, link_stride=1,
    transform_ab=np.eye(4, dtype=np.float32), device=cpu)
assert len(merged.links) == 1 and np.isfinite(merged.poses_b).all(), merged
import torch.distributed as dist
from feature_base_pointcloud_registration_tpu_torch.parallel import (
    batch as pbatch, dryrun)
feats, fmap, poses, center, half = dryrun.problem_1d(1, device=cpu)
ctab, stab, origin, dims = pbatch.build_map_grids(fmap, center, half)
res = pbatch.batch_register_rounds(feats, ctab, stab, origin, poses,
                                   grid_dims=dims, num_rounds=1,
                                   iters_per_round=3)
assert res.pose6.shape == (1, 6) and bool(torch.isfinite(res.pose6).all())
with tempfile.TemporaryDirectory() as d:
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), 1), rank=0, world_size=1)
    try:
        ctab, stab, origin, dims = pbatch.build_map_block_tables(
            fmap, center, half, corner_cell_cap=16, surf_cell_cap=32)
        res, stats = pbatch.shard_register_tables(
            pbatch.make_mesh("cpu"), feats, ctab, stab, origin, poses,
            grid_dims=dims, solver="blocks", corner_cell_cap=16,
            surf_cell_cap=32, num_rounds=1, iters_per_round=3)
    finally:
        dist.destroy_process_group()
assert int(stats["n_total"]) == 1 and res.pose6.shape == (1, 6), stats
loaded = sorted(k for k, v in sys.modules.items()
                if v is not None and (k.split(".")[0] in ("jax", "jaxlib")
                or k.startswith("feature_base_pointcloud_registration_tpu.")))
assert not loaded, loaded
print("NO_JAX_OK", int(cloud.num_points[0]))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
