"""Multi-rank dry run of the sharded solvers on torch.distributed.

The port's counterpart of `__graft_entry__.py::dryrun_multichip`: one step
of each sharded solver on a tiny problem, in n processes.

    dryrun_multichip(4)                    # 4 CPU processes, gloo
    dryrun_multichip(4, backend="nccl")    # one process per visible card

Each process joins the group through a `FileStore` in a temporary
directory (no TCP port, so concurrent runs cannot collide), runs every
stage and saves its results; `dryrun_multichip` returns every rank's.  The
stages, as in the JAX dry run: the exact solve
map-sharded over a ("data", "map") mesh (data = 2 when n is even and
>= 4), the exact solve data-parallel over a 1-D mesh of all n ranks, the
grid-table solvers data-parallel on that mesh (`solver="blocks"`, and
`"fused"` on the fetch and GN kernels), and the grid tables map-sharded
over the 2-D mesh.  `problem_2d` / `problem_1d` build each stage's inputs,
so a caller can solve the same problem unsharded.

NCCL failing to initialize raises: the run never falls back to gloo or to
the CPU.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..convert import to_numpy
from ..pipeline.cloud_info import FeatureMap, ScanFeatures
from . import batch as pbatch
from . import map_sharded

CELL_CAPS = (16, 32)     # corner, surf cell caps of the grid-table stages


def tiny_problem(*, device, batch=None, map_corner=1024, map_surf=2048,
                 corner_cap=256, surf_cap=512, seed=0):
    """`__graft_entry__._tiny_problem` on `device`: a scan of points on 16
    vertical lines and two planes, the map the same structures 4x denser
    with 2 cm noise, one guess (0.01, -0.01, 0.02, 0.1, -0.1, 0.05);
    `batch` copies of the scan and guess when given.  Returns (features,
    map, poses)."""
    rng = np.random.RandomState(seed)
    r = np.random.RandomState(seed)
    line_xy = r.uniform(-10, 10, (16, 2))
    cz = r.uniform(-1, 4, (corner_cap,))
    li = r.randint(0, 16, corner_cap)
    corner = np.stack([line_xy[li, 0], line_xy[li, 1], cz],
                      -1).astype(np.float32)
    sx = r.uniform(-12, 12, (surf_cap, 2))
    plane = r.randint(0, 2, surf_cap)
    surf = np.where(
        plane[:, None] == 0,
        np.stack([sx[:, 0], sx[:, 1], np.full(surf_cap, -1.5)], -1),
        np.stack([sx[:, 0], np.full(surf_cap, 12.0), sx[:, 1]], -1)
    ).astype(np.float32)
    mc = np.concatenate([corner + rng.normal(0, 0.02, corner.shape)
                         for _ in range(map_corner // corner_cap)])
    ms = np.concatenate([surf + rng.normal(0, 0.02, surf.shape)
                         for _ in range(map_surf // surf_cap)])
    pose = np.array([0.01, -0.01, 0.02, 0.1, -0.1, 0.05], np.float32)
    lanes = 1 if batch is None else batch

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    feats = ScanFeatures(
        t(np.broadcast_to(corner, (lanes, corner_cap, 3))),
        torch.ones(lanes, corner_cap, dtype=torch.bool, device=device),
        t(np.broadcast_to(surf, (lanes, surf_cap, 3))),
        torch.ones(lanes, surf_cap, dtype=torch.bool, device=device))
    fmap = FeatureMap(
        t(mc.astype(np.float32)),
        torch.ones(map_corner, dtype=torch.bool, device=device),
        t(ms.astype(np.float32)),
        torch.ones(map_surf, dtype=torch.bool, device=device))
    poses = t(np.broadcast_to(pose, (lanes, 6)))
    if batch is None:
        feats = ScanFeatures(*(a[0] for a in feats))
        poses = poses[0]
    return feats, fmap, poses


def mesh_shape(n_devices: int):
    """(data, map) of the dry run's 2-D mesh."""
    data = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    return data, n_devices // data


def problem_2d(n_devices: int, *, device):
    """Inputs of the map-sharded exact solve: a batch of 2 x data scans
    and a map of 256 x map corner and 512 x map surf points."""
    data, n_map = mesh_shape(n_devices)
    return tiny_problem(device=device, batch=2 * data,
                        map_corner=256 * n_map, map_surf=512 * n_map,
                        corner_cap=128, surf_cap=256)


def problem_1d(n_devices: int, *, device):
    """Inputs of the data-parallel stages: n scans of 512 + 1024 features
    against a 2048 + 4096 point map, and the grid box (center, half extent)
    around the map.  (The JAX dry run's 128 + 256 features against 1024 +
    2048 points leave every lane flagged degenerate, where the exact
    solver's update rests on the eigenvectors of a near-degenerate JtJ and
    the two packages' poses differ by up to 4.3e-4 m.)"""
    feats, fmap, poses = tiny_problem(device=device, batch=n_devices,
                                      map_corner=2048, map_surf=4096,
                                      corner_cap=512, surf_cap=1024)
    pts = fmap.surf_xyz.cpu().numpy()
    center = ((pts.min(0) + pts.max(0)) / 2.0).astype(np.float32)
    half = ((pts.max(0) - pts.min(0)) / 2.0 + 1.0).astype(np.float32)
    return feats, fmap, poses, center, half


def dryrun_body(n_devices: int, device_type: str) -> dict:
    """One step of each sharded solver on this rank (the default process
    group of n_devices ranks initialized): {stage: (RegisterResult, stats)}
    as NumPy arrays, the whole batch on every rank."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    data, _ = mesh_shape(n_devices)
    mesh2 = map_sharded.make_2d_mesh(device_type, n_devices, data=data)
    mesh1 = pbatch.make_mesh(device_type, n_devices)
    ccap, scap = CELL_CAPS
    out = {}

    def keep(name, res_stats):
        res, stats = res_stats
        out[name] = (to_numpy(res), {k: v.item() for k, v in stats.items()})

    feats2, fmap2, poses2 = problem_2d(n_devices, device=device)
    feats, fmap, poses, center, half = problem_1d(n_devices, device=device)
    keep("map_sharded_register", map_sharded.map_sharded_register(
        mesh2, feats2, fmap2, poses2, chunk=256, max_iterations=3))
    keep("shard_register", pbatch.shard_register(
        mesh1, feats, fmap, poses, chunk=512, max_iterations=3))
    for name, build, solver in (
            ("shard_register_tables", pbatch.build_map_block_tables,
             "blocks"),
            ("shard_register_tables_fused", pbatch.build_map_planar_tables,
             "fused")):
        ctab, stab, origin, dims = build(fmap, center, half,
                                         corner_cell_cap=ccap,
                                         surf_cell_cap=scap)
        keep(name, pbatch.shard_register_tables(
            mesh1, feats, ctab, stab, origin, poses, grid_dims=dims,
            solver=solver, corner_cell_cap=ccap, surf_cell_cap=scap,
            num_rounds=1, iters_per_round=3))
    lanes = slice(0, poses2.shape[0])
    ctabs, stabs, origin, dims = map_sharded.build_sharded_block_tables(
        fmap, center, half, n_devices // data, corner_cell_cap=ccap,
        surf_cell_cap=scap)
    keep("map_sharded_register_tables",
         map_sharded.map_sharded_register_tables(
             mesh2, pbatch.take_lanes(feats, lanes), ctabs, stabs, origin,
             poses[lanes], grid_dims=dims, corner_cell_cap=ccap,
             surf_cell_cap=scap, num_rounds=1, iters_per_round=3))
    return out


def _rank_main(rank: int, n_devices: int, backend: str,
               workdir: str) -> None:
    """The spawned process of rank `rank`: join the group, run the body,
    save its results to workdir/rank<rank>.pt."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device_type = "cuda"
    else:
        torch.set_num_threads(1)   # the ranks share the host's cores
        device_type = "cpu"
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(workdir, "store"),
                                      n_devices),
        rank=rank, world_size=n_devices)
    try:
        out = dryrun_body(n_devices, device_type)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def dryrun_multichip(n_devices: int, *, backend: str = "gloo") -> list:
    """Run `dryrun_body` in n_devices spawned processes, one rank each:
    backend "gloo" on the CPU, or "nccl" with one process per card (n at
    most the visible cards).  Returns each rank's {stage: (RegisterResult,
    stats)}, in rank order; raises if a process fails."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if backend == "nccl" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"nccl dry run on {n_devices} ranks, "
                           f"{torch.cuda.device_count()} cards visible")
    with tempfile.TemporaryDirectory() as workdir:
        torch.multiprocessing.start_processes(
            _rank_main, args=(n_devices, backend, workdir),
            nprocs=n_devices, join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_devices)]
