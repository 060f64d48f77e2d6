"""Carry state between the JAX package and the port, through numpy.

`to_torch` turns a tree of numpy arrays — the JAX package's NamedTuples
(`RawScan`, `ScanFeatures`, `FeatureMap`, `RegisterResult`, `GNState`, ...)
after `jax.tree.map(np.asarray, ...)` — into the port's NamedTuples of
tensors, matched by class name.  `to_numpy` goes the other way.
`planar_table_to_torch` carries a planar block table or a `PlanarTable`,
`deskew_info_to_torch` a `DeskewInfo`, `global_map_to_torch` a
`GlobalMap`, `slam_state_to_torch` a `SlamPipeline`'s host state (its
keyframes and factor graph) and `imu_odometry_state_to_torch` an
`ImuOdometry`'s whole state.
Here the map, the tables built from it and the graph stand where a model's
weights would: the tests use these functions to give both packages
identical state.
No function imports JAX, and none picks a device: the caller names it.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Params
from .graph.imu_graph import ImuChainData
from .graph.pose_graph import PoseGraphData
from .imu.preintegration import NavState, PreintState
from .ops.fetch import PlanarTable
from .ops.icp import ICPResult
from .ops.register import RegisterResult
from .ops.solver import GNState
from .pipeline.cloud_info import (CloudInfo, DeskewInfo, FeatureMap, RawScan,
                                  ScanFeatures)
from .pipeline.localization import GlobalMap

_TUPLES = {cls.__name__: cls for cls in
           (RawScan, CloudInfo, ScanFeatures, FeatureMap, RegisterResult,
            GNState, PoseGraphData, ICPResult, NavState, PreintState,
            ImuChainData)}

# SlamPipeline host state: NumPy arrays, factor lists and scalars
SLAM_STATE = ("kf_corner", "kf_corner_mask", "kf_surf", "kf_surf_mask",
              "kf_poses", "kf_times", "n_keyframes", "odom_meas",
              "odom_sigma", "loop_factors", "gps_factors", "prior_factor",
              "gps_queue", "last_gps_point", "pose_cov",
              "carried_prior_sigma", "pose", "time_last_processing",
              "last_imu_transform", "reset_id", "a_loop_is_closed",
              "trajectory")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree, *, device):
    """numpy arrays -> tensors on `device`, NamedTuples -> the port's class
    of the same name (others keep their class), recursively."""
    if _is_namedtuple(tree):
        cls = _TUPLES.get(type(tree).__name__, type(tree))
        return cls(*(to_torch(v, device=device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device=device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree)).to(device)
    return tree


def to_numpy(tree):
    """Tensors -> numpy arrays, recursively (NamedTuples keep their class)."""
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def planar_table_to_torch(table, *, device):
    """JAX planar block table [R, 3*W/128, 128] (the TPU's 128-lane tiling
    of [R, 3*W]) -> the port's [R, 3*W] table.  A JAX `PlanarTable` becomes
    the port's: its table reshaped so, its rows_index carried as is."""
    if _is_namedtuple(table) and hasattr(table, "rows_index"):
        return PlanarTable(
            planar_table_to_torch(table.table, device=device),
            torch.from_numpy(np.array(table.rows_index, np.int32)).to(device))
    table = np.asarray(table, np.float32)
    return torch.from_numpy(table.reshape(table.shape[0], -1).copy()).to(
        device)


def deskew_info_to_torch(info, *, device) -> DeskewInfo:
    """Either package's `DeskewInfo` of numpy arrays, one scan's ([Q]
    tables) or a batch's ([B, Q]), -> the port's batched DeskewInfo on
    `device`."""
    arrays = [np.asarray(getattr(info, f)) for f in DeskewInfo._fields]
    if arrays[0].ndim == 1:
        arrays = [a[None] for a in arrays]
    return DeskewInfo(*(torch.from_numpy(np.array(a)).to(device)
                        for a in arrays))


def global_map_to_torch(global_map, *, device) -> GlobalMap:
    """A `GlobalMap` (its four arrays as numpy, or anything numpy reads)
    -> the port's GlobalMap on `device`, as it is (no downsampling)."""
    return GlobalMap(*(torch.from_numpy(np.array(getattr(global_map, f)))
                       .to(device) for f in ("corner_xyz", "corner_mask",
                                             "surf_xyz", "surf_mask")))


def slam_state_to_torch(state, pipeline):
    """Copy a SLAM pipeline's host state (either package's `SlamPipeline`,
    the fields of SLAM_STATE) into the port's `pipeline` of the same
    capacities; its device mirror of the keyframe clouds is rebuilt at next
    use.  Returns `pipeline`."""
    import copy

    for name in SLAM_STATE:
        value = getattr(state, name)
        if isinstance(value, np.ndarray):
            value = np.array(value)
            if isinstance(getattr(pipeline, name), np.ndarray) and (
                    value.shape != getattr(pipeline, name).shape):
                raise ValueError(f"{name}: {value.shape} != "
                                 f"{getattr(pipeline, name).shape}")
        setattr(pipeline, name, copy.deepcopy(value))
    pipeline._dev_clouds = None
    return pipeline


# ImuOdometry state: host scalars and NumPy arrays, the IMU queues (lists
# of (t, acc, gyr)), and the device tensors (nav states, biases, the
# preintegration window, the last chain data)
IMU_ODOMETRY_HOST = ("system_initialized", "done_first_opt", "key",
                     "reset_id", "last_imu_t_imu", "last_imu_t_opt",
                     "que_opt", "que_imu", "_pending", "chain_states",
                     "chain_mask", "chain_has_preint", "chain_pose_meas",
                     "prior_sigma0", "prior_sigma", "lidar2imu")
IMU_ODOMETRY_DEVICE = ("prev_nav", "prev_ba", "prev_bg", "prev_nav_odom",
                       "prev_ba_odom", "prev_bg_odom", "chain_preint_dev",
                       "_last_chain_data")


def _as_numpy(tree):
    """Array leaves (JAX arrays included, through `np.asarray`) -> numpy,
    NamedTuples kept."""
    if _is_namedtuple(tree):
        return type(tree)(*(_as_numpy(v) for v in tree))
    return np.asarray(tree)


def imu_odometry_state_to_torch(state, odometry):
    """Copy an IMU odometry's whole state (either package's `ImuOdometry`:
    queues, chain arrays, the preintegration window, nav states, biases,
    priors, key / reset_id and flags) into the port's `odometry` of the
    same window, its tensors on `odometry.device`.  Returns `odometry`."""
    import copy

    if state.window != odometry.window:
        raise ValueError(f"window {state.window} != {odometry.window}")
    for name in IMU_ODOMETRY_HOST:
        setattr(odometry, name, copy.deepcopy(getattr(state, name)))
    for name in IMU_ODOMETRY_DEVICE:
        if not hasattr(state, name):        # no chain solved yet
            odometry.__dict__.pop(name, None)
            continue
        setattr(odometry, name, to_torch(_as_numpy(getattr(state, name)),
                                         device=odometry.device))
    return odometry


def params_from_dict(d: dict) -> Params:
    """`Params` from `dataclasses.asdict` of either package's Params."""
    return Params(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in d.items()})
