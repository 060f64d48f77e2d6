"""Config system: the port's copy of the JAX package's `config.py`.

The reference loads ~45 typed parameters from the ROS parameter server in a
base class every node inherits (ref: include/utility.h:61-212, defaults there;
deployed values in config/params.yaml).  Here the same parameter surface is a
frozen dataclass: one immutable value passed explicitly to every stage, plus
static padding capacities that fix array shapes.  It is pure Python, so both
packages read the same `config/params.yaml` and build equal `Params`.

Static shape policy: everything that is ragged in the reference (valid points,
picked features, crop counts, correspondence counts) is padded to the caps
below and masked.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def _parse_scalar(text: str):
    t = text.strip()
    if t.startswith('"') and t.endswith('"'):
        return t[1:-1]
    if t.startswith("'") and t.endswith("'"):
        return t[1:-1]
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        if any(c in t for c in ".eE") and not t.lstrip("+-").isdigit():
            return float(t)
        return int(t)
    except ValueError:
        return t


def load_flat_yaml(path: str) -> dict:
    """Minimal parser for the flat `key: value` YAML the reference ships
    (config/params.yaml) — scalars and inline/multiline numeric lists only.
    Avoids a PyYAML dependency."""
    out: dict = {}
    pending_key = None
    pending_items: list = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            if pending_key is not None:
                frag = line.strip().rstrip(",")
                if frag:
                    for tok in frag.rstrip("]").split(","):
                        tok = tok.strip()
                        if tok:
                            pending_items.append(_parse_scalar(tok))
                if line.rstrip().endswith("]"):
                    out[pending_key] = pending_items
                    pending_key, pending_items = None, []
                continue
            if ":" not in line:
                continue
            key, _, val = line.partition(":")
            key, val = key.strip(), val.strip()
            if not val:
                continue
            if val.startswith("["):
                body = val[1:]
                if body.rstrip().endswith("]"):
                    items = [
                        _parse_scalar(t)
                        for t in body.rstrip()[:-1].split(",")
                        if t.strip()
                    ]
                    out[key] = items
                else:
                    pending_key = key
                    pending_items = [
                        _parse_scalar(t)
                        for t in body.rstrip(",").split(",")
                        if t.strip()
                    ]
            else:
                out[key] = _parse_scalar(val)
    return out


@dataclasses.dataclass(frozen=True)
class Params:
    """Mirrors the reference parameter surface (include/utility.h:68-139 field
    list; defaults from utility.h:146-212 overridden by config/params.yaml),
    plus TPU static-shape capacities."""

    # --- Topics (kept for dataset-loader parity; no ROS here) ---
    point_cloud_topic: str = "velodyne_points"
    imu_topic: str = "imu/data"
    odom_topic: str = "odometry/imu"
    gps_topic: str = "odometry/gpsz"

    # --- GPS settings (utility.h:77-80) ---
    use_imu_heading_initialization: bool = True
    use_gps_elevation: bool = False
    gps_cov_threshold: float = 2.0
    pose_cov_threshold: float = 25.0

    # --- Map save/load (utility.h:83-84) ---
    save_pcd: bool = False
    save_pcd_directory: str = "/tmp/fbpr_map/"

    # --- Sensor geometry (utility.h:87-88; params.yaml:19-20) ---
    n_scan: int = 16
    horizon_scan: int = 1800

    # --- IMU noise / extrinsics (utility.h:91-102; params.yaml:22-42) ---
    imu_acc_noise: float = 3.9939570888238808e-03
    imu_gyr_noise: float = 1.5636343949698187e-03
    imu_acc_bias_n: float = 6.4356659353532566e-05
    imu_gyr_bias_n: float = 3.5640318696367613e-05
    imu_gravity: float = 9.80511
    ext_rot: Tuple[float, ...] = (0.0, 1.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0)
    ext_rpy: Tuple[float, ...] = (0.0, 1.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0)
    ext_trans: Tuple[float, ...] = (0.0, 0.0, 0.0)

    # --- LOAM thresholds (utility.h:105-108; params.yaml:45-48) ---
    edge_threshold: float = 1.0
    surf_threshold: float = 0.1
    edge_feature_min_valid_num: int = 10
    surf_feature_min_valid_num: int = 100

    # --- Voxel sizes (utility.h:111-113; params.yaml:51-53) ---
    odometry_surf_leaf_size: float = 0.4
    mapping_corner_leaf_size: float = 0.2
    mapping_surf_leaf_size: float = 0.4

    # --- Motion constraints (utility.h:115-116; params.yaml:56-57) ---
    z_tolerance: float = 1000.0
    rotation_tolerance: float = 1000.0

    # --- Scheduling (utility.h:119-120; params.yaml:60-61) ---
    number_of_cores: int = 4  # kept for parity; TPU path is SPMD
    mapping_process_interval: float = 0.15

    # --- Keyframing / surrounding map (utility.h:123-126) ---
    surrounding_keyframe_adding_dist_threshold: float = 1.0
    surrounding_keyframe_adding_angle_threshold: float = 0.2
    surrounding_keyframe_density: float = 2.0
    surrounding_keyframe_search_radius: float = 50.0

    # --- Loop closure (utility.h:129-134; params.yaml:70-75) ---
    loop_closure_enable_flag: bool = False
    surrounding_keyframe_size: int = 25
    history_keyframe_search_radius: float = 15.0
    history_keyframe_search_time_diff: float = 30.0
    history_keyframe_search_num: int = 25
    history_keyframe_fitness_score: float = 0.3

    # --- Global map visualization (utility.h:137-139) ---
    global_map_visualization_search_radius: float = 1000.0
    global_map_visualization_pose_density: float = 10.0
    global_map_visualization_leaf_size: float = 1.0

    # --- Registration solver budget (hard-coded in the reference) ---
    max_gn_iterations: int = 30          # mapOptmization.h:1417
    min_correspondences: int = 50        # mapOptmization.h:1268
    degeneracy_eigen_threshold: float = 100.0  # mapOptmization.h:1359
    converge_delta_rot_deg: float = 0.05  # mapOptmization.h:1397
    converge_delta_trans_cm: float = 0.05
    local_map_half_extent: Tuple[float, float, float] = (30.0, 30.0, 10.0)  # mapOptmization.h:286
    # Neighbor-grid box for grid_register_step (BOTH pipelines).  It must
    # cover the surrounding-keyframe radius (50 m, mapOptmization.h:872)
    # because the reference's SLAM path KD-searches the full surrounding map;
    # the localization path's crop box (local_map_half_extent) is strictly
    # inside it, so sharing one box also keeps a single compiled registration
    # executable (two static variants trip a jax-0.9 executable-cache bug —
    # see docs/ROUND_NOTES.md).
    register_grid_half_extent: Tuple[float, float, float] = (60.0, 60.0, 25.0)
    imu_attitude_weight: float = 0.05    # mapOptmization.h:1452
    # Opt-in (0.0 = off = reference parity): minimum in-plane short-axis
    # spread (sqrt of the middle eigenvalue of the 5-NN scatter, meters)
    # for a surf plane fit to be accepted.  The reference's plane-validity
    # check (mapOptmization.h:1182-1190) passes collinear same-ring 5-NN
    # sets whose normals are arbitrary; those bias sparse-early-map SLAM.
    surf_min_planar_spread: float = 0.0

    # --- TPU static-shape capacities (new; SURVEY.md §7 padding policy) ---
    max_points: int = 0          # 0 -> n_scan * horizon_scan
    corner_cap: int = 2048       # <= 20/sector * 6 sectors * n_scan rings
    surf_cap: int = 8192         # post per-ring voxel downsample
    map_corner_cap: int = 32768  # cropped local corner map
    map_surf_cap: int = 65536    # cropped local surf map
    knn_chunk: int = 4096        # map chunk for streamed 5-NN top-k
    imu_queue_len: int = 512     # deskew rotation table (ref: queueLength=500)
    sector_cap: int = 304        # max compacted points per (ring, sector)
    # strict = the reference's fully serialized pick stream (bit-parity
    # mode); False = sector-parallel fast picking (~6x faster frontend,
    # tolerance-level parity — see ops/features.py)
    strict_feature_pick: bool = True

    def __post_init__(self):
        if self.max_points == 0:
            object.__setattr__(self, "max_points", self.n_scan * self.horizon_scan)

    @property
    def ang_res_x(self) -> float:
        """Horizontal angular resolution, deg/column (imageProjection.cpp:608)."""
        return 360.0 / float(self.horizon_scan)

    @classmethod
    def from_yaml(cls, path: str) -> "Params":
        """Build Params from a reference-format params.yaml."""
        raw = load_flat_yaml(path)
        key_map = {
            "pointCloudTopic": "point_cloud_topic",
            "imuTopic": "imu_topic",
            "odomTopic": "odom_topic",
            "gpsTopic": "gps_topic",
            "useImuHeadingInitialization": "use_imu_heading_initialization",
            "useGpsElevation": "use_gps_elevation",
            "gpsCovThreshold": "gps_cov_threshold",
            "poseCovThreshold": "pose_cov_threshold",
            "savePCD": "save_pcd",
            "savePCDDirectory": "save_pcd_directory",
            "N_SCAN": "n_scan",
            "Horizon_SCAN": "horizon_scan",
            "imuAccNoise": "imu_acc_noise",
            "imuGyrNoise": "imu_gyr_noise",
            "imuAccBiasN": "imu_acc_bias_n",
            "imuGyrBiasN": "imu_gyr_bias_n",
            "imuGravity": "imu_gravity",
            "extrinsicRot": "ext_rot",
            "extrinsicRPY": "ext_rpy",
            "extrinsicTrans": "ext_trans",
            "edgeThreshold": "edge_threshold",
            "surfThreshold": "surf_threshold",
            "edgeFeatureMinValidNum": "edge_feature_min_valid_num",
            "surfFeatureMinValidNum": "surf_feature_min_valid_num",
            "odometrySurfLeafSize": "odometry_surf_leaf_size",
            "mappingCornerLeafSize": "mapping_corner_leaf_size",
            "mappingSurfLeafSize": "mapping_surf_leaf_size",
            "z_tollerance": "z_tolerance",
            "rotation_tollerance": "rotation_tolerance",
            "numberOfCores": "number_of_cores",
            "mappingProcessInterval": "mapping_process_interval",
            "surroundingkeyframeAddingDistThreshold": "surrounding_keyframe_adding_dist_threshold",
            "surroundingkeyframeAddingAngleThreshold": "surrounding_keyframe_adding_angle_threshold",
            "surroundingKeyframeDensity": "surrounding_keyframe_density",
            "surroundingKeyframeSearchRadius": "surrounding_keyframe_search_radius",
            "loopClosureEnableFlag": "loop_closure_enable_flag",
            "surroundingKeyframeSize": "surrounding_keyframe_size",
            "historyKeyframeSearchRadius": "history_keyframe_search_radius",
            "historyKeyframeSearchTimeDiff": "history_keyframe_search_time_diff",
            "historyKeyframeSearchNum": "history_keyframe_search_num",
            "historyKeyframeFitnessScore": "history_keyframe_fitness_score",
            "globalMapVisualizationSearchRadius": "global_map_visualization_search_radius",
            "globalMapVisualizationPoseDensity": "global_map_visualization_pose_density",
            "globalMapVisualizationLeafSize": "global_map_visualization_leaf_size",
        }
        kwargs = {}
        for k, v in raw.items():
            field = key_map.get(k)
            if field is None:
                continue
            if isinstance(v, list):
                v = tuple(float(x) for x in v)
            kwargs[field] = v
        return cls(**kwargs)


FLT_MAX = 3.4028234663852886e38   # the largest float32
DEG2RAD = math.pi / 180.0
RAD2DEG = 180.0 / math.pi
