"""feature_base_pointcloud_registration_tpu_torch — the PyTorch/CUDA port.

A port of the repository's JAX package (JAX on a TPU) to PyTorch on an
NVIDIA Hopper GPU.  The JAX package stays the reference; this package
imports no JAX and none of the JAX package's modules.  Module paths
mirror the JAX package's so each counterpart is easy to find.

Ported so far: the batched scan-to-map main path (projection, fast feature
picking, feature downsampling, hash-grid map tables raw or row-compacted,
and the fused solve `parallel.batch.batch_register_fused`), the
rounds-structured solver (`ops.register.register_rounds_core`) behind
`batch_register_pallas` and `batch_register_blocks`, and the single-scan
localization pipeline (`pipeline.localization.LocalizationPipeline`:
strict picking, IMU deskew, the crop box, `ops.register.grid_register_step`
on the fetch kernels, the IMU attitude fusion; `pipeline.scan_buffer`,
`imu.conversion`, `io.pcd`, `utils.log`), the exact verification solver
(`ops.knn`, `ops.register.register_scan`, `parallel.batch.batch_register`)
and the SLAM back end (`pipeline.slam.SlamPipeline`: keyframes,
`graph.pose_graph`, `ops.icp` loop closure, `save_map`; `native`, the
host C++ runtime), and the LIO mode (`pipeline.lio.LioTopology`:
`imu.preintegration`, `graph.imu_graph`, `pipeline.imu_odometry`; the GPS
chain `pipeline.navsat`; `pipeline.checkpoint` and `utils.supervise` for
crash-safe resume), and the KITTI and multi-session entry points
(`io.kitti` raw I/O, `io.kitti_drive` the generated drive, `ops.fpfh` and
`ops.ransac` global registration, `pipeline.multisession` session merging,
`utils.timing` and `utils.viz`; the runners in `examples`).  The three TPU
kernels are hand-written CUDA in `csrc/` (see `kernels.py`).  Functions
take a leading batch dimension where the JAX package vmaps over scans.
"""

from . import device  # noqa: F401  (sets the TF32 guards)
from .config import Params
from .pipeline.cloud_info import CloudInfo, RawScan, ScanFeatures

__version__ = "0.1.0"

__all__ = ["Params", "CloudInfo", "RawScan", "ScanFeatures", "__version__"]
