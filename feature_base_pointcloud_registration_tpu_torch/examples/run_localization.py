"""Localization-mode demo on the PyTorch port: the `run.launch` equivalent
(ref: launch/run.launch).

Builds (or loads) a global feature map and localizes a stream of synthetic
VLP-16 scans against it, printing per-scan poses and timing.

    python -m feature_base_pointcloud_registration_tpu_torch.examples.run_localization \\
        [--map-dir DIR] [--scans N] [--device cuda|cpu]

The port's counterpart of the JAX package's examples/run_localization.py,
with its trajectory, seeds and capacities.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--map-dir", default=None,
                    help="directory with cloudCorner.pcd/cloudSurf.pcd "
                         "(default: synthetic ground-truth map)")
    ap.add_argument("--scans", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from feature_base_pointcloud_registration_tpu_torch import Params
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, build_feature_map, simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        RawScan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.localization import (  # noqa: E501
        GlobalMap, LocalizationPipeline)
    from feature_base_pointcloud_registration_tpu_torch.utils import (
        StageTimer)

    device = torch.device(args.device)
    params = Params(map_corner_cap=8192, map_surf_cap=65536)
    world = SyntheticWorld()
    if args.map_dir:
        gm = GlobalMap.from_pcd_dir(params, args.map_dir, device=device)
    else:
        gm = GlobalMap(*(torch.from_numpy(a).to(device) for a in
                         build_feature_map(world, params.map_corner_cap,
                                           params.map_surf_cap)))

    pipe = LocalizationPipeline(params, gm)
    # localization mode gets a map-frame initial guess, like the reference's
    # prebuilt-map workflow (the guess then chains scan to scan)
    pipe.pose = np.array([0, 0, 0.0, -2.0, -1.0, 0.0], np.float32)
    st = StageTimer()
    errs = []
    for k in range(args.scans):
        gt = np.array([0, 0, 0.05 * k, 0.3 * k - 2.0, 0.15 * k - 1.0, 0.0],
                      np.float32)
        s = simulate_scan(world, gt, seed=k)
        raw = RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"],
                                 s["time"], device=device)._replace(
            valid=torch.from_numpy(s["valid"]).to(device))
        with st.stage("scan"):
            # step returns the pose on the host: the device work is done
            pose = pipe.step(raw, timestamp=0.2 * k)
        errs.append(float(np.linalg.norm(pose[3:] - gt[3:])))
        print(f"scan {k:3d}: pose=({pose[3]:+7.3f} {pose[4]:+7.3f} "
              f"{pose[5]:+7.3f})  err={errs[-1] * 100:6.2f} cm")
    print(st.summary())
    return np.array(errs)


if __name__ == "__main__":
    main()
