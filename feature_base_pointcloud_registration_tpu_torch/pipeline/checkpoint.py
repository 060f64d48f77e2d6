"""Crash-safe checkpoint/resume for the SLAM pipeline.

The port's own copy of the JAX package's `pipeline/checkpoint.py` (which
imports no JAX; the port imports none of the JAX package), on the port's
`SlamPipeline`, whose host state is the same NumPy arrays, factor lists
and scalars.  The file format is key for key the JAX package's, so a
checkpoint written by either package loads into the other.

The reference runs every node under roslaunch with `respawn="true"`
(ref: launch/include/module_loam.launch:5-13): a crashed node restarts and
re-initializes from whatever state survives (the map PCDs, the bag replay
position).  This module is the analog for the host drivers: the FULL
SlamPipeline host state — keyframe clouds, factor graph, marginals, GPS
queue, reset-id — serializes to one `checkpoint.npz`, atomically, so a
supervisor (utils/supervise.run_supervised, or examples/run_lio.py
--resume) can rebuild the pipeline mid-trajectory and continue.  The
device mirror of the keyframe clouds is not saved: a loaded pipeline
uploads it again at its next step.

No pickle: ragged factor lists are packed to dense arrays, None-able
fields carry presence flags, so a checkpoint written by a dying process
can always be loaded by a fresh one.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

CHECKPOINT_FILE = "checkpoint.npz"


def save_checkpoint(pipe, directory: str) -> str:
    """Serialize `pipe` (a SlamPipeline) to `directory`/checkpoint.npz.

    Atomic: writes to a temp file in the same directory, then os.replace —
    a crash mid-save leaves the previous checkpoint intact (the supervisor
    may call this from an exception handler).
    """
    os.makedirs(directory, exist_ok=True)
    n = pipe.n_keyframes
    K = pipe.max_keyframes

    lf = pipe.loop_factors
    loop_ij = np.array([(i, j) for i, j, _, _ in lf], np.int64).reshape(-1, 2)
    loop_meas = (np.stack([m for _, _, m, _ in lf])
                 if lf else np.zeros((0, 6), np.float32))
    loop_sigma = (np.stack([s for _, _, _, s in lf])
                  if lf else np.zeros((0, 6), np.float32))

    gf = pipe.gps_factors
    gps_i = np.array([i for i, _, _ in gf], np.int64)
    gps_xyz = (np.stack([x for _, x, _ in gf])
               if gf else np.zeros((0, 3), np.float64))
    gps_sigma = (np.stack([s for _, _, s in gf])
                 if gf else np.zeros((0, 3), np.float64))

    gq = pipe.gps_queue
    gq_t = np.array([t for t, _, _ in gq], np.float64)
    gq_xyz = (np.stack([x for _, x, _ in gq])
              if gq else np.zeros((0, 3), np.float64))
    gq_cov = (np.stack([np.asarray(c, np.float64).reshape(3)
                        for _, _, c in gq])
              if gq else np.zeros((0, 3), np.float64))

    has_prior = pipe.prior_factor is not None
    prior_i, prior_meas, prior_sigma = (
        pipe.prior_factor if has_prior
        else (0, np.zeros(6, np.float32), np.zeros(6, np.float32)))

    state = dict(
        version=np.int64(1),
        max_keyframes=np.int64(K),
        n_keyframes=np.int64(n),
        kf_corner=pipe.kf_corner[:n],
        kf_corner_mask=pipe.kf_corner_mask[:n],
        kf_surf=pipe.kf_surf[:n],
        kf_surf_mask=pipe.kf_surf_mask[:n],
        kf_poses=pipe.kf_poses[:n],
        kf_times=pipe.kf_times[:n],
        odom_meas=pipe.odom_meas[:n],
        odom_sigma=pipe.odom_sigma[:n],
        loop_ij=loop_ij, loop_meas=loop_meas, loop_sigma=loop_sigma,
        gps_i=gps_i, gps_xyz=gps_xyz, gps_sigma=gps_sigma,
        gq_t=gq_t, gq_xyz=gq_xyz, gq_cov=gq_cov,
        last_gps_point=pipe.last_gps_point,
        has_prior=np.bool_(has_prior),
        prior_i=np.int64(prior_i),
        prior_meas=np.asarray(prior_meas, np.float32),
        prior_sigma=np.asarray(prior_sigma, np.float32),
        pose_cov=pipe.pose_cov,
        has_carried_prior=np.bool_(pipe.carried_prior_sigma is not None),
        carried_prior_sigma=(
            np.asarray(pipe.carried_prior_sigma, np.float32)
            if pipe.carried_prior_sigma is not None
            else np.zeros(6, np.float32)),
        pose=pipe.pose,
        time_last_processing=np.float64(pipe.time_last_processing),
        has_last_imu=np.bool_(pipe.last_imu_transform is not None),
        last_imu_transform=(
            np.asarray(pipe.last_imu_transform, np.float32)
            if pipe.last_imu_transform is not None
            else np.zeros(3, np.float32)),
        reset_id=np.int64(pipe.reset_id),
        a_loop_is_closed=np.bool_(pipe.a_loop_is_closed),
        trajectory=(np.stack(pipe.trajectory)
                    if pipe.trajectory else np.zeros((0, 6), np.float32)),
    )

    path = os.path.join(directory, CHECKPOINT_FILE)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **state)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(pipe, directory: str):
    """Restore checkpoint state into a freshly constructed SlamPipeline.

    `pipe` must be built with the same params/caps as the saver (cap
    mismatches raise — a resumed run must produce the same map layout).
    Returns `pipe`.
    """
    z = np.load(os.path.join(directory, CHECKPOINT_FILE))
    K = int(z["max_keyframes"])
    if K != pipe.max_keyframes:
        raise ValueError(
            f"checkpoint max_keyframes={K} != pipeline {pipe.max_keyframes}")
    n = int(z["n_keyframes"])
    for name, cap_attr in (("kf_corner", "kf_corner_cap"),
                           ("kf_surf", "kf_surf_cap")):
        want = getattr(pipe, cap_attr)
        got = z[name].shape[1] if n else want
        if n and got != want:
            raise ValueError(f"checkpoint {name} cap={got} != {want}")

    pipe.n_keyframes = n
    pipe.kf_corner[:n] = z["kf_corner"]
    pipe.kf_corner_mask[:n] = z["kf_corner_mask"]
    pipe.kf_surf[:n] = z["kf_surf"]
    pipe.kf_surf_mask[:n] = z["kf_surf_mask"]
    pipe.kf_poses[:n] = z["kf_poses"]
    pipe.kf_times[:n] = z["kf_times"]
    pipe.odom_meas[:n] = z["odom_meas"]
    pipe.odom_sigma[:n] = z["odom_sigma"]

    pipe.loop_factors = [
        (int(ij[0]), int(ij[1]), m.astype(np.float32), s.astype(np.float32))
        for ij, m, s in zip(z["loop_ij"], z["loop_meas"], z["loop_sigma"])]
    pipe.gps_factors = [
        (int(i), x, s)
        for i, x, s in zip(z["gps_i"], z["gps_xyz"], z["gps_sigma"])]
    pipe.gps_queue = [
        (float(t), x, c)
        for t, x, c in zip(z["gq_t"], z["gq_xyz"], z["gq_cov"])]
    pipe.last_gps_point = z["last_gps_point"]
    pipe.prior_factor = (
        (int(z["prior_i"]), z["prior_meas"], z["prior_sigma"])
        if bool(z["has_prior"]) else None)
    pipe.pose_cov = z["pose_cov"]
    pipe.carried_prior_sigma = (
        z["carried_prior_sigma"] if bool(z["has_carried_prior"]) else None)
    pipe.pose = z["pose"].astype(np.float32)
    pipe.time_last_processing = float(z["time_last_processing"])
    pipe.last_imu_transform = (
        z["last_imu_transform"] if bool(z["has_last_imu"]) else None)
    pipe.reset_id = int(z["reset_id"])
    pipe.a_loop_is_closed = bool(z["a_loop_is_closed"])
    pipe.trajectory = [t.astype(np.float32) for t in z["trajectory"]]
    pipe._dev_clouds = None      # device mirror is stale by definition
    return pipe


def has_checkpoint(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, CHECKPOINT_FILE))
