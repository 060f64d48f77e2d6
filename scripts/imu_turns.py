#!/usr/bin/env python3
"""The IMU preintegration and propagation kernels (csrc/preintegration.cu)
against other versions of them, in turns, on one NVIDIA GPU.

    python3 scripts/imu_turns.py [--split] NAME=DIR ...

Each DIR holds another version's preintegration.cu and the headers it
includes (a parent commit's csrc/ unpacked under build/, say); the shipped
source runs as "shipped".  The inputs are tests/imu_chain_scenes.py's
buffers and edge buffers: phase 9's 19-sample interval, the 64-sample
capped interval, the 1024-slot buffer, none live, and the edge buffers.
Every version's outputs are held bit for bit to the shipped ones (a
failure raises); each call's launch alone is timed on the device (reps
launches replayed in a CUDA graph, by CUDA events), the versions in turns
(in order, then backwards: the mean of both).  --split prints the shipped
kernels' clock64 splits from their diagnostic build
(-DFBPR_PREINT_PROFILE) at every buffer.  Imports no JAX.
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import chip_smoke as cs  # noqa: E402
import imu_chain_scenes as ics  # noqa: E402
from feature_base_pointcloud_registration_tpu_torch.device import (  # noqa: E402,E501
    require_cuda)


def turns(launch, libs, reps):
    """{name: mean device ms} of each version's launch (reps launches in a
    CUDA graph), timed in order and then backwards; raises unless every
    version's outputs are bit for bit the shipped ones'."""
    names = list(libs)
    first = [t.clone() for t in launch(libs[names[0]])]
    for n in names[1:]:
        out = launch(libs[n])
        if not all(cs._same_bits(a, b) for a, b in zip(first, out)):
            raise AssertionError(f"{n}: outputs differ from {names[0]}'s")
    ms = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            ms[n].append(cs.cuda_ms(lambda: launch(libs[n]), reps,
                                    graph=True))
    return {n: float(np.mean(v)) for n, v in ms.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kinds", default=None,
                    help="the buffers to run, comma-separated "
                         "(imu_chain_scenes' names; all by default)")
    ap.add_argument("others", nargs="*", metavar="NAME=DIR")
    args = ap.parse_args()
    dev = require_cuda()
    print(f"gpu: {torch.cuda.get_device_name(0)}", flush=True)
    libs = {"shipped": None}
    for spec in args.others:
        name, d = spec.split("=", 1)
        libs[name] = cs.ab_builds(("preintegration",), d)["preintegration"]
    prof = (cs.ab_builds(("preintegration",),
                         profile="-DFBPR_PREINT_PROFILE")["preintegration"]
            if args.split else None)
    nav = (torch.from_numpy(ics.rot((0.1, -0.2, 0.7)).astype(np.float32))
           .to(dev), torch.tensor([1.0, -2.0, 0.5], device=dev),
           torch.tensor([1.2, 0.1, 0.0], device=dev))
    kinds = (args.kinds.split(",") if args.kinds
             else ics.BUFFERS + ics.EDGE_BUFFERS)
    for kind in kinds:
        acc, gyr, dt, m, ba, bg = ics.buffer(kind, dev)
        live = acc.shape[0] if m is None else int(m.sum())
        pre = cs.preint_launcher((acc, gyr, dt, m, ba, bg, ics.ACC_VAR,
                                  ics.GYR_VAR), {})
        prop = cs.propagate_launcher((nav, ba, bg, acc, gyr, dt, m),
                                     dict(gravity=ics.G))
        for what, launch in (("preintegrate", pre),
                             ("propagate_states", prop)):
            ms = turns(launch, libs, args.reps)
            print(f"{what} {kind} ({acc.shape[0]} slots, {live} live): "
                  + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items())
                  + "; outputs bit for bit equal True", flush=True)
        if prof is not None:
            cs.preint_split(kind, pre, prof)
            cs.propagate_split(kind, prop, prof)


if __name__ == "__main__":
    main()
