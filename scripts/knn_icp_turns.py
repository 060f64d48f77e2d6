#!/usr/bin/env python3
"""The k-NN and ICP kernels (csrc/knn_stream.cu, csrc/icp.cu) against other
versions of them, in turns, on one NVIDIA GPU.

    python3 scripts/knn_icp_turns.py [--scenes] [--split] NAME=DIR ...

Each DIR holds another version's knn_stream.cu and icp.cu and the headers
they include (a parent commit's csrc/ unpacked under build/, say); the
shipped sources run as "shipped".  The inputs are the knn and ICP probes'
own, which chip_smoke.py keeps in build/knn_icp_inputs.pt, or with
--scenes tests/icp_scenes.py's room at phase 8's, the pair's and the
merge's caps and three k-NN calls of the probes' shapes.  Every version's
outputs are held bit for bit to the first version's (a failure raises);
each call is timed by CUDA events, the versions in turns (in order, then
backwards: the mean of both).  --split prints each version's ICP clock64
split a trip from its diagnostic build (-DFBPR_ICP_PROFILE), where its
source has the stamps.  Imports no JAX.
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import chip_smoke as cs  # noqa: E402
import icp_scenes  # noqa: E402


def probe_inputs(dev, scenes):
    """({name: (q, ref, mask, k, chunk)}, {name: (args, kw)}) of the knn
    and ICP calls to time."""
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    if not scenes:
        # the probes' calls, as chip_smoke.knn_icp_probes makes them
        saved = torch.load(os.path.join(ROOT, "build", "knn_icp_inputs.pt"))
        icp = {n: ([t.to(dev) for t in a], kw)
               for n, (a, kw) in saved["icp"].items()}
        (src, _, dst, dm), kw = icp["(a) phase 8 loop candidates"]
        (_, _, pd, pm), pkw = icp["(b) phase 10 (c) pair"]
        (q, ref, mask, *_), kkw = saved["knn"]["(c) exact solver surf map"]
        knn = {"(a) ICP phase 8": (src, dst, dm, 1, kw.get("chunk", 2048)),
               "(b) FPFH phase 10 (c)": (pd, pd, pm, 16,
                                         pkw.get("chunk", 2048)),
               "(c) exact solver": (q.to(dev), ref.to(dev), mask.to(dev),
                                    kkw["k"], kkw["chunk"])}
        return knn, icp
    icp = {}
    for name, scene, (N, M, chunk) in (
            ("room at phase 8's caps", "room", (4096, 16384, 2048)),
            ("pair", "pair", (2048, 2048, 2048)),
            ("merge", "merge", (4096, 4096, 2048))):
        src, sm, dst, dm, kw = icp_scenes.icp_scene(scene, N=N, M=M,
                                                    chunk=chunk)
        icp[name] = ([T(a) for a in (src, sm, dst, dm)], kw)
    (src, _, dst, dm), kw = icp["room at phase 8's caps"]
    (_, _, pd, pm), _ = icp["pair"]
    r = np.random.RandomState(0)
    ref = (r.uniform(-30, 30, (65536, 3)) + 40).astype(np.float32)
    live = np.zeros(65536, bool)
    live[:20000] = True
    q = (r.uniform(-30, 30, (2000, 3)) + 40).astype(np.float32)
    knn = {"(a) like: 4096 x 16384, k 1": (src, dst, dm, 1, 2048),
           "(b) like: 2048 in itself, k 16": (pd, pd, pm, 16, 2048),
           "(c) like: 2000 x 65536 (20000 live), k 5": (T(q), T(ref),
                                                        T(live), 5, 4096)}
    return knn, icp


def turns(launchers, reps, graph):
    """{name: mean ms} of launch(), each launcher timed in order and then
    backwards; raises unless every output is bit for bit the first's."""
    names = list(launchers)
    first = [t.clone() for t in launchers[names[0]]()]
    ms = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            out = [t.clone() for t in launchers[n]()]
            if not all(cs._same_bits(a, b) for a, b in zip(out, first)):
                raise AssertionError(f"{n}: outputs differ from {names[0]}'s")
            ms[n].append(cs.cuda_ms(launchers[n], reps, graph=graph))
    return {n: float(np.mean(v)) for n, v in ms.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", metavar="NAME=DIR",
                    type=lambda v: v.split("=", 1))
    ap.add_argument("--scenes", action="store_true",
                    help="tests/icp_scenes.py's inputs in place of the "
                         "probes' saved ones")
    ap.add_argument("--split", action="store_true",
                    help="print each version's ICP clock64 split")
    args = ap.parse_args()
    dev = torch.device("cuda")
    from feature_base_pointcloud_registration_tpu_torch import kernels
    kernels.library()
    libs = {n: cs.ab_builds(("knn_stream", "icp"), d)
            for n, d in args.versions}
    libs["shipped"] = {"knn_stream": None, "icp": None}
    prof = {}
    if args.split:
        prof = {n: cs.ab_builds(("icp",), d, "-DFBPR_ICP_PROFILE")["icp"]
                for n, d in args.versions}
        prof["shipped"] = cs.ab_builds(("icp",),
                                       profile="-DFBPR_ICP_PROFILE")["icp"]
    print(f"gpu: {torch.cuda.get_device_name(0)}", flush=True)
    knn, icp = probe_inputs(dev, args.scenes)
    for name, (q, ref, mask, k, chunk) in knn.items():
        launch = cs.knn_launcher(q, ref, mask, k, chunk)
        ms = turns({n: (lambda lib=lib: launch(lib["knn_stream"]))
                    for n, lib in libs.items()}, 20, True)
        print(f"knn {name}: " + ", ".join(f"{n} {v:.4f}"
                                          for n, v in ms.items())
              + " ms; bit for bit", flush=True)
    for name, (a, kw) in icp.items():
        launch = cs.icp_launcher(a, kw)
        ms = turns({n: (lambda lib=lib: launch(lib["icp"]))
                    for n, lib in libs.items()}, 5, False)
        print(f"icp {name}: " + ", ".join(f"{n} {v:.4f}"
                                          for n, v in ms.items())
              + " ms; bit for bit", flush=True)
        for n, lib in prof.items():
            if hasattr(lib, "fbpr_icp_profile"):
                cs.icp_split(f"{name} ({n})", launch, lib,
                             "diagnostic build")


if __name__ == "__main__":
    main()
