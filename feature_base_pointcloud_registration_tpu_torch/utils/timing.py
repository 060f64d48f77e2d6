"""Timing + profiling harness.

Port of the JAX package's `utils/timing.py`.  The reference's entire
observability stack is a chrono stopwatch around the GN solve (TicToc, ref:
src/tic_toc.hpp:15-33 used at src/mapOptmization.h:315-318).  TicToc is
reproduced for parity; StageTimer adds the version that understands
asynchronous device work (it synchronizes the device of the stage's result
before reading the clock) and trace_profile wraps `torch.profiler` for a
Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class TicToc:
    """chrono stopwatch; toc() returns elapsed milliseconds (ref parity)."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._start = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._start) * 1000.0


def _devices(tree):
    """The CUDA devices of the tensors in a tree (tensors, NamedTuples,
    lists, tuples, dicts; anything else holds none)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_devices(v) for v in tree)) if tree else set()
    return set()


def block_until_ready(tree):
    """Wait for the device work behind the tensors in `tree`:
    `torch.cuda.synchronize(device)` for each CUDA device among them;
    nothing for CPU tensors (their ops have finished on return)."""
    for dev in _devices(tree):
        torch.cuda.synchronize(dev)


class StageTimer:
    """Per-stage wall-time accumulator that understands async dispatch.

    Usage:
        st = StageTimer()
        with st.stage("register", block=pose_tensor):
            ...
        st.block(out)      # or pass the result into stage(..., block=out)
        print(st.summary())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                block_until_ready(block)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def block(self, tree):
        block_until_ready(tree)

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:>24}: {t*1000:9.2f} ms total"
                         f"  {t/n*1000:8.3f} ms/call  x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_profile(log_dir: str = "/tmp/fbpr_trace"):
    """torch.profiler trace around a block; writes a Chrome trace
    (`trace.json`, open in chrome://tracing or Perfetto) into `log_dir`.
    Records CUDA activity when PyTorch sees a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
