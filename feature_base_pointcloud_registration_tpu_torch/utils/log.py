"""Structured event log — the pub/sub + rosconsole observability analog.

The port's copy of the JAX package's `utils/log.py` (which imports no JAX;
the port imports none of the JAX package), with tensors converted too.

The reference exposes its internals through ~9 ROS publishers in
mapOptimization alone (odometry, path, local/global maps, registered
clouds; ref: src/mapOptmization.h:163-187) plus rosconsole severity logs
(ref: launch/include/rosconsole/*.conf, ROS_INFO/WARN/ERROR call sites).
Here the pipelines already RETURN their payloads as arrays; what remains
is the event stream: one append-only, in-process structured log that the
pipelines emit into and tools can drain, filter, or persist as JSONL.

    from feature_base_pointcloud_registration_tpu_torch.utils.log import get_logger
    log = get_logger()
    log.event("mapping/odometry", pose=[...], n_corr=812, level="info")
    ...
    log.to_jsonl("run_events.jsonl")     # persist
    log.drain("mapping/odometry")        # consume events of one topic

Events are plain dicts: {"t": wall_time, "topic": ..., "level": ...,
**fields}.  NumPy scalars, tensors and small arrays are converted to plain
Python so events stay json-serializable.  A bounded deque keeps memory
constant on long runs.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import torch

LEVELS = ("debug", "info", "warn", "error")


def _plain(v):
    """Best-effort conversion to JSON-serializable plain Python."""
    import numpy as np

    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    a = np.asarray(v)
    if a.ndim == 0:
        return a.item()
    if a.size <= 64:
        return a.tolist()
    return {"shape": list(a.shape), "dtype": str(a.dtype)}


class EventLog:
    """Bounded structured event recorder with optional live sink."""

    def __init__(self, capacity: int = 65536,
                 sink: Optional[Callable[[Dict], None]] = None,
                 min_level: str = "debug"):
        self.events: deque = deque(maxlen=capacity)
        self.sink = sink
        self.min_level = min_level

    def event(self, topic: str, level: str = "info", **fields):
        if LEVELS.index(level) < LEVELS.index(self.min_level):
            return
        e = {"t": time.time(), "topic": topic, "level": level}
        e.update({k: _plain(v) for k, v in fields.items()})
        self.events.append(e)
        if self.sink is not None:
            self.sink(e)

    # severity shorthands (ROS_INFO/WARN/ERROR analog)
    def info(self, topic: str, **fields):
        self.event(topic, level="info", **fields)

    def warn(self, topic: str, **fields):
        self.event(topic, level="warn", **fields)

    def error(self, topic: str, **fields):
        self.event(topic, level="error", **fields)

    def drain(self, topic: Optional[str] = None) -> List[Dict]:
        """Pop and return all events (optionally of one topic)."""
        if topic is None:
            out = list(self.events)
            self.events.clear()
            return out
        out = [e for e in self.events if e["topic"] == topic]
        kept = [e for e in self.events if e["topic"] != topic]
        self.events.clear()
        self.events.extend(kept)
        return out

    def tail(self, n: int = 20, topic: Optional[str] = None) -> List[Dict]:
        evs = (e for e in self.events
               if topic is None or e["topic"] == topic)
        return list(evs)[-n:]

    def to_jsonl(self, path: str):
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")


_default: Optional[EventLog] = None


def get_logger() -> EventLog:
    """Process-wide default event log (created on first use)."""
    global _default
    if _default is None:
        _default = EventLog()
    return _default


def set_logger(log: Optional[EventLog]):
    global _default
    _default = log
