"""Respawn supervisor: the roslaunch `respawn="true"` analog.

The port's own copy of the JAX package's `utils/supervise.py` (no JAX in
either), on the port's `pipeline/checkpoint.py`.

Every reference node is launched with respawn="true" (ref:
launch/include/module_loam.launch:5-13): when one crashes, roslaunch
restarts it and the node re-initializes from surviving state.  Here the
equivalent is a replay supervisor: the pipeline checkpoints its FULL host
state to disk (pipeline/checkpoint.py) every few steps, and on a crash the
supervisor rebuilds the pipeline FROM SCRATCH and restores it from the
last durable checkpoint — exactly what a fresh process would do — then
resumes the scan stream from the persisted cursor.  A resumed run is
bit-identical to an uninterrupted one on the CPU whenever the crash struck
after a checkpoint boundary (tests/test_torch_checkpoint.py).

The restart happens in-process (rebuild + disk restore) so the supervisor
works the same under a driver that re-execs the whole script: on start,
`run_supervised` finds the checkpoint and cursor and continues.
"""

from __future__ import annotations

import json
import os

from ..pipeline.checkpoint import (has_checkpoint, load_checkpoint,
                                   save_checkpoint)

CURSOR_FILE = "cursor.json"


def _save_cursor(directory: str, next_step: int):
    path = os.path.join(directory, CURSOR_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"next_step": int(next_step)}, f)
    os.replace(tmp, path)


def load_cursor(directory: str) -> int:
    path = os.path.join(directory, CURSOR_FILE)
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return int(json.load(f)["next_step"])


def checkpoint(pipe, directory: str, next_step: int):
    """Durable point: full pipeline state + replay cursor, both atomic."""
    save_checkpoint(pipe, directory)
    _save_cursor(directory, next_step)


def run_supervised(build_pipeline, items, step_fn, checkpoint_dir: str, *,
                   checkpoint_every: int = 1, max_respawns: int = 5,
                   log=None):
    """Drive `step_fn(pipe, item)` over `items` under crash supervision.

    build_pipeline: () -> fresh pipeline (same params/caps every call).
    items:          replayable sequence of per-step inputs.
    On an exception from step_fn: rebuild the pipeline, restore the last
    checkpoint, and resume from the persisted cursor (at most
    `max_respawns` times; the final crash re-raises).  Returns
    (pipe, n_respawns).
    """
    def fresh():
        pipe = build_pipeline()
        if has_checkpoint(checkpoint_dir):
            load_checkpoint(pipe, checkpoint_dir)
            return pipe, load_cursor(checkpoint_dir)
        return pipe, 0

    pipe, k = fresh()
    respawns = 0
    while k < len(items):
        try:
            step_fn(pipe, items[k])
        except Exception as e:  # noqa: BLE001 - supervisor catches all
            if respawns >= max_respawns:
                raise
            respawns += 1
            if log is not None:
                log.event("supervisor/respawn", level="warn", step=k,
                          error=repr(e), respawn=respawns)
            pipe, k = fresh()
            continue
        k += 1
        if k % checkpoint_every == 0 or k == len(items):
            checkpoint(pipe, checkpoint_dir, k)
    return pipe, respawns
