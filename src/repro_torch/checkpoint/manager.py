"""Checkpoint manager: atomic, async, keep-k, auto-resume.

The port of the JAX package's ``checkpoint/manager.py``, with its layout
and its keys:
  <dir>/step_<n>/manifest.json        keys, shapes, dtypes, extras
  <dir>/step_<n>/arrays.npz           full arrays by flat key
  <dir>/step_<n>/.COMPLETE            commit marker (atomic rename target)
A training state is stored as the reference's TrainState would be
(``bridge.train_state_to_jax``: ``.params/<tree path>``, ``.opt/.m/...``,
``.opt/.v/...``, ``.opt/.count``, ``.step``, layers stacked), so either
package restores what the other wrote.

The arrays are copied to the host on the calling thread (the train step
updates the parameters in place afterwards); only the file writing runs
on the background thread, unless ``save(..., block=True)``.

A sharded state (``train.step.ShardedTrainState``, ``--mesh``) is saved
in the same mesh-agnostic layout: every rank takes part in gathering the
blocks whole, one tensor at a time, and only rank 0 keeps them (on the
host) and writes. Such a save always blocks (``block`` is ignored): it
ends at a barrier, so the files exist for every rank once it returns. Restore
reads the whole arrays into any state, sharded on any mesh or not: the
reference's elastic restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import (named_to_jax, params_from_jax, train_state_from_jax,
                                train_state_to_jax)
from repro_torch.distributed.sharding import gather
from repro_torch.train.step import ShardedTrainState, shard_train_state


def _sharded_to_jax(state: ShardedTrainState) -> dict[str, np.ndarray] | None:
    """A sharded state's whole arrays under train_state_to_jax's keys, on
    rank 0; None on the others. Every rank takes part in gathering each
    tensor whole (a collective), one at a time; only rank 0 keeps it, on
    the host."""
    root = dist.get_rank() == 0
    flat = {}
    for prefix, blocks in ((".params/", state.params), (".opt/.m/", state.opt.m),
                           (".opt/.v/", state.opt.v)):
        whole = {}
        for n, x in blocks.items():
            w = gather(x, state.specs[n], state.mesh)
            if root:
                whole[n] = w.cpu()
            del w
        if root:
            flat.update({prefix + k: v for k, v in named_to_jax(whole, state.lm.cfg).items()})
    if not root:
        return None
    flat[".opt/.count"] = np.asarray(int(state.opt.count), np.int32)
    flat[".step"] = np.asarray(state.step, np.int32)
    return flat


def _sharded_from_jax(flat, state: ShardedTrainState) -> ShardedTrainState:
    cfg = state.lm.cfg

    def part(prefix):
        return params_from_jax({k[len(prefix):]: v for k, v in flat.items()
                                if k.startswith(prefix)}, cfg)
    count = torch.tensor(int(flat[".opt/.count"]), dtype=torch.int32)
    return shard_train_state(state, part(".params/"), part(".opt/.m/"),
                             part(".opt/.v/"), count, int(flat[".step"]))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state, extras: dict[str, Any] | None = None,
             block: bool = False):
        sharded = isinstance(state, ShardedTrainState)
        arrays = _sharded_to_jax(state) if sharded else train_state_to_jax(state)
        self.wait()
        if sharded:
            if arrays is not None:   # rank 0
                self._write(step, arrays, extras or {})
            dist.barrier()
            return
        if not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, extras or {}))
            self._thread.start()
        else:
            self._write(step, arrays, extras or {})

    def _write(self, step: int, arrays: dict, extras: dict):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "extras": extras,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        open(os.path.join(tmp, ".COMPLETE"), "w").close()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, ".COMPLETE")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, state):
        """Load checkpoint `step` into `state`'s LM (in place) and return
        (the restored TrainState, extras); a ShardedTrainState gets this
        rank's blocks of the whole arrays, by its own specs on its own
        mesh."""
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k: data[k] for k in data.files}
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if isinstance(state, ShardedTrainState):
            return _sharded_from_jax(flat, state), manifest.get("extras", {})
        return train_state_from_jax(flat, state.lm), manifest.get("extras", {})

    def restore_latest(self, state):
        step = self.latest_step()
        if step is None:
            return None, None, {}
        state, extras = self.restore(step, state)
        return step, state, extras
