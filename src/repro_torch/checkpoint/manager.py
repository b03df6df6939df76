"""Checkpointing: atomic, async, elastic, as ``repro.checkpoint.manager``,
in the reference's file format, so that a checkpoint moves between the two
packages.

- save(): flattens a tree (nested dicts, tuples and lists of tensors,
  numpy arrays or numbers) to npz under the reference's keypaths
  (``jax.tree_util.keystr``: ``[0]['layers']['attn']['wq']``), writes to
  a temp dir, atomically renames it to ``step_N`` and updates ``LATEST``.
  bf16 leaves ride as a uint16 view with a dtype sidecar in meta.json, as
  the reference writes them.  Async mode hands the host copies to a
  background thread so the train loop never blocks on disk.
- restore(): loads by keypath into the structure of a target tree and
  puts each leaf on ``device`` (the target leaf's own, or the CPU for a
  ``meta`` target, the port's ``ShapeDtypeStruct``): saved arrays are
  full logical values, so a checkpoint written on one device restores
  onto another (elastic).  Missing keys keep the target's value (partial
  restore of a grown model).
- keep_last trims old checkpoints.

Trees are the caller's layout: the train driver writes the reference's
parameter and optimizer layout (``weights.to_jax_layout``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

_SIDECAR = {torch.bfloat16: "bfloat16"}


def _paths(tree, prefix=""):
    """(keystr path, leaf) of every leaf; dict keys sorted as jax sorts
    them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _host(leaf):
    """A leaf as a numpy array, and its dtype sidecar name or None."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _SIDECAR:
            return t.view(torch.int16).numpy().view(np.uint16), \
                _SIDECAR[t.dtype]
        return t.numpy(), None
    return np.asarray(leaf), None


def _flatten(tree):
    """Keypath -> np array, and keypath -> dtype name for the leaves that
    have no numpy dtype (bf16, as a uint16 view)."""
    arrays, dtypes = {}, {}
    for key, leaf in _paths(tree):
        a, name = _host(leaf)
        if name is not None:
            dtypes[key] = name
        arrays[key] = a
    return arrays, dtypes


def _rebuild(tree, fn, prefix=""):
    """The tree with each leaf replaced by fn(keystr path, leaf)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None):
        """Snapshot to host memory now; write to disk (possibly async)."""
        arrays, dtypes = _flatten(tree)  # device->host transfer happens here
        meta = dict(metadata or {}, step=step, time=time.time(),
                    dtypes=dtypes)
        if self._pool is not None:
            self.wait()                  # one outstanding save at a time
            self._pending = self._pool.submit(self._write, step, arrays,
                                              meta)
        else:
            self._write(step, arrays, meta)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, arrays, meta):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, final)
        with self._lock:
            latest = os.path.join(self.dir, "LATEST.tmp")
            with open(latest, "w") as f:
                f.write(str(step))
            os.replace(latest, os.path.join(self.dir, "LATEST"))
        self._trim()

    def _trim(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                s = int(f.read().strip())
            if os.path.exists(os.path.join(self.dir, f"step_{s}")):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, device=None):
        """Restore into the structure of ``target`` (tensors, ``meta``
        tensors or numpy arrays): each saved leaf as a tensor in its saved
        dtype on ``device`` (default: the target leaf's device; the CPU
        for a meta or numpy target).  Missing keys keep the target's
        value."""
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        data = np.load(path)
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            dtypes = json.load(f).get("dtypes", {})

        def leaf(key, old):
            if key not in data.files:
                return old
            arr = data[key]
            if key in dtypes:
                if dtypes[key] != "bfloat16":
                    raise TypeError(f"{key}: dtype {dtypes[key]!r} has no "
                                    f"torch counterpart here")
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            dev = device
            if dev is None and isinstance(old, torch.Tensor) \
                    and old.device.type != "meta":
                dev = old.device
            return t.to(dev) if dev is not None else t

        return _rebuild(target, leaf)

    def restore_latest(self, target: Any, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target, device)
