"""Checkpointing with async save and restore (port of
``repro.checkpoint.checkpointer``), in the reference's on-disk format.

Format: ``<path>/arrays.npz`` with one array ``leaf_<i>`` per leaf of the
state tree in jax's flatten order (``training.tree.leaves``: dict keys
sorted), bf16 upcast to fp32 (lossless; numpy has no bf16), and
``<path>/manifest.json`` with the step, the leaf count, each leaf's shape
and original dtype, a description of the tree, ``extra`` and the time.
A state saved in the reference's layout (``launch.train.state_tree``)
restores in either package: the reference reads the leaves by index and
casts each to its ``like`` leaf's dtype, as ``restore`` here does.  The
tree description is the port's own; neither package reads it back.

Fault-tolerance contract (``launch/train.py``):

* saves are atomic (written to ``<path>.tmp``, then renamed);
* the latest complete checkpoint wins; partial writes are ignored;
* ``AsyncCheckpointer.save`` copies the state to the host before it
  returns and writes it on a background thread: training continues, and
  its in-place updates do not reach the snapshot;
* the data cursor is the step (synthetic data is (seed, step)
  deterministic), so a restart resumes where the checkpoint left off.

The reference's resharding (``shardings``) has no counterpart: ``restore``
places each leaf on its ``like`` leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.training.tree import leaves, tree_map, unflatten


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _host(x) -> np.ndarray:
    """A leaf as numpy on the host; bf16 (and other types numpy cannot
    hold) upcast to fp32."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    arr = np.asarray(x)
    return arr if arr.dtype.kind in "biufc" else arr.astype(np.float32)


def _describe(state) -> str:
    if isinstance(state, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(state[k])}" for k in sorted(state)) + "}"
    if isinstance(state, (list, tuple)):
        inner = ", ".join(_describe(v) for v in state)
        return f"({inner})" if isinstance(state, tuple) else f"[{inner}]"
    return "*"


def save(path: str, state: Any, *, step: int, extra: dict | None = None) -> None:
    """Synchronous atomic checkpoint save."""
    flat = leaves(state)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    meta_leaves = []
    for i, leaf in enumerate(flat):
        arr = _host(leaf)
        arrays[f"leaf_{i}"] = arr
        meta_leaves.append(dict(shape=list(arr.shape), dtype=_dtype_name(leaf)))
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = dict(
        step=step,
        n_leaves=len(flat),
        leaves=meta_leaves,
        treedef=_describe(state),
        extra=extra or {},
        time=time.time(),
    )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def restore(path: str, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    as a tensor of its ``like`` leaf's dtype on that leaf's device."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = leaves(like)
    if manifest["n_leaves"] != len(flat):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(flat)}")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, ref in enumerate(flat):
            arr = torch.from_numpy(np.array(z[f"leaf_{i}"]))
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"leaf {i} shape mismatch: checkpoint "
                                 f"{list(arr.shape)}, expected {list(ref.shape)}")
            out.append(arr.to(device=ref.device, dtype=ref.dtype))
    return unflatten(like, out), manifest


def latest_step(root: str) -> int | None:
    """The newest complete checkpoint under root (``ckpt_<step>`` dirs)."""
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        if not name.startswith("ckpt_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(root, name, "manifest.json")):
            continue
        step = int(name.split("_", 1)[1])
        best = step if best is None else max(best, step)
    return best


class AsyncCheckpointer:
    """Background-thread checkpointer; keeps the last ``keep`` checkpoints."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None

    def save(self, state: Any, *, step: int, extra: dict | None = None,
             block: bool = False) -> None:
        self.wait()
        # snapshot to the host BEFORE returning: the step updates in place
        host_state = tree_map(_host_copy, state)

        def work():
            path = os.path.join(self.root, f"ckpt_{step}")
            save(path, host_state, step=step, extra=extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: Any):
        step = latest_step(self.root)
        if step is None:
            return None
        return restore(os.path.join(self.root, f"ckpt_{step}"), like)

    def _gc(self):
        steps = sorted(
            int(n.split("_", 1)[1])
            for n in os.listdir(self.root)
            if n.startswith("ckpt_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.root, n, "manifest.json"))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"ckpt_{s}"), ignore_errors=True)


def _host_copy(x):
    """A leaf copied to the host, its dtype kept (a tensor stays a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)
