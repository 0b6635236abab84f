"""Async checkpointing with restore onto the current devices.

Format (the reference's, so a checkpoint written by either package loads in
the other): one ``step_<N>/`` directory per checkpoint holding
``shards.npz`` with the flattened leaves as ``leaf_<i>`` (``jax.tree_util``
order: dict keys sorted at every level, ``train/tree.py``), a
``manifest.json`` with the step, the leaf count and the tree's structure,
and a ``COMMITTED`` marker written last, so a partly written checkpoint is
never restored.  ``reshard_restored`` puts each loaded array on the device
of the like tensor, in its dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten, treedef_str


class SimulatedFailure(RuntimeError):
    """Raised by test fail_hooks to simulate a node crash."""


def _host_copy(x) -> np.ndarray:
    """A numpy copy of a tensor or array that later in-place updates of the
    tensor do not reach."""
    if isinstance(x, torch.Tensor):
        arr = x.detach().cpu().numpy()
        return arr.copy() if x.device.type == "cpu" else arr
    return np.array(x)


def save_pytree(path: str, tree, step: int) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = tree_leaves(tree)
    arrs = {f"leaf_{i}": _host_copy(leaf) for i, leaf in enumerate(leaves)}
    np.savez(os.path.join(path, "shards.npz"), **arrs)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves), "treedef": treedef_str(tree)}, f)
    # commit marker makes partially-written checkpoints detectable
    with open(os.path.join(path, "COMMITTED"), "w") as f:
        f.write(str(step))


def load_pytree(path: str, like_tree) -> Tuple[Any, int]:
    """(the checkpoint's leaves as numpy arrays in a tree shaped like
    ``like_tree``, its step)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "shards.npz"))
    leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    return tree_unflatten(like_tree, leaves), manifest["step"]


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writes on a background thread.

    ``save`` copies to host memory synchronously (so the training step may
    update the device tensors in place right after) and writes to disk
    asynchronously; ``wait`` joins outstanding writes.  Keeps the newest
    ``keep`` committed checkpoints.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    def save(self, step: int, params, opt_state) -> None:
        host = tree_map(_host_copy, (params, opt_state))
        self.wait()
        self._pending = self._pool.submit(self._write, step, host)

    def _write(self, step: int, host_tree) -> None:
        path = os.path.join(self.dir, f"step_{step:08d}")
        save_pytree(path, host_tree, step)
        self._gc()

    def _gc(self) -> None:
        with self._lock:
            cks = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
            committed = [d for d in cks
                         if os.path.exists(os.path.join(self.dir, d, "COMMITTED"))]
            for d in committed[: -self.keep] if self.keep else []:
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def latest_path(self) -> Optional[str]:
        if not os.path.isdir(self.dir):
            return None
        cks = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in reversed(cks):
            if os.path.exists(os.path.join(self.dir, d, "COMMITTED")):
                return os.path.join(self.dir, d)
        return None

    def restore_latest(self, block: bool = False):
        if block:
            self.wait()
        return self.latest_path()  # opaque handle consumed by reshard_restored


def reshard_restored(path_or_tree, params_like, opt_like):
    """Load a checkpoint and put each array on the device of the like
    tensor in ``params_like``/``opt_like``, in its dtype.  Returns (params,
    opt_state, step)."""
    (params, opt_state), step = load_pytree(path_or_tree, (params_like, opt_like))

    def put(arr, like):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)

    return tree_map(put, params, params_like), tree_map(put, opt_state, opt_like), step
