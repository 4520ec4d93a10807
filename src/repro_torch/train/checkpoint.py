"""Checkpointing with atomic publish, keep-N retention, async save and
restore onto another device.

Layout:  <dir>/step_<N>/arrays.npz + manifest.json, published by writing to
``step_<N>.tmp`` and ``os.rename``-ing (atomic on POSIX).  ``LATEST`` is a
one-line pointer file rewritten after publish, so a crashed writer can never
corrupt the last good checkpoint -- the restart path reads LATEST, falls
back to the newest complete step dir, and resumes.

The array names are the JAX package's, letter for letter (``tree.paths``:
``params/embed/table``, ``1/.m/segments/0/attn/wq/w``, ``1/.step``), so a
checkpoint written by either package restores in the other.  numpy has no
bfloat16, so bfloat16 leaves are saved widened to float32 (exact) and
narrowed again on restore; a 2-byte raw array (what the JAX package's
``np.savez`` writes for its bfloat16 leaves) is read as bfloat16 bits.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .tree import map_with_path, paths, tree_map


def _host(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _flatten(tree) -> dict:
    return {key: _host(leaf) for key, leaf in paths(tree)}


def _treedef_of(tree) -> str:
    return str(tree_map(lambda _: "*", tree))


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    state: Any,
    keep_n: int = 3,
    extra_meta: Optional[dict] = None,
):
    """Synchronous atomic save of a tree ``state``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "treedef": _treedef_of(state),
        **(extra_meta or {}),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(os.path.basename(final))
    _retain(ckpt_dir, keep_n)
    return final


def _retain(ckpt_dir: str, keep_n: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_n]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step_dir(ckpt_dir: str) -> Optional[str]:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            cand = os.path.join(ckpt_dir, f.read().strip())
        if os.path.isdir(cand):
            return cand
    except FileNotFoundError:
        pass
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ) if os.path.isdir(ckpt_dir) else []
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def _tensor(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # raw bfloat16 bits
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    t = torch.from_numpy(np.array(arr).reshape(tuple(like.shape)))
    return t.to(device=device, dtype=like.dtype)


def restore_checkpoint(
    ckpt_dir: str,
    like: Any,
    shardings: Any = None,
) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors), each leaf
    in its dtype on its device, or on ``shardings``: a ``torch.device`` (or
    its name) for every leaf, or a tree of them shaped like ``like`` (the
    one-host form of restoring onto another placement).

    Returns (state, step); (like, 0) if no checkpoint exists.
    """
    d = latest_step_dir(ckpt_dir)
    if d is None:
        return like, 0
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        if shardings is None or isinstance(shardings, (str, torch.device)):
            state = map_with_path(
                lambda key, leaf: _tensor(arrays[key], leaf,
                                          leaf.device if shardings is None else shardings),
                like)
        else:
            state = map_with_path(lambda key, leaf: _tensor(arrays[key], leaf, None), like)
            state = tree_map(lambda t, dev: t.to(dev), state, shardings)
    return state, int(manifest["step"])


class AsyncCheckpointer:
    """Background-thread saver: snapshot on host, write off the critical path."""

    def __init__(self, ckpt_dir: str, keep_n: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Any, extra_meta: Optional[dict] = None):
        self.wait()  # one in flight at a time
        host_state = tree_map(_host, state)
        self._thread = threading.Thread(
            target=save_checkpoint,
            args=(self.ckpt_dir, step, host_state, self.keep_n, extra_meta),
            daemon=True,
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
