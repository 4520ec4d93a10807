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

A state with DTensor leaves (``launch.sharding.shard_tree``) is saved by
every rank of the world at once: each leaf is gathered whole
(``full_tensor``, a collective) and rank 0 writes.  ``restore_checkpoint``
puts it back onto any mesh (``shardings=`` a tree of
``launch.sharding.NamedSharding``): the JAX package's elastic restart.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .tree import leaves, map_with_path, paths, tree_map


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _flatten(tree) -> dict:
    return {key: _host(leaf) for key, leaf in paths(tree)}


def _treedef_of(tree) -> str:
    return str(tree_map(lambda _: "*", tree))


def _writes(state) -> bool:
    """Whether this process writes ``state``: always, unless its leaves
    are DTensors, which every rank gathers and rank 0 writes."""
    sharded = any(isinstance(x, DTensor) for x in leaves(state))
    return not sharded or dist.get_rank() == 0


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    state: Any,
    keep_n: int = 3,
    extra_meta: Optional[dict] = None,
):
    """Synchronous atomic save of a tree ``state`` (DTensor leaves: on
    every rank, which gather; rank 0 writes)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not _writes(state):
        _flatten(state)
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(state)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

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
    its name) for every leaf, or a tree of them shaped like ``like``, or a
    tree of ``launch.sharding.NamedSharding`` (``param_shardings``'
    form): each leaf a DTensor on its mesh (every rank of the mesh calls
    this; each reads the file and keeps its own part).

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
            state = (tree_map(lambda t: _place(t, shardings), state)
                     if hasattr(shardings, "mesh") else tree_map(_place, state, shardings))
    return state, int(manifest["step"])


def _place(t: torch.Tensor, where):
    """``t`` on a device, or (a ``NamedSharding``) a DTensor on its mesh."""
    if isinstance(where, (str, torch.device)):
        return t.to(where)
    from ..launch.sharding import shard_tree

    dev = torch.device(where.mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return shard_tree(t.to(dev), where)


class AsyncCheckpointer:
    """Background-thread saver: snapshot on host, write off the critical path."""

    def __init__(self, ckpt_dir: str, keep_n: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Any, extra_meta: Optional[dict] = None):
        self.wait()  # one in flight at a time
        writes = _writes(state)
        host_state = tree_map(_host, state)
        if not writes:
            return
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
