"""Production meshes on ``torch.distributed``: the JAX package's
``launch/mesh.py``.

Single: ``(16, 16)`` = 256 ranks, axes ``("data", "model")``.
Multi:  ``(2, 16, 16)`` = 512 ranks, axes ``("pod", "data", "model")`` --
"pod" is an outer data axis.

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
default process group, which the caller has initialised (``run_world``,
``torch.distributed.init_process_group``) or which :func:`fake_world`
opens: a ``"fake"`` group of any size whose collectives move nothing, so
a dry run traces a 256- or 512-rank step in one process on meta tensors
(the counterpart of the JAX package's
``--xla_force_host_platform_device_count`` virtual devices).  Everything
here is a function: importing the module touches no process group.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def _mesh(shape, axes, device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one (run_world, fake_world or "
                           "torch.distributed.init_process_group) before making a mesh")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the default "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The ``(16, 16)`` mesh (``multi_pod``: ``(2, 16, 16)``) over the
    default process group, which must have 256 (512) ranks."""
    shape, axes = MULTI if multi_pod else SINGLE
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type: str = "cuda") -> DeviceMesh:
    """A small mesh over the default process group (tests, one card)."""
    return _mesh(shape, axes, device_type)


def data_axes(mesh) -> tuple:
    """All non-"model" axes -- the batch / pure-data-parallel dimensions."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``"fake"`` default process group of ``world_size`` ranks, this
    process rank 0, destroyed on exit.  Its collectives return at once and
    move nothing: a step run in it on meta tensors is a trace of
    rank 0's share of the work.  Raises if a default group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
