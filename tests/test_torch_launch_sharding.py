"""The port's sharding rules against the reference's (the twin of
``tests/test_sharding_rules.py``): every parameter leaf of all ten archs at
full size (reference: ``jax.eval_shape``; port: meta tensors) and every
supported decode shape's cache get the same spec; the reference's
divisibility and no-replicated-giants checks on the port's trees;
``placements`` on a mesh, batch shardings, ``shard_tree``, and the
elastic checkpoint reshard on a world of four gloo ranks."""
import math
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import ARCH_IDS, get_config
from repro.launch.sharding import _path_str, cache_spec, spec_for_param
from repro.models import SHAPES, cell_supported, input_specs
from repro.models.transformer import init_params
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import run_world
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_sh
from repro_torch.models.config import input_specs as t_input_specs
from repro_torch.train.tree import paths

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch_world as world  # noqa: E402

AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _ref_specs(arch):
    shapes = jax.eval_shape(lambda k: init_params(get_config(arch), k), jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {_path_str(p): (tuple(leaf.shape), tuple(spec_for_param(_path_str(p),
                                                                   len(leaf.shape))))
            for p, leaf in flat}


def _at(tree, path: str):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _port_specs(arch):
    """``param_spec_tree``'s spec of each leaf of the port's meta tree."""
    cfg = t_get_config(arch)
    specs = t_sh.param_spec_tree(cfg)
    return {k: (tuple(t.shape), _at(specs, k)) for k, t in paths(t_sh._meta_params(cfg))}


def _check_divisible(spec, shape, ctx):
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        total = math.prod(AXIS_SIZES[a] for a in axes)
        assert dim % total == 0, f"{ctx}: dim {dim} not divisible by {axes}={total}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    """Same leaves, shapes and specs at full size; the reference's
    divisibility, "bulk sharded" and no-replicated-giants checks."""
    ref, port = _ref_specs(arch), _port_specs(arch)
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert port[k] == ref[k], (arch, k, port[k], ref[k])
    n_sharded = 0
    for k, (shape, spec) in port.items():
        _check_divisible(spec, shape, f"{arch}:{k}")
        n_sharded += any(ax is not None for ax in spec)
        if math.prod(shape) * 4 > 64 * 2**20:
            assert any(ax is not None for ax in spec), f"{arch}:{k} replicated"
    assert n_sharded >= len(port) // 3


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch):
    cfg, tcfg = get_config(arch), t_get_config(arch)
    for shape in SHAPES.values():
        if shape.kind != "decode" or not cell_supported(cfg, shape)[0]:
            continue
        flat = jax.tree_util.tree_flatten_with_path(input_specs(cfg, shape)["cache"])[0]
        ref = {"cache/" + _path_str(p): (tuple(leaf.shape),
                                         tuple(cache_spec(cfg, "cache/" + _path_str(p),
                                                          leaf.shape, ("data",))))
               for p, leaf in flat}
        port = {"cache/" + k: (tuple(t.shape),
                               t_sh.cache_spec(tcfg, "cache/" + k, tuple(t.shape), ("data",)))
                for k, t in paths(t_input_specs(tcfg, shape)["cache"])}
        assert port == ref, (arch, shape.name)
        for k, (sh, spec) in port.items():
            _check_divisible(spec, sh, f"{arch}:{shape.name}:{k}")


def test_placements_and_shardings():
    """Specs to placements on a (2, 2, 2) mesh of a fake world (in a child
    process), the widened FSDP axis ("pod", "data") major first;
    refusals; the shardings of a train batch, an opt state and a decode
    cache; ``shard_tree``'s local block."""
    world.in_child(world.placements_case)
    with pytest.raises(RuntimeError, match="no process group"):
        t_mesh.make_test_mesh(device_type="cpu")


def test_elastic_checkpoint_reshard_across_meshes():
    """The twin of the reference's: saved sharded on a (4,) mesh (every rank
    gathers, rank 0 writes), restored onto a (2, 2) mesh layout."""
    with tempfile.TemporaryDirectory() as d:
        out = run_world(world.reshard, 4, timeout=240, args=(d,))
    want = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for step, w, place, local in out:
        assert step == 1
        np.testing.assert_array_equal(w, want)
        assert place == ("S(0)", "S(1)") and local == (4, 4)
