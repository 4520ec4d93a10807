"""The port's LM serving path (``repro_torch.configs``, ``.models``,
``.train.serve_step``) against the reference's for the two granite
architectures (GQA attention + SwiGLU; the other dense-family archs are in
``tests/test_torch_lm_serve_qwen.py`` and
``tests/test_torch_lm_serve_backbones.py``), on their SMOKE configs on the
CPU; plus the configs, parameter counts, cache and input specs of every
architecture, and the port's refusals.  The files are split so that
``--dist loadfile`` spreads the reference's runs over workers.

Contracts (weights carried over from the reference's ``init_params``):
  * float32: ``forward_train`` logits, ``prefill`` logits and every cache
    leaf, ``prefill_to_decode_cache`` leaf by leaf and 4 ``decode_step``s
    (logits and caches) within ``rtol = atol = 1e-4``; ``generate``'s
    tokens equal;
  * ``param_count``/``active_param_count``, ``init_cache`` and
    ``input_specs`` equal the reference's (shapes and dtypes; the MoE/MLA
    architectures' specs included);
  * bfloat16: ``tests/test_torch_lm_bfloat16.py``;
  * float64: the port's prefill + decode against its own full forward, at
    the reference test's tolerance (``test_archs_smoke.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_lm_common as lm
from repro.configs import ARCH_IDS, get_config
from repro.models import SHAPES, cell_supported, input_specs
from repro.models import transformer as r_tf
from repro_torch import configs as t_configs
from repro_torch.models import config as t_config
from repro_torch.models import transformer as t_tf
from repro_torch.train import serve_step as t_serve

# The other dense-family archs: test_torch_lm_serve_qwen.py (qwen2-0.5b) and
# test_torch_lm_serve_backbones.py (chatglm3-6b, musicgen-medium, internvl2-1b).
DENSE = ["granite-3-2b", "granite-3-8b"]
WITHOUT_EXPERTS = DENSE + ["qwen2-0.5b", "chatglm3-6b", "musicgen-medium", "internvl2-1b",
                           "mamba2-780m", "recurrentgemma-9b"]
EXPERTS = ["deepseek-v2-236b", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_logits(arch):
    lm.check_forward(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_caches(arch):
    lm.check_prefill(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_to_decode_cache(arch):
    lm.check_decode_cache(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps(arch):
    lm.check_decode_steps(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_generate_tokens(arch):
    lm.check_generate(arch)


def test_prefill_decode_matches_full_forward():
    lm.self_consistency("granite-3-2b")


# ---------------------------------------------------------------------------
# Configs, parameter counts, cache and input specs (every architecture)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_field_for_field(arch):
    assert t_configs.ARCH_IDS == ARCH_IDS
    for smoke in (False, True):
        want = dataclasses.asdict(get_config(arch, smoke))
        got = dataclasses.asdict(t_configs.get_config(arch, smoke))
        assert got == want
        assert t_configs.get_config(arch, smoke).segments() == get_config(arch, smoke).segments()
    from repro.configs import all_cells

    assert list(t_configs.all_cells()) == list(all_cells())


@pytest.mark.parametrize("arch", WITHOUT_EXPERTS)
def test_param_counts(arch):
    for smoke in (False, True):
        cfg = get_config(arch, smoke)
        tcfg = t_configs.get_config(arch, smoke)
        assert t_tf.param_count(tcfg) == r_tf.param_count(cfg)
        assert t_tf.active_param_count(tcfg) == r_tf.active_param_count(cfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_and_input_specs(arch):
    for smoke in (False, True):
        cfg = get_config(arch, smoke)
        tcfg = t_configs.get_config(arch, smoke)
        want = r_tf.init_cache(cfg, batch=2, s_max=48)
        got = t_tf.init_cache(tcfg, batch=2, s_max=48, device="cpu")
        lm.assert_same_specs(got, want, "init_cache")
        assert all(not bool(x.any()) for x in jax.tree.leaves(got))
        for shape in SHAPES.values():
            assert t_config.cell_supported(tcfg, t_config.SHAPES[shape.name]) == \
                cell_supported(cfg, shape)
            specs = t_config.input_specs(tcfg, t_config.SHAPES[shape.name])
            assert all(x.device.type == "meta" for x in jax.tree.leaves(specs))
            lm.assert_same_specs(specs, input_specs(cfg, shape), f"input_specs {shape.name}")


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_params_from_reference_refuses_a_mismatch():
    cfg, tcfg = lm.configs("granite-3-2b")
    tree = lm.reference_run("granite-3-2b")["params"]
    model = t_tf.params_from_reference(tcfg, tree, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert {"embed.table", "final_norm.scale", "segments.0.attn.wq.w",
            "segments.0.mlp.w_down"} <= names
    assert model.segments[0].attn.wq.w.shape[0] == cfg.num_layers  # stacked (count, ...)
    missing = jax.tree.map(lambda x: x, tree)
    del missing["segments"][0]["attn"]["wq"]["w"]
    with pytest.raises(ValueError, match="left unset.*segments.0.attn.wq.w"):
        t_tf.params_from_reference(tcfg, missing, device="cpu")
    extra = jax.tree.map(lambda x: x, tree)
    extra["segments"][0]["attn"]["wq"]["b"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="left unused.*segments.0.attn.wq.b"):
        t_tf.params_from_reference(tcfg, extra, device="cpu")
    bad = jax.tree.map(lambda x: x, tree)
    bad["embed"]["table"] = bad["embed"]["table"][:-1]
    with pytest.raises(ValueError, match="embed.table: shape"):
        t_tf.params_from_reference(tcfg, bad, device="cpu")


@pytest.mark.parametrize("arch", EXPERTS)
def test_experts_and_mla_are_part_two(arch):
    """The calls that raised before part two (item 15) was ported now run:
    the parameter counts equal the reference's, ``params_from_reference``
    checks its tree, and ``forward_train`` gives finite logits (the serving
    and training contracts: ``test_torch_lm_serve_moe.py``,
    ``test_torch_train_moe.py``, ``test_torch_train_deepseek.py``)."""
    for smoke in (False, True):
        cfg, tcfg = get_config(arch, smoke), t_configs.get_config(arch, smoke)
        assert t_tf.param_count(tcfg) == r_tf.param_count(cfg)
        assert t_tf.active_param_count(tcfg) == r_tf.active_param_count(cfg)
    model = t_tf.init_params(tcfg, 0, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == t_tf.param_count(tcfg)
    with pytest.raises(ValueError, match="left unset"):
        t_tf.params_from_reference(tcfg, {}, device="cpu")
    with torch.no_grad():
        logits, aux = t_tf.forward_train(model, tcfg, np.zeros((1, 2), np.int32))
    assert bool(torch.isfinite(logits).all()) and float(aux) > 0


def test_sharding_is_refused():
    """Sharding runs on DTensor (``tests/test_torch_launch_*.py``); what is
    refused is a ``shd=`` that is no Sharder, a ``mesh=`` that is no
    ``DeviceMesh`` and a production mesh without a process group."""
    from repro_torch.launch.mesh import make_production_mesh

    _, tcfg = lm.configs("granite-3-2b")
    model = lm.port_run("granite-3-2b")["model"]
    with pytest.raises(TypeError, match=r"Sharder"):
        t_tf.forward_train(model, tcfg, np.zeros((1, 2), np.int32), shd=object())
    with pytest.raises(TypeError, match=r"DeviceMesh"):
        t_serve.make_serve_step(tcfg, mesh=object())
    with pytest.raises(RuntimeError, match=r"no process group"):
        make_production_mesh(device_type="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    _, tcfg = lm.configs("granite-3-2b")
    tree = lm.reference_run("granite-3-2b")["params"]
    for call in (lambda: t_tf.init_params(tcfg, 0),
                 lambda: t_tf.params_from_reference(tcfg, tree),
                 lambda: t_tf.init_cache(tcfg, 2, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
