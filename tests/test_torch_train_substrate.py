"""The port's training substrate (``repro_torch.train.optimizer``,
``.checkpoint``, ``repro_torch.data.tokens``, ``repro_torch.launch.train``)
on the CPU: twins of ``tests/test_train_substrate.py``, and the port held to
the reference (``src/repro``) where both compute the same thing:
  * ``make_batch``: bitwise equal batches for several ``(seed, step, shard)``;
  * ``adamw_update`` (and ``cosine_lr``, clipping, int8 compression) on the
    same params, grads and state carried across as numpy: within
    ``rtol = 1e-6``, ``atol = 1e-6 x`` the leaf's largest magnitude (the
    learning rate's: ``lr_peak``), a few float32 steps: the schedule's
    ``cos`` and the bias corrections' ``pow`` may round their last bit
    apart, and ``lr_min + c * (1 + cos)`` cancels near the end;
  * checkpoints: the array names letter for letter, and a checkpoint
    written by either package restored by the other, values bitwise;
  * the launcher (``--device cpu``): a run resumed from its step-3
    checkpoint reproduces the uninterrupted run's losses bitwise;
  * ``examples/torch_train_lm.py``: its ``CFG``, steps and shapes equal the
    reference example's (its full run is on the card: ``chip_smoke.py``).
"""
import ast
import dataclasses
import functools
import importlib.util
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import tokens as r_tokens
from repro.models import transformer as r_tf
from repro.models.config import ModelConfig
from repro.train import checkpoint as r_ckpt
from repro.train import optimizer as r_opt
from repro_torch.configs import get_config as t_get_config
from repro_torch.data.tokens import DataConfig, TokenStream, make_batch
from repro_torch.launch import train as t_launch
from repro_torch.models import transformer as t_tf
from repro_torch.train import optimizer as t_opt
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    latest_step_dir,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
    compress_grads,
    cosine_lr,
    global_norm,
    init_opt_state,
)
from repro_torch.train.tree import paths, tree_map

ROOT = Path(__file__).resolve().parent.parent


class TestOptimizer:
    def test_adamw_minimizes_quadratic(self):
        cfg = OptimizerConfig(lr_peak=0.1, lr_min=0.01, warmup_steps=5,
                              total_steps=200, weight_decay=0.0)
        params = {"w": torch.tensor([5.0, -3.0, 2.0])}
        state = init_opt_state(params, cfg)
        for _ in range(200):
            g = {"w": 2 * params["w"]}  # grad of sum(w^2)
            params, state, _ = adamw_update(params, g, state, cfg)
        assert float(torch.sum(params["w"] ** 2)) < 1e-3

    def test_weight_decay_shrinks(self):
        cfg = OptimizerConfig(lr_peak=0.1, warmup_steps=0, total_steps=10,
                              weight_decay=0.5)
        params = {"w": torch.tensor([10.0])}
        state = init_opt_state(params, cfg)
        params, state, _ = adamw_update(params, {"w": torch.tensor([0.0])}, state, cfg)
        assert float(params["w"][0]) < 10.0

    def test_clip_by_global_norm(self):
        g = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
        clipped, norm = clip_by_global_norm(g, 1.0)
        assert abs(float(norm) - 5.0) < 1e-6
        assert abs(float(global_norm(clipped)) - 1.0) < 1e-5

    def test_cosine_schedule_endpoints(self):
        cfg = OptimizerConfig(lr_peak=1.0, lr_min=0.1, warmup_steps=10,
                              total_steps=100)
        step = lambda n: torch.tensor(n, dtype=torch.int32)  # noqa: E731
        assert float(cosine_lr(cfg, step(0))) == 0.0
        assert abs(float(cosine_lr(cfg, step(10))) - 1.0) < 1e-6
        assert abs(float(cosine_lr(cfg, step(100))) - 0.1) < 1e-6

    def test_bf16_state_dtype(self):
        cfg = OptimizerConfig(state_dtype="bfloat16")
        params = {"w": torch.ones(4)}
        state = init_opt_state(params, cfg)
        assert state.m["w"].dtype == torch.bfloat16
        g = {"w": torch.full((4,), 0.1, dtype=torch.bfloat16)}
        params2, state2, _ = adamw_update(params, g, state, cfg)
        assert state2.m["w"].dtype == torch.bfloat16
        assert params2["w"].dtype == torch.float32

    def test_grad_compression_error_feedback(self):
        g = {"w": torch.tensor([0.1, -0.25, 0.7])}
        ef = {"w": torch.zeros(3)}
        gq, ef2 = compress_grads(g, ef)
        # Quantized + residual reconstructs the original exactly.
        np.testing.assert_allclose((gq["w"] + ef2["w"]).numpy(), g["w"].numpy(), rtol=1e-6)

    def test_update_returns_new_trees(self):
        """Functional, as the reference's: the inputs are left as they were."""
        cfg = OptimizerConfig(warmup_steps=0, total_steps=10)
        params = {"w": torch.ones(3)}
        state = init_opt_state(params, cfg)
        new, state2, _ = adamw_update(params, {"w": torch.ones(3)}, state, cfg)
        assert torch.equal(params["w"], torch.ones(3)) and int(state.step) == 0
        assert int(state2.step) == 1 and not torch.equal(new["w"], params["w"])


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


@pytest.mark.parametrize("fields", [{}, {"state_dtype": "bfloat16"}, {"grad_compress": True}],
                         ids=["float32", "bf16_state", "grad_compress"])
def test_adamw_update_matches_reference(fields):
    """Three steps on the same params and grads (one leaf per shape class,
    a gradient norm past the clip), state carried across each step."""
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)},
              "d": [rng.standard_normal((2, 3)).astype(np.float32)]}
    kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=8, **fields)
    r_cfg, t_cfg = r_opt.OptimizerConfig(**kw), t_opt.OptimizerConfig(**kw)
    rp = jax.tree.map(jnp.asarray, params)
    rs = r_opt.init_opt_state(rp, r_cfg)
    tp = tree_map(torch.tensor, params)
    ts = t_opt.init_opt_state(tp, t_cfg)
    for _ in range(3):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3).astype(np.float32),
                             params)
        rp, rs, rm = r_opt.adamw_update(rp, jax.tree.map(jnp.asarray, grads), rs, r_cfg)
        tp, ts, tm = t_opt.adamw_update(tp, tree_map(torch.tensor, grads), ts, t_cfg)
        assert int(ts.step) == int(rs.step)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6,
                                   atol=1e-6 * kw["lr_peak"])
        sdt = torch.bfloat16 if fields.get("state_dtype") == "bfloat16" else torch.float32
        assert {t.dtype for _, t in paths(ts.m) + paths(ts.v)} == {sdt}
        assert {t.dtype for _, t in paths(tp)} == {torch.float32}
        for got, want in ((tp, rp), (ts.m, rs.m), (ts.v, rs.v), (ts.ef, rs.ef)):
            want = dict(paths(_np_tree(want)))
            for key, t in paths(got):
                scale = float(np.abs(want[key]).max())
                np.testing.assert_allclose(t.float().numpy(), want[key], rtol=1e-6,
                                           atol=1e-6 * scale, err_msg=key)


def test_cosine_lr_matches_reference():
    cfg = dict(lr_peak=3e-3, lr_min=3e-5, warmup_steps=10, total_steps=100)
    steps = np.arange(0, 120, 7, dtype=np.int32)
    want = np.array([float(r_opt.cosine_lr(r_opt.OptimizerConfig(**cfg), jnp.int32(s)))
                     for s in steps])
    got = cosine_lr(t_opt.OptimizerConfig(**cfg), torch.tensor(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * cfg["lr_peak"])


class TestData:
    def test_determinism_and_restart_alignment(self):
        cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=7)
        a = make_batch(cfg, step=3)
        b = make_batch(cfg, step=3)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_shards_partition_batch(self):
        cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=8, seed=1)
        s0 = make_batch(cfg, 0, shard=0, num_shards=2)
        s1 = make_batch(cfg, 0, shard=1, num_shards=2)
        assert s0["tokens"].shape == (4, 8)
        assert not np.array_equal(s0["tokens"], s1["tokens"])

    def test_labels_are_shifted_tokens(self):
        cfg = DataConfig(vocab_size=50, seq_len=12, global_batch=2, seed=2)
        b = make_batch(cfg, 0)
        assert b["tokens"].min() >= 0 and b["tokens"].max() < 50
        assert b["tokens"].shape == b["labels"].shape


@pytest.mark.parametrize("seed,step,shard,num_shards",
                         [(0, 0, 0, 1), (7, 3, 0, 1), (1, 5, 1, 2), (3, 11, 3, 4)])
def test_make_batch_bitwise_reference(seed, step, shard, num_shards):
    kw = dict(vocab_size=997, seq_len=24, global_batch=8, seed=seed)
    got = make_batch(DataConfig(**kw), step, shard, num_shards)
    want = r_tokens.make_batch(r_tokens.DataConfig(**kw), step, shard, num_shards)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    stream = TokenStream(DataConfig(**kw), shard, num_shards, start_step=step)
    np.testing.assert_array_equal(next(stream)["tokens"], want["tokens"])


class TestCheckpoint:
    def _state(self, v=1.0):
        return {
            "params": {"w": torch.full((3, 2), v), "b": torch.zeros(2)},
            "step_info": torch.tensor(int(v), dtype=torch.int32),
        }

    def test_roundtrip(self, tmp_path):
        d = str(tmp_path / "ckpt")
        state = self._state(2.5)
        save_checkpoint(d, 7, state)
        restored, step = restore_checkpoint(d, self._state(0.0))
        assert step == 7
        assert torch.equal(restored["params"]["w"], state["params"]["w"])

    def test_keep_n_retention(self, tmp_path):
        d = str(tmp_path / "ckpt")
        for s in range(5):
            save_checkpoint(d, s, self._state(s), keep_n=2)
        dirs = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        assert dirs == ["step_00000003", "step_00000004"]

    def test_latest_pointer_and_fallback(self, tmp_path):
        d = str(tmp_path / "ckpt")
        save_checkpoint(d, 1, self._state())
        save_checkpoint(d, 2, self._state())
        assert latest_step_dir(d).endswith("step_00000002")
        os.remove(os.path.join(d, "LATEST"))  # crash before pointer update
        assert latest_step_dir(d).endswith("step_00000002")

    def test_restore_empty_dir_returns_init(self, tmp_path):
        like = self._state(9.0)
        restored, step = restore_checkpoint(str(tmp_path / "none"), like)
        assert step == 0
        assert restored is like

    def test_async_checkpointer(self, tmp_path):
        d = str(tmp_path / "ckpt")
        ck = AsyncCheckpointer(d, keep_n=2)
        ck.save(5, self._state(5.0))
        ck.wait()
        _, step = restore_checkpoint(d, self._state())
        assert step == 5

    def test_elastic_reshard_restore(self, tmp_path):
        """Restore onto explicit devices: one device for every leaf, or a
        tree of devices shaped like the state (the one-host placements)."""
        d = str(tmp_path / "ckpt")
        save_checkpoint(d, 3, self._state(1.5))
        dev = torch.device("cpu")
        for shardings in (dev, tree_map(lambda _: dev, self._state())):
            restored, step = restore_checkpoint(d, self._state(), shardings=shardings)
            assert step == 3
            assert restored["params"]["w"].device == dev
            assert float(restored["params"]["w"][0, 0]) == 1.5

    def test_bfloat16_leaves_roundtrip(self, tmp_path):
        d = str(tmp_path / "ckpt")
        x = torch.tensor([1.5, -2.25, 3e-3]).to(torch.bfloat16)
        save_checkpoint(d, 1, {"m": x})
        restored, _ = restore_checkpoint(d, {"m": torch.zeros(3, dtype=torch.bfloat16)})
        assert restored["m"].dtype == torch.bfloat16 and torch.equal(restored["m"], x)


ARCH = "qwen3-moe-30b-a3b"  # experts: the richest tree of leaves


@functools.lru_cache(maxsize=None)
def _jit_init(cfg):
    return jax.jit(functools.partial(r_tf.init_params, cfg))


@functools.lru_cache(maxsize=None)
def _jit_update(opt_cfg):
    return jax.jit(functools.partial(r_opt.adamw_update, cfg=opt_cfg))


def _train_state(seed: int):
    """The reference's and the port's ``(params, opt_state)`` on the same
    values: SMOKE weights and one AdamW step on seeded gradients."""
    cfg = get_config(ARCH, smoke=True)
    opt_cfg = r_opt.OptimizerConfig(warmup_steps=1)
    params = _jit_init(cfg)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                         params)
    params, opt_state, _ = _jit_update(opt_cfg)(params, grads,
                                                r_opt.init_opt_state(params, opt_cfg))
    ref = (params, opt_state)
    tp = t_tf.params_from_reference(t_get_config(ARCH, smoke=True),
                                    jax.tree.map(np.asarray, params), device="cpu").tree()
    tp = tree_map(lambda t: t.detach(), tp)
    ts = t_opt.OptState(m=tree_map(lambda t: torch.zeros_like(t), tp),
                        v=tree_map(lambda t: torch.zeros_like(t), tp),
                        step=torch.tensor(0, dtype=torch.int32),
                        ef=tree_map(lambda t: torch.zeros((), dtype=torch.float32), tp))
    return ref, (tp, ts)


def _same(got_port, want_ref):
    want = dict(paths(jax.tree.map(np.asarray, want_ref)))
    got = paths(got_port)
    assert sorted(k for k, _ in got) == sorted(want)
    for k, t in got:
        assert t.dtype == torch.from_numpy(np.zeros(1, want[k].dtype)).dtype, k
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


def test_checkpoint_names_equal_the_reference(tmp_path):
    ref, port = _train_state(0)
    r_ckpt.save_checkpoint(str(tmp_path / "r"), 1, ref)
    save_checkpoint(str(tmp_path / "t"), 1, port)
    names = [sorted(np.load(tmp_path / d / "step_00000001" / "arrays.npz").files)
             for d in ("r", "t")]
    assert names[0] == names[1]
    assert {"0/embed/table", "0/segments/0/moe/router", "1/.m/segments/0/moe/w_gate",
            "1/.v/embed/table", "1/.ef/final_norm/scale", "1/.step"} <= set(names[1])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref, _ = _train_state(1)
    _, like = _train_state(2)  # other values, same structure
    r_ckpt.save_checkpoint(str(tmp_path), 4, ref)
    (tp, ts), step = restore_checkpoint(str(tmp_path), like)
    assert step == 4 and int(ts.step) == 1
    _same((tp, ts), ref)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref, port = _train_state(3)
    like, _ = _train_state(4)
    save_checkpoint(str(tmp_path), 6, port)
    restored, step = r_ckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 6
    _same(port, restored)


def _launch(capsys, *args):
    losses = t_launch.main(["--arch", "internvl2-1b", "--smoke", "--device", "cpu",
                            "--steps", "6", "--batch", "2", "--seq", "16", "--log-every",
                            "1", *args])
    return losses, capsys.readouterr().out


def test_launcher_resume_reproduces_the_run_bitwise(tmp_path, capsys):
    """6 steps with a checkpoint every 3 (frontend embeddings of each step
    from its own seeded generator), then the run resumed from step 3."""
    whole, _ = _launch(capsys)
    d = str(tmp_path / "ckpt")
    saved, out = _launch(capsys, "--ckpt-dir", d, "--ckpt-every", "3")
    assert saved == whole and "[resume]" not in out
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == [
        "step_00000003", "step_00000006"]
    shutil.rmtree(os.path.join(d, "step_00000006"))
    os.remove(os.path.join(d, "LATEST"))  # as if killed after step 3
    resumed, out = _launch(capsys, "--ckpt-dir", d, "--ckpt-every", "3")
    assert f"[resume] restored step 3 from {d}" in out
    assert resumed == whole[3:]
    assert sum(line.startswith("step ") for line in out.splitlines()) == 3
    assert "[done]" in out


def test_launcher_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_launch.main(["--smoke", "--steps", "1"])


def _assigned(path: Path) -> dict:
    """The module-level constants of an example, read without running it."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name == "CFG":
                out[name] = {k.arg: ast.literal_eval(k.value) for k in node.value.keywords}
            elif name in ("STEPS",):
                out[name] = ast.literal_eval(node.value)
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple):
            names = [t.id for t in node.targets[0].elts]
            out.update(zip(names, ast.literal_eval(node.value)))
    return out


def test_train_lm_twin_config():
    ref = _assigned(ROOT / "examples" / "train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm",
                                                  ROOT / "examples" / "torch_train_lm.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    assert dataclasses.asdict(twin.CFG) == dataclasses.asdict(ModelConfig(**ref["CFG"]))
    assert (twin.STEPS, twin.BATCH, twin.SEQ) == (ref["STEPS"], ref["BATCH"], ref["SEQ"])
    assert t_tf.param_count(twin.CFG) == r_tf.param_count(ModelConfig(**ref["CFG"]))
