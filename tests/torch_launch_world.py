"""The sharded LM cases of ``test_torch_launch_*.py`` as one rank runs them:
the port's train step, prefill and decode on a ``DeviceMesh`` over a world
of ranks started by ``repro_torch.core.run_world`` (gloo on the CPU; NCCL
or gloo on the card), and the checkpoint reshard.  The world imports this
module (not the test files, which import JAX) and returns its results to
the test process: every rank its metrics, rank 0 also the whole new
parameters (``full_tensor``), as numpy.

``in_child`` runs one function in a fresh process (the dry run's fake
worlds), so that a crash of DTensor fails one test and not its worker.
"""
import concurrent.futures
import dataclasses
import multiprocessing

OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)  # the reference test's


def _full(tree):
    from torch.distributed.tensor import DTensor

    from repro_torch.train.tree import tree_map

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def _scalar(t) -> float:
    from torch.distributed.tensor import DTensor

    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def lm_cases(rank, world_size, arch, tree, batch, mesh_shape, variants, serve=None,
             device="cpu"):
    """One train step per variant ``(name, cfg overrides as (field, value)
    pairs, microbatches)``
    on the reference's weights ``tree`` and ``batch`` (numpy), and with
    ``serve = (tokens, decode steps, s_max)`` a sharded prefill and greedy
    decodes.  Returns ``{name: (metrics, params or None)}`` (params on rank
    0) and, with ``serve``, ``"serve": (logits of prefill and each decode)``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import sharding as sh
    from repro_torch.models import params_from_reference
    from repro_torch.train import optimizer as opt
    from repro_torch.train import serve_step as ss
    from repro_torch.train import train_step as ts

    del world_size
    mesh = lm.make_test_mesh(tuple(mesh_shape), device_type=torch.device(device).type)
    out = {}
    oc = opt.OptimizerConfig(**OPT)
    for name, overrides, microbatches in variants:
        cfg = dataclasses.replace(get_config(arch, smoke=True), **dict(overrides))
        model = params_from_reference(cfg, tree, device=device)
        params = sh.shard_tree(model, sh.param_shardings(cfg, mesh))
        state = sh.shard_tree(opt.init_opt_state(model.tree(), oc),
                              sh.opt_state_shardings(cfg, mesh, oc))
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        b = sh.shard_tree(b, sh.batch_shardings(cfg, mesh, b))
        step = ts.make_train_step(cfg, oc, mesh, microbatches=microbatches)
        new, _, metrics = step(params, state, b)
        full = _full(new)
        out[name] = ({k: _scalar(v) for k, v in metrics.items()},
                     full if rank == 0 else None)
    if serve is not None:
        tokens, steps, s_max = serve
        cfg = get_config(arch, smoke=True)
        params = sh.shard_tree(params_from_reference(cfg, tree, device=device),
                               sh.param_shardings(cfg, mesh))
        toks = torch.as_tensor(tokens, device=device)
        toks = sh.shard_tree(toks, sh.batch_shardings(cfg, mesh, {"t": toks})["t"])
        logits, caches = ss.make_prefill_fn(cfg, mesh)(params, toks)
        shd = sh.Sharder(mesh)
        with shd.region():
            cache = ss.prefill_to_decode_cache(cfg, caches, tokens.shape[1], s_max)
        # The decode cache placed as the JAX package's serve step takes it
        # (``cache_spec``: heads or sequence over "model").
        cache = sh.shard_tree(cache, sh.batch_shardings(cfg, mesh, {"cache": cache})["cache"])
        decode = ss.make_serve_step(cfg, mesh)
        seen = [_full(logits)]
        tok = torch.argmax(seen[-1][:, -1], dim=-1)[:, None].to(torch.int32)
        for i in range(steps):
            logits, cache = decode(params, shd.batch(tok), cache, tokens.shape[1] + i)
            seen.append(_full(logits))
            tok = torch.argmax(seen[-1][:, -1], dim=-1)[:, None].to(torch.int32)
        out["serve"] = tuple(seen)
    return out


# Decode-cache placements on a (2, 2) mesh: batch over "data", and the
# sequence or the KV heads over "model" (``cache_spec``'s two cases) or
# neither, or the sequence alone; and (pos, window) pairs: plain, and a
# rolling window of 32 slots before and after it wraps.
DECODE_PLACEMENTS = ("S0,S2", "S0,S1", "S0,R", "R,S2")
DECODE_STEPS = ((5, None), (20, None), (7, 32), (40, 32))


def decode_cases(rank, world_size):
    """``cache_update`` and ``decode_attention`` on DTensor caches (B=2,
    2 KV heads, 32 slots, D=8; 4 query heads) against the plain functions
    on the same float32 values, for each placement and step.  Returns
    ``{(placement, pos, window): (cache |diff|, output |diff|, output
    scale, collective counts by op, the updated cache's placement)}``."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import mesh as lm
    from repro_torch.nn import attention as at

    del rank, world_size
    mesh = lm.make_test_mesh((2, 2), device_type="cpu")
    g = torch.Generator().manual_seed(0)
    kc, vc = torch.randn(2, 2, 32, 8, generator=g), torch.randn(2, 2, 32, 8, generator=g)
    kn, vn = torch.randn(2, 2, 1, 8, generator=g), torch.randn(2, 2, 1, 8, generator=g)
    q = torch.randn(2, 4, 1, 8, generator=g)
    parse = lambda p: Replicate() if p == "R" else Shard(int(p[1]))
    out = {}
    for name in DECODE_PLACEMENTS:
        place = [parse(p) for p in name.split(",")]
        for pos, window in DECODE_STEPS:
            want_k, want_v = at.cache_update(kc, vc, kn, vn, pos, window)
            want = at.decode_attention(q, want_k, want_v, pos, window=window)
            dk, dv = (distribute_tensor(t, mesh, place) for t in (kc, vc))
            dkn, dvn = (distribute_tensor(t, mesh, [Shard(0), Replicate()]) for t in (kn, vn))
            dq = distribute_tensor(q, mesh, [Shard(0), Shard(1)])
            with CommDebugMode() as comm:
                gk, gv = at.cache_update(dk, dv, dkn, dvn, pos, window)
                got = at.decode_attention(dq, gk, gv, pos, window=window)
            counts = {str(k).rsplit(".", 1)[-1]: v for k, v in comm.get_comm_counts().items()}
            cache_gap = max(float((gk.full_tensor() - want_k).abs().max()),
                            float((gv.full_tensor() - want_v).abs().max()))
            out[(name, pos, window)] = (cache_gap, float((got.full_tensor() - want).abs().max()),
                                        float(want.abs().max()), counts,
                                        ",".join("R" if p.is_replicate() else f"S{p.dim}"
                                                 for p in gk.placements))
    return out


def reshard(rank, world_size, ckpt_dir):
    """Save ``w`` sharded on a ``(4,)`` mesh, restore it onto ``(2, 2)``:
    the reference's ``test_elastic_checkpoint_reshard_across_meshes``.
    Returns (step, the restored whole ``w``, its placements, its local
    shape)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as lm
    from repro_torch.launch import sharding as sh
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    del world_size
    state = {"w": torch.arange(64.0).reshape(8, 8)}
    mesh1 = lm.make_test_mesh((4,), ("data",), device_type="cpu")
    state1 = sh.shard_tree(state, {"w": sh.NamedSharding(mesh1, ("data", None))})
    save_checkpoint(ckpt_dir, 1, state1)  # every rank gathers, rank 0 writes
    dist.barrier()
    mesh2 = lm.make_test_mesh((2, 2), device_type="cpu")
    s2 = {"w": sh.NamedSharding(mesh2, ("data", "model"))}
    restored, step = restore_checkpoint(ckpt_dir, state, shardings=s2)
    w = restored["w"]
    return step, w.full_tensor(), tuple(str(p) for p in w.placements), tuple(w.to_local().shape)


def placements_case():
    """``test_placements_and_shardings``'s checks, in a fake world of 8."""
    import pytest
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import sharding as sh
    from repro_torch.models.config import SHAPES, input_specs
    from repro_torch.train.tree import paths

    with lm.fake_world(8):
        mesh = lm.make_test_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
        assert sh.placements(("data", "model"), mesh) == (Replicate(), Shard(0), Shard(1))
        assert sh.placements((("pod", "data"), None, "model"), mesh) == (
            Shard(0), Shard(0), Shard(2))
        assert sh.placements((None, None), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="mesh order"):
            sh.placements((("data", "pod"),), mesh)
        with pytest.raises(ValueError, match="not in the mesh"):
            sh.placements(("expert",), mesh)
        with pytest.raises(ValueError, match="named twice"):
            sh.placements(("model", "model"), mesh)
        assert sh._widen_data_axis((None, "data", "model"), mesh) == (
            None, ("pod", "data"), "model")
        cfg = get_config("granite-3-2b", smoke=True)
        p_sh = dict(paths(sh.param_shardings(cfg, mesh)))
        assert p_sh["segments/0/mlp/w_down"].spec == (None, "model", ("pod", "data"))
        o_sh = sh.opt_state_shardings(cfg, mesh)
        assert o_sh.step.spec == () and o_sh.m is not None
        dp = lm.data_axes(mesh)
        assert dp == ("pod", "data")
        b_sh = sh.batch_shardings(cfg, mesh, input_specs(cfg, SHAPES["train_4k"]))
        assert b_sh["tokens"].spec == (dp, None)
        d_sh = sh.batch_shardings(cfg, mesh, input_specs(cfg, SHAPES["decode_32k"]))
        assert d_sh["pos"].spec == ()
        assert d_sh["cache"][0]["k"].spec == (None, dp, None, "model", None)
        x = torch.arange(32.0).reshape(8, 4)
        placed = sh.shard_tree({"x": x}, sh.NamedSharding(mesh, (("pod", "data"), "model")))
        assert placed["x"].to_local().shape == (2, 2)
        assert torch.equal(placed["x"].to_local(), x[:2, :2])  # rank 0's block


def per_rank_matmul():
    """(CostCounter's dot FLOPs, FlopCounterMode's) of a DTensor matmul
    (64, 1024) @ (1024, 4096) on a (16, 16) mesh of a fake world of 256,
    rows over "data", columns over "model"."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import mesh as lm
    from repro_torch.roofline.counting import CostCounter

    with lm.fake_world(256):
        mesh = lm.make_production_mesh(device_type="cpu")
        x = distribute_tensor(torch.randn(64, 1024), mesh, [Shard(0), Replicate()],
                              src_data_rank=None)
        w = distribute_tensor(torch.randn(1024, 4096), mesh, [Replicate(), Shard(1)],
                              src_data_rank=None)
        with CostCounter() as counter:
            x @ w
        with FlopCounterMode(display=False) as flops:
            x @ w
        return counter.record.dot_flops, flops.get_total_flops()


def collective_case():
    """Collective bytes counted on a fake world of 4: an all-reduce of 5
    floats, and a (16, 4) float32 DTensor on a (4,) mesh gathered
    (Shard -> Replicate), reduce-scattered (Partial -> Shard) and
    all-reduced (Partial -> Replicate)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch import mesh as lm
    from repro_torch.roofline.counting import CostCounter

    with lm.fake_world(4):
        mesh = lm.make_test_mesh((4,), ("data",), device_type="cpu")
        x = DTensor.from_local(torch.ones(4, 4), mesh, [Shard(0)], run_check=False)
        part = DTensor.from_local(torch.ones(16, 4), mesh, [Partial()], run_check=False)
        with CostCounter() as counter:
            dist.all_reduce(torch.ones(5))
            x.redistribute(mesh, [Replicate()])
            part.redistribute(mesh, [Shard(0)])
            part.redistribute(mesh, [Replicate()])
        return counter.record.collective_bytes()


def propagation_rounds(instance, device="cpu"):
    """``launch.perf.run_propagation_variants`` on a fake world of 4 at
    ``instance``'s size (its rounds on ``device``)."""
    from repro_torch.launch import perf

    return perf.run_propagation_variants(**instance, device=device, world=4)


# A small train shape for the dry-run cases (the reference test's).
SMALL_TRAIN = dict(seq_len=64, global_batch=8)


def lower_case(dtype="bfloat16"):
    """``lower_cell`` on a (2, 2) mesh of a fake world of 4: granite-3-2b
    SMOKE train (2 microbatches), prefill and decode at small shapes."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, mesh as lm
    from repro_torch.models.config import SHAPES

    cfg = dataclasses.replace(get_config("granite-3-2b", smoke=True), dtype=dtype)
    out = {}
    with lm.fake_world(4):
        mesh = lm.make_test_mesh((2, 2), device_type="cpu")
        for name, mb in (("train_4k", 2), ("prefill_32k", 1), ("decode_32k", 1)):
            shape = dataclasses.replace(SHAPES[name], **SMALL_TRAIN)
            out[name] = dryrun.lower_cell(cfg, shape, mesh, microbatches=mb)
    return out


def uneven_heads_case(split: bool = True):
    """granite-3-2b SMOKE (4 query heads, 2 KV heads) on a ``(1, 4)`` mesh of
    a fake world of 4, where the KV heads do not divide over the 4 "model"
    ranks: ``lower_cell``'s dot FLOPs of the train step (2 microbatches) and
    of a decode.  With ``split=False``, ``Sharder.heads`` (the model's
    explicit redistribution before the head split) is made the identity
    in this process, and the error the trace raises is returned instead."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, mesh as lm, sharding as sh
    from repro_torch.models.config import SHAPES

    if not split:
        sh.Sharder.heads = lambda self, x, n: x
    cfg = dataclasses.replace(get_config("granite-3-2b", smoke=True), dtype="float32")
    with lm.fake_world(4):
        mesh = lm.make_test_mesh((1, 4), device_type="cpu")
        try:
            return {name: dryrun.lower_cell(cfg, dataclasses.replace(SHAPES[name], **SMALL_TRAIN),
                                            mesh, microbatches=mb)["flops"]
                    for name, mb in (("train_4k", 2), ("decode_32k", 1))}
        except Exception as e:  # noqa: BLE001 -- returned to the test
            return f"{type(e).__name__}: {e}"


def probe_case(arch, layers):
    """``probe_cell``'s extrapolation and the full-depth trace of the same
    probe settings (``probe_cfg`` at ``layers``) for ``arch`` SMOKE cut to
    ``layers`` layers, on a (2, 2) mesh of a fake world of 4: (flops, HBM
    bytes, collective bytes by type) of each."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, mesh as lm
    from repro_torch.models.config import SHAPES

    cfg = dataclasses.replace(get_config(arch, smoke=True), num_layers=layers)
    shape = dataclasses.replace(SHAPES["train_4k"], **SMALL_TRAIN)
    with lm.fake_world(4):
        mesh = lm.make_test_mesh((2, 2), device_type="cpu")
        terms, by_op, _ = dryrun.probe_cell(cfg, shape, mesh)
        full = dryrun.lower_cell(dryrun.probe_cfg(cfg, layers, shape), shape, mesh)
    return ((terms.flops, terms.bytes_hbm, by_op),
            (full["flops"], full["hbm_bytes"], full["collectives"]))


def in_child(fn, *args, timeout: float = 300.0):
    """``fn(*args)`` in a fresh (spawned) process; its result, or the
    process's exception (``BrokenProcessPool`` if it died)."""
    ctx = multiprocessing.get_context("spawn")
    pool = concurrent.futures.ProcessPoolExecutor(max_workers=1, mp_context=ctx)
    try:
        return pool.submit(fn, *args).result(timeout=timeout)
    finally:
        for proc in list(getattr(pool, "_processes", {}).values()):
            if proc.is_alive():
                proc.kill()
        pool.shutdown(wait=True, cancel_futures=True)
