"""Multi-pod dry run on a fake process group.

For every (architecture x input shape) cell and both production meshes
(single ``(16, 16)`` = 256 ranks, multi ``(2, 16, 16)`` = 512 ranks):

  1. FULL trace: the cell's step (train, prefill or decode) runs once on
     rank 0 of a ``"fake"`` world (``launch.mesh.fake_world``), its params,
     optimizer state and inputs DTensors of ``meta`` tensors on the mesh,
     under ``roofline.counting.CostCounter`` with memory tracking: the
     per-rank argument, output and temporary bytes prove the footprint fits
     one card's HBM, and the counts give ``scanned_flops_per_device``.
  2. PROBE traces at two shallow depths (``probe_depths``), linearly
     extrapolated to full depth -> the three roofline terms
     (``roofline/analysis.py``).

Nothing is allocated and no card is needed (``meta`` tensors, their meta
kernels memoized by ``_MetaCache``: a third of ``FakeTensorMode``'s time on
this trace).  The counterpart of the JAX
package's ``lower().compile()`` on 256/512 virtual CPU devices, with two
differences: the eager trace runs every layer, so the full trace's count
is the whole model's (XLA's scanned module counts a loop body once), and
XLA's own cost estimates (``raw_ca_*``) have no counterpart and are left
out.  The probes stay: they keep a deep cell's roofline count short.
The figures are a model of H100 cards from datasheet peaks, not
measurements.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k \\
      --mesh single --out results/dryrun.json [--no-probes]
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.json
  python -m repro_torch.launch.dryrun --all --shape decode_32k --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, get_config
from ..models.config import SHAPES, cell_supported, input_specs
from ..models.transformer import active_param_count
from ..roofline.analysis import RooflineTerms, extrapolate, model_flops
from ..roofline.counting import CostCounter, tensor_bytes
from ..train.optimizer import OptimizerConfig, init_opt_state
from ..train.serve_step import make_prefill_fn, make_serve_step
from ..train.train_step import make_train_step
from ..train.tree import tree_map
from .mesh import axis_sizes, fake_world, make_production_mesh
from .sharding import (_meta_params, batch_shardings, opt_state_shardings, param_shardings,
                       shard_tree)

# One NVIDIA H100 80GB HBM3's memory as PyTorch reports it
# (torch.cuda.get_device_properties(0).total_memory; chip_smoke.py phase 20).
HBM_PER_CHIP = 85_017_493_504

WORLD = {"single": 256, "multi": 512}


# ---------------------------------------------------------------------------
# Cell tracing
# ---------------------------------------------------------------------------


_MB_OVERRIDE = {
    # Heavy cells need full grad accumulation (per-mb local batch == 1).
    "deepseek-v2-236b": 1_000_000,
}


def _opt_cfg_for(cfg) -> OptimizerConfig:
    """236B-scale training keeps bf16 m/v + bf16 grad accumulation (the JAX
    package's policy, set for its 16 GB chips)."""
    if cfg.name == "deepseek-v2-236b":
        return OptimizerConfig(state_dtype="bfloat16")
    return OptimizerConfig()


def _train_microbatches(cfg, shape, mesh) -> int:
    """Default grad-accum factor so per-device activations fit HBM."""
    dp = 1
    for a, size in axis_sizes(mesh).items():
        if a != "model":
            dp *= size
    local_batch = max(1, shape.global_batch // dp)
    return min(_MB_OVERRIDE.get(cfg.name, 8), local_batch)


class _MetaCache(TorchDispatchMode):
    """Meta kernels memoized: an op on meta tensors that returns fresh
    tensors (no view, no in-place write) gets outputs of the shapes,
    strides and dtypes it gave the last time it met arguments of the same
    metadata, without running its meta kernel again (many run as Python
    reference code, the bulk of a trace's time; a layer repeats the same
    shapes tile after tile).  Exact: a meta kernel's output metadata is a
    function of its arguments' metadata."""

    def __init__(self):
        super().__init__()
        self._memo: dict = {}

    @staticmethod
    def _key(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
        if isinstance(x, (list, tuple)):
            return tuple(_MetaCache._key(v) for v in x)
        return x if isinstance(x, (int, float, bool, str, type(None), torch.dtype,
                                   torch.device, torch.layout, torch.memory_format)) else id(x)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        schema = func._schema
        pure = not schema.is_mutable and all(r.alias_info is None for r in schema.returns)
        if not pure or not schema.returns:
            return func(*args, **kwargs)
        try:
            key = (func, self._key(args), self._key(tuple(sorted(kwargs.items()))))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        hit = self._memo.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if all(isinstance(o, torch.Tensor) and o.device.type == "meta" for o in outs):
                self._memo[key] = (isinstance(out, (tuple, list)),
                                   [(tuple(o.shape), o.stride(), o.dtype) for o in outs])
            return out
        many, metas = hit
        outs = [torch.empty_strided(sh, st, dtype=dt, device="meta") for sh, st, dt in metas]
        return tuple(outs) if many else outs[0]


def _meta(tree):
    """``tree`` as ``meta`` tensors of its leaves' shapes and dtypes."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def lower_cell(cfg, shape, mesh, microbatches: int = 1) -> dict:
    """Trace one cell's step once on ``mesh`` (this process's rank of its
    process group, a fake world in a dry run) on ``meta`` tensors, counted.

    Returns per-rank ``arg_bytes`` (params, optimizer state, batch: their
    local shards), ``out_bytes``, ``temp_bytes`` (peak bytes the step
    allocates above its arguments, its outputs included: the functional
    update holds old and new state at once), ``peak_bytes`` (their sum),
    ``flops`` (dot FLOPs), ``hbm_bytes``, ``collectives`` (bytes by type,
    ``total``) and ``flops_by_label``."""
    specs = input_specs(cfg, shape)
    with _MetaCache():
        whole = _meta(_meta_params(cfg))
        params = shard_tree(whole, param_shardings(cfg, mesh))
        b_sh = batch_shardings(cfg, mesh, specs)
        if shape.kind == "decode":
            pos = shape.seq_len - 1  # the last slot (the JAX package traces it)
            specs = {k: v for k, v in specs.items() if k != "pos"}
            b_sh = {k: v for k, v in b_sh.items() if k != "pos"}
        batch = shard_tree(_meta(specs), b_sh)
        args = [params, batch]
        if shape.kind == "train":
            opt_cfg = _opt_cfg_for(cfg)
            state = shard_tree(init_opt_state(whole, opt_cfg),
                               opt_state_shardings(cfg, mesh, opt_cfg))
            args.append(state)
            del whole
            fn = make_train_step(cfg, opt_cfg, mesh, microbatches=microbatches)
            run = lambda: fn(params, state, batch)
        elif shape.kind == "prefill":
            del whole
            fn = make_prefill_fn(cfg, mesh)
            run = lambda: fn(params, batch["tokens"], batch.get("frontend_embeds"))
        else:
            del whole
            fn = make_serve_step(cfg, mesh)
            run = lambda: fn(params, batch["tokens"], batch["cache"], pos)
        arg_bytes = sum(tensor_bytes(a) for a in args)
        counter = CostCounter(track_memory=True)
        with counter:
            out = run()
        rec = counter.record
        out_bytes = tensor_bytes(out)
    coll = rec.collective_bytes()
    return {
        "arg_bytes": int(arg_bytes),
        "out_bytes": int(out_bytes),
        "temp_bytes": int(rec.peak_bytes),
        "peak_bytes": int(arg_bytes + rec.peak_bytes),
        "flops": rec.dot_flops,
        "hbm_bytes": rec.hbm_bytes,
        "collectives": coll,
        "flops_by_label": dict(rec.flops_by_label),
    }


# ---------------------------------------------------------------------------
# Probe configs (shallow traces at two depths)
# ---------------------------------------------------------------------------


def probe_depths(cfg):
    """(n1, n2, n_full, unit) for linear extrapolation over segment units."""
    if cfg.layer_pattern:  # recurrentgemma: unit = one period, same tail
        period = len(cfg.layer_pattern)
        n_full, tail = divmod(cfg.num_layers, period)
        return (1 * period + tail, 2 * period + tail, None, n_full)
    if cfg.first_k_dense:  # deepseek: unit = one MoE layer
        return (cfg.first_k_dense + 1, cfg.first_k_dense + 2, None,
                cfg.num_layers - cfg.first_k_dense)
    return (1, 2, None, cfg.num_layers)


def probe_cfg(cfg, n_layers: int, shape):
    return dataclasses.replace(
        cfg,
        num_layers=n_layers,
        scan_layers=False,
        unroll_inner=True,
        attn_chunk=max(512, shape.seq_len // 2),
        remat=False,
    )


def probe_cell(cfg, shape, mesh):
    """Probe traces -> extrapolated per-device costs: dot FLOPs, HBM bytes
    by the fusion-aware rule and collective bytes, each counted by
    ``CostCounter``.  Returns (terms, collective bytes by type, {})."""
    n1, n2, _, n_units = probe_depths(cfg)
    res = [lower_cell(probe_cfg(cfg, n, shape), shape, mesh, microbatches=1)
           for n in (n1, n2)]
    ext = lambda f: extrapolate(f(res[0]), f(res[1]), 1, 2, n_units)
    terms = RooflineTerms(flops=ext(lambda r: r["flops"]),
                          bytes_hbm=ext(lambda r: r["hbm_bytes"]),
                          bytes_coll=ext(lambda r: r["collectives"]["total"])).finalize()
    by_op = {k: ext(lambda r, k=k: r["collectives"][k]) for k in res[0]["collectives"]}
    return terms, by_op, {}


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, mesh_kind: str, probes: bool = True) -> dict:
    """One cell's record on a fake world of the production mesh's size."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "kind": shape.kind,
        "supported": ok,
    }
    if not ok:
        rec["skip_reason"] = why
        return rec

    with fake_world(WORLD[mesh_kind]):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
        mb = _train_microbatches(cfg, shape, mesh) if shape.kind == "train" else 1
        t0 = time.time()
        low = lower_cell(cfg, shape, mesh, microbatches=mb)
        rec.update(
            {
                "microbatches": mb,
                "compile_s": round(time.time() - t0, 1),  # the full trace's seconds
                "arg_bytes": low["arg_bytes"],
                "out_bytes": low["out_bytes"],
                "temp_bytes": low["temp_bytes"],
                "peak_bytes": low["peak_bytes"],
                "fits_hbm": bool(low["arg_bytes"] + low["temp_bytes"] < HBM_PER_CHIP),
                # Every layer traced: the whole model's dot FLOPs per rank.
                "scanned_flops_per_device": low["flops"],
            }
        )
        if probes:
            t1 = time.time()
            terms, by_op, _ = probe_cell(cfg, shape, mesh)
            rec["probe_s"] = round(time.time() - t1, 1)
            rec.update(terms.as_dict())
            rec["collective_by_op"] = {k: float(v) for k, v in by_op.items()}
            n_active = active_param_count(cfg)
            tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
            chips = WORLD[mesh_kind]
            mf = model_flops(n_active, tokens, shape.kind)
            rec["model_flops_total"] = mf
            rec["hlo_flops_total"] = terms.flops * chips
            rec["useful_compute_ratio"] = (
                mf / rec["hlo_flops_total"] if rec["hlo_flops_total"] else 0.0
            )
            rec["roofline_fraction"] = (
                rec["t_compute_s"] / rec["t_bound_s"] if rec["t_bound_s"] else 0.0
            )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--no-probes", dest="probes", action="store_false")
    ap.add_argument("--include-prop", action="store_true",
                    help="also dry-run the paper's sharded propagation workload")
    args = ap.parse_args(argv)

    cells = []
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:  # with --shape: every arch at that shape
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                for mk in meshes:
                    if args.shape in (None, shape_name):
                        cells.append((arch, shape_name, mk))
    elif args.arch and args.shape:
        for mk in meshes:
            cells.append((args.arch, args.shape, mk))
    elif not args.include_prop:
        ap.error("give --arch and --shape, --all or --include-prop")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch, shape_name, mk in cells:
        if (arch, shape_name, mk) in done:
            print(f"[skip done] {arch} x {shape_name} x {mk}")
            continue
        print(f"[dryrun] {arch} x {shape_name} x {mk}", flush=True)
        try:
            rec = run_cell(arch, shape_name, mk, probes=args.probes)
        except Exception as e:  # a failing cell is a bug -- record loudly
            rec = {
                "arch": arch,
                "shape": shape_name,
                "mesh": mk,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
            print(f"  FAILED: {e}")
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        if "error" not in rec and rec.get("supported", True):
            print(
                f"  ok trace={rec.get('compile_s')}s mb={rec.get('microbatches')}"
                f" peak={rec.get('temp_bytes', 0)/2**30:.2f}GiB"
                f" bottleneck={rec.get('bottleneck', '-')}"
            )

    if args.include_prop:
        run_propagation_dryrun(results, args.out, meshes)


def propagation_instance(m: int = 1_000_000, n: int = 500_000, nnz: int = 16_000_000,
                         dtype=np.float64, seed: int = 0):
    """The JAX package's synthetic propagation instance (its dry run:
    16 M nnz, 1 M rows, 500 k columns, float64; its perf driver: 4 M nnz,
    250 k rows, 125 k columns, float32), array for array."""
    from ..core.sparse import Problem, csr_from_coo

    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, m, nnz)).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(dtype)
    csr = csr_from_coo(rows, cols, vals, m, n)
    return Problem(
        csr=csr,
        lhs=np.full(m, -1e20, dtype),
        rhs=rng.uniform(1, 10, m).astype(dtype),
        lb=np.zeros(n, dtype),
        ub=np.full(n, 10.0, dtype),
        is_int=np.zeros(n, dtype=bool),
    )


def run_propagation_dryrun(results, out, meshes):
    """Dry-run the paper's distributed propagation on the production meshes:
    ``core.sharded.lower_sharded``'s per-rank arguments and per-round
    collectives (nothing runs; XLA's temporary bytes have no counterpart)."""
    from ..core.sharded import lower_sharded
    from ..roofline.counting import COLLECTIVE_KEYS

    p = propagation_instance()
    for mk in meshes:
        key = ("propagation-16Mnnz", "fixed_point", mk)
        if any((r["arch"], r["shape"], r["mesh"]) == key for r in results):
            continue
        t0 = time.time()
        low = lower_sharded(p, WORLD[mk], dtype=torch.float32)
        coll = dict.fromkeys(COLLECTIVE_KEYS, 0.0)
        coll["all-reduce"] = float(sum(c.bytes for c in low.collectives_per_round))
        coll["total"] = coll["all-reduce"]
        rec = {
            "arch": "propagation-16Mnnz",
            "shape": "fixed_point",
            "mesh": mk,
            "kind": "propagation",
            "supported": True,
            "compile_s": round(time.time() - t0, 1),
            "arg_bytes": int(low.arg_bytes_per_rank),
            "temp_bytes": 0,
            "fits_hbm": bool(low.arg_bytes_per_rank < HBM_PER_CHIP),
            "collective_by_op_per_round": coll,
            "note": "collectives are per ROUND (fixed point is a while loop)",
        }
        results.append(rec)
        if out:
            with open(out, "w") as f:
                json.dump(results, f, indent=1)
        print(f"[dryrun] propagation x {mk}: {rec['compile_s']}s "
              f"all-reduce {coll['all-reduce']:.0f} B/round")
    return results


if __name__ == "__main__":
    main()
