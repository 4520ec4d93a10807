"""Perf driver: re-trace selected cells with optimization levers toggled and
report the three roofline terms per variant, plus the full trace's memory
footprint (``launch/dryrun.py``, on a fake process group); and one real
round of each partition of the sharded propagation, counted.  Appends to
results/perf.json.

  python -m repro_torch.launch.perf --cell granite-3-2b:train_4k --mesh single
  python -m repro_torch.launch.perf --prop [--device cpu]   # propagation variants
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..configs import get_config
from ..models.config import SHAPES
from ..roofline.analysis import collective_bytes
from ..roofline.counting import CostCounter
from .dryrun import (HBM_PER_CHIP, WORLD, _train_microbatches, lower_cell, probe_cell,
                     propagation_instance)
from .mesh import fake_world, make_production_mesh

LEVERS = {
    "baseline": {},
    "+causal_skip": {"causal_skip": True},
    "+seq_shard": {"seq_shard": True},
    "+both": {"causal_skip": True, "seq_shard": True},
}


def run_lm_cell(arch: str, shape_name: str, mesh_kind: str, levers=None):
    shape = SHAPES[shape_name]
    records = []
    with fake_world(WORLD[mesh_kind]):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
        for name, overrides in (levers or LEVERS).items():
            cfg = dataclasses.replace(get_config(arch), **overrides)
            mb = _train_microbatches(cfg, shape, mesh) if shape.kind == "train" else 1
            t0 = time.time()
            rec = {"cell": f"{arch}:{shape_name}:{mesh_kind}", "variant": name}
            try:
                low = lower_cell(cfg, shape, mesh, microbatches=mb)
                rec.update(
                    arg_gib=round(low["arg_bytes"] / 2**30, 2),
                    temp_gib=round(low["temp_bytes"] / 2**30, 2),
                    fits_hbm=bool(low["arg_bytes"] + low["temp_bytes"] < HBM_PER_CHIP),
                )
                terms, by_op, _ = probe_cell(cfg, shape, mesh)
                rec.update(terms.as_dict())
                rec["roofline_fraction"] = (
                    terms.t_compute / terms.t_bound if terms.t_bound else 0.0
                )
                rec["wall_s"] = round(time.time() - t0, 1)
            except Exception as e:  # noqa: BLE001 -- a failing variant is recorded
                rec["error"] = f"{type(e).__name__}: {e}"
            records.append(rec)
            print(json.dumps(rec), flush=True)
    return records


def run_propagation_variants(mesh_kind: str = "single", nnz=4_000_000, m=250_000, n=125_000,
                             *, device="cuda", world: int | None = None):
    """Per-round collective bytes of the two partitions of the sharded
    propagation, counted on one real round each: nnz partition
    (paper-faithful distribution) vs row partition (beyond-paper).

    Rank 0 of a fake world of the mesh's size (``world``: another size)
    prepares its shard of the JAX package's float32 perf instance on
    ``device`` and runs one round of ``core.sharded._sharded_round_fn``
    under ``roofline.counting.CostCounter``: on the card the nnz round
    launches A', the long-row combine, E and F, the row round D (or A',
    the combine and E where its rows span chunks) and F; the fake group's
    collectives move nothing.  Each record holds the counted bytes by type,
    ``core.sharded.lower_sharded``'s bytes for that partition, the round's
    kernel launches (per wrapper) and its host seconds."""
    from ..core.propagator import resolve_device
    from ..core.sharded import _nnz_shard, _row_shard, _sharded_round_fn, lower_sharded
    from ..core.types import DEFAULT_CONFIG
    from ..kernels import launch_counts, reset_launch_counts
    from ..kernels.ops import _initial_padded_bounds, prepare_block_ell

    dev = resolve_device(device)
    world = world or WORLD[mesh_kind]
    p = propagation_instance(m, n, nnz, dtype=np.float32)
    low = lower_sharded(p, world, dtype=torch.float32)
    by_op = {c.op: c.bytes for c in low.collectives_per_round}
    expected = {"nnz": float(sum(by_op.values())), "rows": float(by_op["max"] + by_op["min"])}
    out = []
    with fake_world(world):
        for key, variant, shard in (("nnz", "nnz-partition (baseline)", _nnz_shard),
                                    ("rows", "row-partition (beyond-paper)", _row_shard)):
            # The block-ELL tiles of propagate_sharded's defaults.
            prep = prepare_block_ell(shard(p, 0, world), dtype=torch.float32, device=dev)
            round_fn = _sharded_round_fn(prep, DEFAULT_CONFIG, None, p.n, nnz=key == "nnz")
            lb, ub = _initial_padded_bounds(prep, p.lb, p.ub)
            reset_launch_counts()
            t0 = time.perf_counter()
            with CostCounter() as counter:
                round_fn(lb, ub)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            coll = collective_bytes(counter)
            out.append({"variant": variant, "mesh": mesh_kind, "world": world,
                        "device": str(dev), "per_round_collective_bytes": coll,
                        "lower_sharded_bytes": expected[key],
                        "matches_lower_sharded": coll["total"] == expected[key],
                        "launches": {k: v for k, v in launch_counts().items() if v},
                        "round_host_s": seconds})
            print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, help="arch:shape")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default=None, help="run only this lever")
    ap.add_argument("--prop", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --prop runs its rounds")
    ap.add_argument("--out", default="results/perf.json")
    args = ap.parse_args(argv)

    records = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    if args.prop:
        records += run_propagation_variants(args.mesh, device=args.device)
    if args.cell:
        arch, shape = args.cell.split(":")
        levers = {args.variant: LEVERS[args.variant]} if args.variant else None
        records += run_lm_cell(arch, shape, args.mesh, levers)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
