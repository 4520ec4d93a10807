"""GPU tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors, and the engine on the card against
the engine on the CPU.  Marked ``gpu``; they skip where there is no card.

This file imports neither JAX nor the JAX package, so on a machine without
JAX it runs on its own:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Kernel and plain version must agree bitwise (as values) on integer-valued
and general-float inputs alike: the plain version sums each chunk in the
kernels' order (``ref.warp_order_sum``) and the kernels are built without FMA
contraction.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
import repro_torch.data as td
from repro_torch.core import INF, col_pad
from repro_torch import kernels as tk
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _tiles(gen, t, r, k, n, integer, dev):
    val = gen.choice([-2.0, -1.0, 0.0, 1.0, 3.0], size=(t, r, k))
    col = gen.integers(0, n, size=(t, r, k)).astype(np.int32)
    col[val == 0] = 0
    n_pad = col_pad(n)
    if integer:
        lb = gen.integers(-5, 1, size=n_pad).astype(np.float64)
        ub = gen.integers(0, 6, size=n_pad).astype(np.float64)
        lhs = gen.integers(-10, 1, size=(t, r)).astype(np.float64)
        rhs = gen.integers(0, 11, size=(t, r)).astype(np.float64)
    else:
        lb, ub = gen.uniform(-5, 0, size=n_pad), gen.uniform(0, 5, size=n_pad)
        lhs, rhs = gen.uniform(-10, 0, size=(t, r)), gen.uniform(0, 10, size=(t, r))
    lb[gen.random(n_pad) < 0.15] = -INF
    ub[gen.random(n_pad) < 0.15] = INF
    ii = (gen.random((t, r, k)) < 0.5).astype(np.int32)
    ii[val == 0] = 0
    c = lambda x: torch.from_numpy(np.array(x)).to(dev)
    return dict(val=c(val), col=c(col), ii=c(ii), lb=c(lb), ub=c(ub), lhs=c(lhs),
                rhs=c(rhs), n_pad=n_pad)


def _match(got, want):
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


SHAPES = [(1, 2, 4, 3), (3, 4, 8, 20), (5, 8, 128, 300), (64, 8, 128, 5000)]


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_kernels_match_plain_versions(cuda, gen, t, r, k, n, exact):
    x = _tiles(gen, t, r, k, n, exact, cuda)
    tk.reset_launch_counts()
    d_args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], x["lb"], x["ub"], x["n_pad"], 1e-6)
    for g, w in zip(tk.fused_scatter_round_tiles(*d_args),
                    tref.fused_scatter_round_tiles_ref(*d_args)):
        _match(g, w)

    a_args = (x["val"], x["col"], x["lb"], x["ub"], x["n_pad"])
    aggs = tk.activities_gather_tiles(*a_args)
    for g, w in zip(aggs, tref.activities_gather_tiles_ref(*a_args)):
        _match(g, w)

    e_args = (x["val"], x["col"], x["ii"], *aggs, x["lhs"], x["rhs"], x["lb"], x["ub"],
              x["n_pad"], 1e-6)
    for g, w in zip(tk.candidates_scatter_tiles(*e_args),
                    tref.candidates_scatter_tiles_ref(*e_args)):
        _match(g, w)

    best_l, best_u = tref.fused_scatter_round_tiles_ref(*d_args)
    want = rt.core.apply_updates(x["lb"], x["ub"], best_l, best_u, 1e-9)
    lb, ub = x["lb"].clone(), x["ub"].clone()
    got = tk.apply_updates_tiles(lb, ub, best_l, best_u, 1e-9)
    assert got[0] is lb and got[1] is ub
    for g, w in zip(got, want):
        _match(g, w)
    called = {"fused_scatter_round_tiles", "activities_gather_tiles",
              "candidates_scatter_tiles", "apply_updates_tiles"}
    assert tk.launch_counts() == {fn.__name__: int(fn.__name__ in called) for fn in tk.KERNELS}


def test_wrappers_check_operands(cuda, gen):
    x = _tiles(gen, 2, 2, 4, 10, True, cuda)
    with pytest.raises(TypeError, match="col"):
        tk.activities_gather_tiles(x["val"], x["col"].long(), x["lb"], x["ub"], x["n_pad"])
    with pytest.raises(ValueError, match="lb"):
        tk.activities_gather_tiles(x["val"], x["col"], x["lb"][:-1], x["ub"], x["n_pad"])
    with pytest.raises(ValueError, match="device"):
        tk.activities_gather_tiles(x["val"], x["col"], x["lb"].cpu(), x["ub"], x["n_pad"])


@pytest.mark.parametrize("gen_name,kw,tile_width,exact", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 128, True),
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 4, True),
    ("make_cascade_chain", dict(length=40), 4, True),
    ("make_mixed", dict(m=600, n=450, seed=21), 128, False),
    ("make_mixed", dict(m=600, n=450, seed=21), 16, False),
])
def test_engine_on_card_matches_cpu(cuda, gen_name, kw, tile_width, exact):
    p = getattr(td, gen_name)(**kw)
    tk.reset_launch_counts()
    got = rt.propagate_block_ell(p, tile_width=tile_width)
    want = rt.propagate_block_ell(p, tile_width=tile_width, device="cpu")
    counts = tk.launch_counts()
    assert counts["apply_updates_tiles"] == int(got.rounds)
    if tk.rows_fit_one_chunk(p, tile_width):
        assert counts["fused_scatter_round_tiles"] == int(got.rounds)
    else:
        rounds = int(got.rounds)
        assert counts["activities_gather_tiles"] == counts["candidates_scatter_tiles"] == rounds
    assert got.lb.device.type == "cuda"
    for f in ("rounds", "converged", "infeasible"):
        assert getattr(got, f).item() == getattr(want, f).item()
    if exact:
        np.testing.assert_array_equal(got.lb.cpu().numpy(), want.lb.numpy())
        np.testing.assert_array_equal(got.ub.cpu().numpy(), want.ub.numpy())
    else:
        assert rt.bounds_equal(got.lb, got.ub, want.lb, want.ub)


def _planes(gen, bsz, n_pad, integer, dev):
    if integer:
        lb = gen.integers(-5, 1, size=(bsz, n_pad)).astype(np.float64)
        ub = gen.integers(0, 6, size=(bsz, n_pad)).astype(np.float64)
    else:
        lb, ub = gen.uniform(-5, 0, size=(bsz, n_pad)), gen.uniform(0, 5, size=(bsz, n_pad))
    lb[gen.random((bsz, n_pad)) < 0.1] = -INF
    ub[gen.random((bsz, n_pad)) < 0.1] = INF
    c = lambda x: torch.from_numpy(np.array(x)).to(dev)
    return c(lb), c(ub)


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
@pytest.mark.parametrize("bsz", [1, 5])
def test_node_kernels_match_plain_versions(cuda, gen, t, r, k, n, bsz, exact):
    x = _tiles(gen, t, r, k, n, exact, cuda)
    lb, ub = _planes(gen, bsz, x["n_pad"], exact, cuda)
    for act in (torch.ones(bsz, dtype=torch.bool), torch.arange(bsz) % 2 == 0,
                torch.zeros(bsz, dtype=torch.bool)):
        act = act.to(cuda)
        tk.reset_launch_counts()
        args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], lb, ub, act, x["n_pad"], 1e-6)
        got = tk.node_fused_scatter_round_tiles(*args)
        want = tref.node_fused_scatter_round_ref(*args[:7], x["n_pad"], 1e-6, active=act)
        for g, w in zip(got, want):
            _match(g, w)
        best_l, best_u = want
        want_m = rt.core.apply_updates_batch(lb, ub, best_l, best_u, 1e-9, active=act)
        glb, gub = lb.clone(), ub.clone()
        got_m = tk.apply_updates_batch_tiles(glb, gub, best_l, best_u, act, 1e-9)
        assert got_m[0] is glb
        for g, w in zip(got_m, want_m):
            _match(g, w)
        counts = tk.launch_counts()
        assert counts["node_fused_scatter_round_tiles"] == counts["apply_updates_batch_tiles"] == 1


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("bsz,n", [(1, 5), (4, 3000), (3, 60000)])
def test_node_objective_matches_plain_version(cuda, gen, bsz, n, exact):
    n_pad = col_pad(n)
    lb, ub = _planes(gen, bsz, n_pad, exact, cuda)
    if exact:
        c = gen.integers(-4, 5, n_pad).astype(np.float64)
    else:
        c = gen.standard_normal(n_pad) * 10.0 ** gen.integers(-3, 4, n_pad)
    valid = np.arange(n_pad) < n
    c[~valid] = 0.0
    ub[0] = lb[0]  # a fixed node
    to = lambda a: torch.from_numpy(np.array(a)).to(cuda)
    args = (lb, ub, to(c), to(gen.random(n_pad) < 0.7), to(valid), 1e-8)
    for g, w in zip(tk.node_objective_tiles(*args), tref.node_objective_ref(*args)):
        _match(g, w)


@pytest.mark.parametrize("lengths", [[3, 1, 5, 2], [40, 1, 300, 7]])
def test_combine_matches_plain_version(cuda, gen, lengths):
    counts = np.array(lengths)
    m = len(counts)
    n_chunks = int(counts.sum()) + 3
    crow = np.concatenate([np.repeat(np.arange(m), counts), [m] * 3]).astype(np.int32)
    row_start = np.concatenate([[0], np.cumsum(counts), [n_chunks]]).astype(np.int64)
    to = lambda a: torch.from_numpy(np.array(a)).to(cuda).reshape(-1, 1)
    parts = (gen.standard_normal(n_chunks) * 10.0 ** gen.integers(-8, 9, n_chunks),
             gen.integers(0, 3, n_chunks).astype(np.int32),
             gen.standard_normal(n_chunks) * 10.0 ** gen.integers(-8, 9, n_chunks),
             gen.integers(0, 3, n_chunks).astype(np.int32))
    args = (*map(to, parts), to(crow), to(row_start).reshape(-1))
    for g, w in zip(tk.combine_chunk_partials_tiles(*args), tref.combine_chunk_partials_ref(*args)):
        _match(g, w)


def _nodes(p, count, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        lb, ub = p.lb.copy(), p.ub.copy()
        for var in rng.choice(p.n, size=3, replace=False):
            if p.is_int[var] and lb[var] < ub[var]:
                down, up = rt.core.branch_children(lb, ub, int(var), lb[var])
                lb, ub = down if rng.random() < 0.5 else up
        out.append((lb, ub))
    return np.stack([a for a, _ in out]), np.stack([b for _, b in out])


@pytest.mark.parametrize("gen_name,kw,tile_width", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 8),
    ("make_knapsack", dict(n=40, m=10, seed=2), 8),
    ("make_mixed", dict(m=600, n=450, seed=21), 16),
])
def test_nodes_on_card_match_plain_path_and_single_runs(cuda, gen_name, kw, tile_width):
    p = getattr(td, gen_name)(**kw)
    lb, ub = _nodes(p, 6)
    tk.reset_launch_counts()
    got = rt.propagate_nodes(p, lb, ub, tile_width=tile_width)
    counts = tk.launch_counts()
    plain = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, use_kernels=False)
    if tk.rows_fit_one_chunk(p, tile_width):
        assert counts["node_fused_scatter_round_tiles"] == int(got.rounds.max())
    else:
        assert counts["combine_chunk_partials_tiles"] > 0
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        _match(getattr(got, f), getattr(plain, f))
    for i in range(lb.shape[0]):
        single = rt.propagate_block_ell(p, tile_width=tile_width, lb0=lb[i], ub0=ub[i])
        _match(got.lb[i], single.lb)
        _match(got.ub[i], single.ub)
        assert got.rounds[i].item() == single.rounds.item()


def test_solve_on_card_matches_plain_path(cuda):
    p = td.make_pseudo_boolean(n=40, m=56, seed=3)
    c = np.arange(1, p.n + 1, dtype=np.float64) * np.where(np.arange(p.n) % 3 == 0, -1.0, 1.0)
    tk.reset_launch_counts()
    a = rt.solve(p, c, node_cap=64, max_levels=12)
    assert tk.launch_counts()["node_objective_tiles"] == a.levels
    b = rt.solve(p, c, node_cap=64, max_levels=12, use_kernels=False)
    for f in ("status", "objective", "nodes_expanded", "nodes_created", "leaves",
              "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
              "incumbent_trajectory"):
        assert getattr(a, f) == getattr(b, f), f
    for x, y in zip(a.carry, b.carry):
        _match(x, y)


# ---------------------------------------------------------------------------
# The column-slab partitioned engine: kernels #11-#15
# ---------------------------------------------------------------------------


def _packed_partition(problems, tile_width, slab, dev):
    """One slab partition over the tile streams of several instances (run
    maps route each copy to its own instance's plane row)."""
    from repro_torch.kernels import build_slab_partition

    preps = [rt.prepare_block_ell(p, tile_width=tile_width, device="cpu") for p in problems]
    n_pad = max(q.n_pad for q in preps)
    vals, cols, crows, insts, lhs, rhs, dummies = [], [], [], [], [], [], []
    is_int = np.zeros((len(preps), n_pad), bool)
    off = 0
    for i, q in enumerate(preps):
        vals.append(q.d.val.numpy())
        cols.append(q.d.col.numpy())
        crows.append(q.d.chunk_row.numpy() + off)
        insts.append(np.full(q.d.val.shape[0], i, np.int32))
        lhs.append(q.d.lhs1.numpy())
        rhs.append(q.d.rhs1.numpy())
        is_int[i, : q.n] = q.d.is_int.numpy()
        dummies.append(off + q.m)
        off += q.m + 1
    return build_slab_partition(
        np.concatenate(vals), np.concatenate(cols), np.concatenate(crows),
        np.concatenate(insts), np.concatenate(lhs), np.concatenate(rhs), is_int, n_pad, slab,
        np.array(dummies, np.int32), device=dev,
    ), n_pad


SLAB_CASES = [
    # (generator, kwargs, tile width, slab, integer data)
    ("make_knapsack", dict(n=280, m=8, seed=5), 8, 128, True),
    ("make_mixed", dict(m=30, n=280, seed=0), 16, 128, False),
    ("make_banded", dict(n=3000, m=400, row_nnz=12, band=600, seed=1), 128, 256, False),
]


@pytest.mark.parametrize("instances", [1, 3])
@pytest.mark.parametrize("gen_name,kw,tile_width,slab,exact", SLAB_CASES)
def test_slab_kernels_match_plain_versions(cuda, gen, gen_name, kw, tile_width, slab, exact,
                                           instances):
    problems = [getattr(td, gen_name)(**{**kw, "seed": kw["seed"] + i}) for i in range(instances)]
    part, n_pad = _packed_partition(problems, tile_width, slab, cuda)
    assert part.has_straddle
    for width in (part.n_pad_part, n_pad):
        lb, ub = _planes(gen, instances, width, exact, cuda)
        for act in (torch.ones(instances, dtype=torch.bool), torch.arange(instances) % 2 == 0,
                    torch.zeros(instances, dtype=torch.bool)):
            act = act.to(cuda)
            tk.reset_launch_counts()
            a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len,
                      part.a_run_inst, part.a_run_slab, act, lb, ub, slab, part.a_max_run_len)
            partials = tk.batched_slab_partials_tiles(*a_args)
            for g, w in zip(partials, tref.batched_slab_partials_ref(*a_args)):
                _match(g, w)
            strs = tref.straddle_tables(part, *partials,
                                        combine=tk.combine_chunk_partials_tiles)
            for g, w in zip(strs, tref.straddle_tables(part, *partials)):
                _match(g, w)
            r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g,
                      part.rhs_g, part.run_start, part.run_len, part.run_inst, part.run_slab,
                      act)
            want = tref.batched_slab_round_ref(*r_args, lb, ub, slab, part.max_run_len, 1e-9,
                                               1e-6)
            glb, gub = lb.clone(), ub.clone()
            got = tk.batched_slab_round_tiles(*r_args, glb, gub, slab, part.max_run_len, 1e-9,
                                              1e-6)
            assert got[0] is glb and got[1] is gub
            for g, w in zip(got, want):
                _match(g, w)
            assert tk.launch_counts() == {
                fn.__name__: int(fn.__name__ in ("batched_slab_partials_tiles",
                                                 "combine_chunk_partials_tiles",
                                                 "batched_slab_round_tiles",
                                                 "apply_updates_slab_tiles"))
                for fn in tk.KERNELS
            }


@pytest.mark.parametrize("bsz", [1, 5, 40])
@pytest.mark.parametrize("gen_name,kw,tile_width,slab,exact", SLAB_CASES)
def test_node_slab_kernels_match_plain_versions(cuda, gen, gen_name, kw, tile_width, slab,
                                                exact, bsz):
    p = getattr(td, gen_name)(**kw)
    prep = rt.prepare_block_ell(p, tile_width=tile_width)
    part = prep.slab_partition(slab)
    lb, ub = _planes(gen, bsz, prep.n_pad, exact, cuda)
    for act in (torch.ones(bsz, dtype=torch.bool), torch.arange(bsz) % 3 == 1,
                torch.zeros(bsz, dtype=torch.bool)):
        act = act.to(cuda)
        tk.reset_launch_counts()
        a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
                  act, lb, ub, slab, part.a_max_run_len)
        partials = tk.node_slab_partials_tiles(*a_args)
        for g, w in zip(partials, tref.node_slab_partials_ref(*a_args)):
            _match(g, w)
        strs = tref.straddle_tables(part, *partials, combine=tk.combine_chunk_partials_tiles)
        r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g,
                  part.rhs_g, part.run_start, part.run_len, part.run_slab, act)
        want = tref.node_slab_round_ref(*r_args, lb, ub, slab, part.max_run_len, 1e-9, 1e-6)
        glb, gub = lb.clone(), ub.clone()
        got = tk.node_slab_round_tiles(*r_args, glb, gub, slab, part.max_run_len, 1e-9, 1e-6)
        for g, w in zip(got, want):
            _match(g, w)
        # Each active node equals the single-instance kernels on its plane.
        for i in act.nonzero().flatten().tolist()[:3]:
            one = tk.batched_slab_partials_tiles(
                part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
                part.a_run_slab, act[i : i + 1], lb[i : i + 1].contiguous(),
                ub[i : i + 1].contiguous(), slab, part.a_max_run_len)
            for g, w in zip(partials, one):
                _match(g[i], w)
        counts = tk.launch_counts()
        assert counts["node_slab_partials_tiles"] == counts["node_slab_round_tiles"] == 1


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("bsz,width", [(1, 512), (4, 300), (3, 150_016)])
def test_window_merge_matches_plain_version(cuda, gen, bsz, width, exact):
    lb, ub = _planes(gen, bsz, width, exact, cuda)
    bl, bu = _planes(gen, bsz, width, exact, cuda)
    bl, bu = bl - 1.0, bu + 1.0
    act = (torch.arange(bsz) % 2 == 0).to(cuda)
    want = tref.apply_updates_slab_ref(lb, ub, bl, bu, act, 128, 1e-9)
    glb, gub = lb.clone(), ub.clone()
    tk.reset_launch_counts()
    got = tk.apply_updates_slab_tiles(glb, gub, bl, bu, act, 128, 1e-9)
    assert got[0] is glb and tk.launch_counts()["apply_updates_slab_tiles"] == 1
    _match(got[0], want[0])
    _match(got[1], want[1])
    _match(got[2], want[2].any(dim=1))


@pytest.mark.parametrize("gen_name,kw,tile_width,exact", [
    ("make_knapsack", dict(n=280, m=8, seed=5), 8, True),
    ("make_mixed", dict(m=35, n=300, seed=1), 32, False),
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 8, True),
])
def test_partitioned_engine_on_card_matches_plain_path(cuda, gen_name, kw, tile_width, exact):
    p = getattr(td, gen_name)(**kw)
    tk.reset_launch_counts()
    got = rt.propagate_block_ell(p, tile_width=tile_width, scatter="partitioned", slab=128)
    counts = tk.launch_counts()
    rounds = int(got.rounds)
    assert counts["batched_slab_round_tiles"] == counts["apply_updates_slab_tiles"] == rounds
    assert counts["batched_slab_partials_tiles"] == rounds
    assert counts["fused_scatter_round_tiles"] == 0
    plain = rt.propagate_block_ell(p, tile_width=tile_width, scatter="partitioned", slab=128,
                                   use_kernels=False)
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        _match(getattr(got, f), getattr(plain, f))
    cpu = rt.propagate_block_ell(p, tile_width=tile_width, scatter="partitioned", slab=128,
                                 device="cpu")
    _match(got.lb, cpu.lb.to(cuda))
    _match(got.ub, cpu.ub.to(cuda))


def test_instance_past_the_limit_on_card(cuda):
    """``auto`` past 2^16 columns takes the partitioned kernels; explicit
    ``fused`` runs D + F there; both agree with the plain path."""
    p = td.make_banded(n=tk.SCATTER_MAX_NPAD + 4000, m=3000, row_nnz=8, band=2000, seed=2)
    tk.reset_launch_counts()
    got = rt.propagate_block_ell(p)
    counts = tk.launch_counts()
    assert counts["batched_slab_round_tiles"] == int(got.rounds) > 0
    assert counts["fused_scatter_round_tiles"] == 0
    plain = rt.propagate_block_ell(p, use_kernels=False)
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        _match(getattr(got, f), getattr(plain, f))
    fused = rt.propagate_block_ell(p, scatter="fused")
    assert tk.launch_counts()["fused_scatter_round_tiles"] == int(fused.rounds)
    for f in ("rounds", "converged", "infeasible"):
        assert getattr(fused, f).item() == getattr(got, f).item()
    assert rt.bounds_equal(fused.lb, fused.ub, got.lb, got.ub)


@pytest.fixture
def small_limit(monkeypatch):
    from repro_torch.kernels import ops

    ops.clear_prepare_cache()
    monkeypatch.setattr(ops, "SCATTER_MAX_NPAD", 128)
    monkeypatch.setattr(ops, "SLAB_NPAD", 128)
    yield
    ops.clear_prepare_cache()


@pytest.mark.parametrize("gen_name,kw,tile_width", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 8),
    ("make_mixed", dict(m=600, n=450, seed=21), 16),
])
def test_nodes_past_the_limit_on_card(cuda, small_limit, gen_name, kw, tile_width):
    p = getattr(td, gen_name)(**kw)
    lb, ub = _nodes(p, 6)
    tk.reset_launch_counts()
    got = rt.propagate_nodes(p, lb, ub, tile_width=tile_width)
    counts = tk.launch_counts()
    assert counts["node_slab_round_tiles"] == int(got.rounds.max())
    assert counts["node_slab_partials_tiles"] == int(got.rounds.max())
    assert counts["node_fused_scatter_round_tiles"] == 0
    plain = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, use_kernels=False)
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        _match(getattr(got, f), getattr(plain, f))
    for i in range(lb.shape[0]):
        single = rt.propagate_block_ell(p, tile_width=tile_width, lb0=lb[i], ub0=ub[i])
        _match(got.lb[i], single.lb)
        _match(got.ub[i], single.ub)
        assert got.rounds[i].item() == single.rounds.item()


def test_solve_past_the_limit_on_card(cuda, small_limit):
    p = td.make_pseudo_boolean(n=200, m=260, seed=1)
    c = np.arange(1, p.n + 1, dtype=np.float64) * np.where(np.arange(p.n) % 3 == 0, -1.0, 1.0)
    tk.reset_launch_counts()
    a = rt.solve(p, c, node_cap=32)
    counts = tk.launch_counts()
    assert counts["node_slab_round_tiles"] > 0 and counts["node_fused_scatter_round_tiles"] == 0
    b = rt.solve(p, c, node_cap=32, use_kernels=False)
    for f in ("status", "objective", "nodes_expanded", "nodes_created", "leaves",
              "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
              "incumbent_trajectory"):
        assert getattr(a, f) == getattr(b, f), f
    for x, y in zip(a.carry, b.carry):
        _match(x, y)


# ---------------------------------------------------------------------------
# Kernel #8, the batched engine and the service
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("mask", ["on", "mixed", "off"])
@pytest.mark.parametrize("sizes,r,k,n", [((2, 3, 1), 4, 8, 20), ((1, 4, 2), 8, 128, 300),
                                         ((40, 7, 90), 8, 4, 5000)])
def test_batched_fused_kernel_matches_plain_version(cuda, gen, sizes, r, k, n, mask, exact):
    bsz = len(sizes)
    xs = [_tiles(gen, s, r, k, n, exact, cuda) for s in sizes]
    cat = lambda f: torch.cat([x[f] for x in xs])
    val, col, ii, lhs, rhs = cat("val"), cat("col"), cat("ii"), cat("lhs"), cat("rhs")
    lb = torch.stack([x["lb"] for x in xs])
    ub = torch.stack([x["ub"] for x in xs])
    n_pad = xs[0]["n_pad"]
    tile_inst = torch.repeat_interleave(torch.arange(bsz, dtype=torch.int32, device=cuda),
                                        torch.tensor(sizes, device=cuda))
    active = torch.tensor({"on": [True] * 3, "mixed": [True, False, True],
                           "off": [False] * 3}[mask], device=cuda)
    tk.reset_launch_counts()
    got = tk.batched_fused_scatter_round_tiles(val, col, ii, lhs, rhs, lb, ub, tile_inst,
                                               active, n_pad, 1e-6)
    assert tk.launch_counts()["batched_fused_scatter_round_tiles"] == 1
    want = tref.batched_fused_scatter_round_ref(
        val, tref.global_columns(col, tile_inst, n_pad), ii, lhs, rhs, lb, ub, n_pad, 1e-6,
        active=active)
    for g, w in zip(got, want):
        _match(g, w)
    for i, x in enumerate(xs):
        if not active[i]:
            assert (got[0][i] == -INF).all() and (got[1][i] == INF).all()
            continue
        one = tk.fused_scatter_round_tiles(x["val"], x["col"], x["ii"], x["lhs"], x["rhs"],
                                           x["lb"], x["ub"], n_pad, 1e-6)
        _match(got[0][i], one[0])
        _match(got[1][i], one[1])
    lbw, ubw = lb.clone(), ub.clone()
    occ = tk.batched_occupancy_round_tiles(val, col, ii, lhs, rhs, lbw, ubw, tile_inst, active,
                                           n_pad, 1e-9, 1e-6)
    merged = rt.core.apply_updates_batch(lb, ub, *want, 1e-9, active=active)
    assert occ[0] is lbw and tk.launch_counts()["apply_updates_batch_tiles"] == 1
    for g, w in zip(occ, merged):
        _match(g, w)


BATCHES = [
    # (population, tile width): rows in one chunk (#8 + #9) and spanning chunks.
    (lambda: [td.make_pseudo_boolean(n=3000, m=4000, seed=s) for s in (7, 8, 9)], 128),
    (lambda: [td.make_mixed(m=600, n=450, seed=s) for s in (21, 22, 23)], 16),
    (lambda: [td.make_knapsack(n=200, m=30, seed=s) for s in range(4)], 8),
]


@pytest.mark.parametrize("case", range(len(BATCHES)))
def test_batch_on_card_matches_plain_path_and_single_runs(cuda, case):
    make, tile_width = BATCHES[case]
    probs = make()
    tk.reset_launch_counts()
    got = rt.propagate_batch(probs, tile_width=tile_width)
    counts = tk.launch_counts()
    fused = all(int(np.diff(p.csr.row_ptr).max()) <= tile_width for p in probs)
    branch = "batched_fused_scatter_round_tiles" if fused else "combine_chunk_partials_tiles"
    rounds = max(int(r.rounds) for r in got)
    assert counts[branch] == counts["apply_updates_batch_tiles"] == rounds
    plain = rt.propagate_batch(probs, tile_width=tile_width, use_kernels=False)
    host = rt.propagate_batch(probs, tile_width=tile_width, driver="host_loop")
    for p, g, w, h in zip(probs, got, plain, host):
        single = rt.propagate_block_ell(p, tile_width=tile_width)
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            _match(getattr(g, f), getattr(w, f))
            _match(getattr(g, f), getattr(h, f))
            _match(getattr(g, f), getattr(single, f))
        _match(g.progress, w.progress)


def test_batch_past_the_limit_on_card(cuda, small_limit):
    probs = [td.make_knapsack(n=280, m=8, seed=5), td.make_set_cover(n=270, m=25, seed=6)]
    tk.reset_launch_counts()
    got = rt.propagate_batch(probs, tile_rows=2, tile_width=8)
    counts = tk.launch_counts()
    assert counts["batched_slab_round_tiles"] == max(int(r.rounds) for r in got) > 0
    assert counts["batched_fused_scatter_round_tiles"] == 0
    plain = rt.propagate_batch(probs, tile_rows=2, tile_width=8, use_kernels=False)
    for p, g, w in zip(probs, got, plain):
        single = rt.propagate_block_ell(p, tile_rows=2, tile_width=8)
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            _match(getattr(g, f), getattr(w, f))
            _match(getattr(g, f), getattr(single, f))


@pytest.mark.parametrize("tile_width", [128, 4])
def test_service_on_card_matches_one_shot(cuda, tile_width):
    """Fused (#8 + #9 at tile width 128) and multi-chunk (A', combine, E, #9
    at 4, where rows of 5 to 8 nonzeros span two chunks) buckets through
    two slots, inline and from the background thread: every ticket bitwise
    against the one-shot batch; nothing is built after construction."""
    probs = [td.make_pseudo_boolean(n=3000, m=m, seed=s)
             for s, m in enumerate((4000, 2500, 3500, 3000, 1800))]
    svc = rt.PropagationService.from_problems(probs, slots=2, tile_width=tile_width)
    cc = svc.compile_counts()
    tk.reset_launch_counts()
    results = svc.serve(probs)
    counts = tk.launch_counts()
    if tile_width == 128:
        assert counts["batched_fused_scatter_round_tiles"] > 0
    else:
        assert counts["activities_gather_tiles"] == counts["candidates_scatter_tiles"] > 0
    with svc:
        tickets = [svc.submit(p) for p in probs]
        threaded = [t.result(timeout=60) for t in tickets]
    assert svc.compile_counts() == cc
    for p, r, t in zip(probs, results, threaded):
        one = rt.propagate_batch([p], tile_width=tile_width)[0]
        for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
            _match(getattr(r, f).to(cuda), getattr(one, f))
            _match(getattr(t, f).to(cuda), getattr(one, f))
