"""The port's node engine (``repro_torch.propagate_nodes``, on the CPU)
against the reference's ``repro.core.propagate_nodes``, on the cases of the
reference's own node tests, and each node against its own single-instance
run of the port.

Contract: every case here is integer-valued data, so bounds must match
bitwise (as values); ``rounds``, ``converged`` and ``infeasible`` exactly;
``progress`` to ``rtol=1e-12`` (a sum over columns taken in another order),
NaN included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
import repro_torch as rt
from repro_torch.core import nodes as tn
from repro_torch.kernels import cache_info


def _branched_nodes(p, count, fixings=3, seed=0):
    """``count`` node bound plans, each a few random branchings off root (the
    reference test's helper)."""
    rng = np.random.default_rng(seed)
    nodes = []
    for _ in range(count):
        lb, ub = p.lb.copy(), p.ub.copy()
        for var in rng.choice(p.n, size=fixings, replace=False):
            if not p.is_int[var] or lb[var] >= ub[var]:
                continue
            down, up = rc.branch_children(lb, ub, int(var), lb[var])
            lb, ub = down if rng.random() < 0.5 else up
        nodes.append((lb, ub))
    return nodes


def _assert_batch_matches(got, want):
    np.testing.assert_array_equal(got.lb.numpy(), np.asarray(want.lb))
    np.testing.assert_array_equal(got.ub.numpy(), np.asarray(want.ub))
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_array_equal(got.infeasible.numpy(), np.asarray(want.infeasible))
    np.testing.assert_allclose(got.progress.numpy(), np.asarray(want.progress),
                               rtol=1e-12, equal_nan=True)


def _assert_same_result(a, b):
    np.testing.assert_array_equal(a.lb.numpy(), b.lb.numpy())
    np.testing.assert_array_equal(a.ub.numpy(), b.ub.numpy())
    for f in ("rounds", "converged", "infeasible"):
        assert getattr(a, f).item() == getattr(b, f).item(), f


def _run_both(pr, lb, ub, ref_kw=None, **kw):
    want = rc.propagate_nodes(pr, lb, ub, **(ref_kw or dict(use_pallas=False)), **kw)
    got = rt.propagate_nodes(rt.problem_from_reference(pr), lb, ub, device="cpu", **kw)
    return got, want


CASES = {
    # name: (generator, kwargs, node count, engine kwargs)
    "knapsack": ("make_knapsack", dict(n=40, m=12, seed=1), 5, {}),
    "multichunk": ("make_knapsack", dict(n=40, m=10, seed=2), 3,
                   dict(tile_rows=2, tile_width=8)),
    "pseudo_boolean": ("make_pseudo_boolean", dict(n=60, m=80, seed=4), 6,
                       dict(tile_width=8)),
    # Rows spanning chunks through the node-batched A', combine and E.
    "multichunk_tw4": ("make_pseudo_boolean", dict(n=60, m=80, seed=4), 6,
                       dict(tile_rows=2, tile_width=4)),
    "multichunk_tw8": ("make_knapsack", dict(n=60, m=8, seed=5), 5,
                       dict(tile_rows=2, tile_width=8)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_nodes_match_reference_and_single_runs(name):
    gen, kw, count, ekw = CASES[name]
    pr = getattr(rd, gen)(**kw)
    nodes = _branched_nodes(pr, count, seed=4 if name == "multichunk" else 0)
    lb = np.stack([a for a, _ in nodes])
    ub = np.stack([b for _, b in nodes])
    got, want = _run_both(pr, lb, ub, **ekw)
    _assert_batch_matches(got, want)
    p = rt.problem_from_reference(pr)
    for i, (l, u) in enumerate(nodes):
        single = rt.propagate_block_ell(p, lb0=l, ub0=u, device="cpu", **ekw)
        _assert_same_result(got.result(i), single)


def test_nodes_match_the_pallas_node_kernel():
    """The reference's Pallas node kernel and batched merge (interpret mode)
    give the same batch."""
    pr = rd.make_knapsack(n=40, m=12, seed=1)
    nodes = _branched_nodes(pr, 5)
    lb = np.stack([a for a, _ in nodes])
    ub = np.stack([b for _, b in nodes])
    got, want = _run_both(pr, lb, ub, ref_kw=dict(use_pallas=True, interpret=True))
    _assert_batch_matches(got, want)


def test_node_round_counts_differ_per_node():
    """A root node and a tightened node of the cascade chain reach their own
    fixed points with their own round counts; a round cap cuts the longer
    one (its progress is that of its last round)."""
    c = rd.make_cascade_chain(16)
    ub_tight = c.ub.copy()
    ub_tight[0] = 0.25
    lb, ub = np.stack([c.lb, c.lb]), np.stack([c.ub, ub_tight])
    got, want = _run_both(c, lb, ub)
    _assert_batch_matches(got, want)
    assert int(got.rounds[0]) != int(got.rounds[1])
    cap = max(int(r) for r in got.rounds) - 1
    got_c = rt.propagate_nodes(rt.problem_from_reference(c), lb, ub,
                               rt.core.PropagatorConfig(max_rounds=cap), device="cpu")
    want_c = rc.propagate_nodes(c, lb, ub, rc.PropagatorConfig(max_rounds=cap),
                                use_pallas=False)
    _assert_batch_matches(got_c, want_c)
    assert not bool(got_c.converged.all())


def test_infeasible_node_does_not_touch_its_neighbours():
    pr = rd.make_knapsack(n=30, m=10, seed=3)
    bad_lb = pr.lb.copy()
    bad_lb[:] = 1.0  # select every item: violates the knapsack capacities
    lb, ub = np.stack([pr.lb, bad_lb]), np.stack([pr.ub, pr.ub])
    got, want = _run_both(pr, lb, ub)
    _assert_batch_matches(got, want)
    assert not bool(got.infeasible[0]) and bool(got.infeasible[1])
    single = rt.propagate_block_ell(rt.problem_from_reference(pr), device="cpu")
    _assert_same_result(got.result(0), single)


def test_node_batch_api_and_branching_helpers():
    pr = rd.make_pseudo_boolean(n=40, m=30, seed=2)
    p = rt.problem_from_reference(pr)
    nb = tn.NodeBatch.from_root(p, copies=3)
    assert nb.size == 3 and nb.lb.shape == (3, p.n)
    for var, value in ((5, 0.0), (7, 0.5), (9, 1.0)):
        for g, w in zip(tn.branch_children(p.lb, p.ub, var, value),
                        rc.branch_children(pr.lb, pr.ub, var, value)):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
    (dlb, dub), (ulb, uub) = tn.branch_children(p.lb, p.ub, 5, 0.0)
    nb2 = tn.NodeBatch.from_nodes(p, [(dlb, dub), (ulb, uub)])
    res = tn.propagate_node_batch(nb2, device="cpu")
    survivors = nb2.select(~res.infeasible.numpy())
    assert survivors.size == int((~res.infeasible.numpy()).sum())
    assert res.tier_rounds == 0 and res.telemetry is None


def test_pick_most_fractional_matches_reference(rng):
    for _ in range(5):
        lb = rng.integers(0, 3, 30).astype(np.float64)
        ub = lb + rng.integers(0, 3, 30)
        lb[::4] += 0.5
        is_int = rng.random(30) < 0.7
        assert tn.pick_most_fractional(lb, ub, is_int) == rc.pick_most_fractional(lb, ub, is_int)
    assert tn.pick_most_fractional(np.zeros(3), np.zeros(3), np.ones(3, bool)) is None


def test_repeated_frontiers_reuse_the_prepared_tiles():
    p = rt.problem_from_reference(rd.make_mixed(m=60, n=45, seed=8))
    nodes = _branched_nodes(p, 4, seed=5)
    lb = np.stack([a for a, _ in nodes])
    ub = np.stack([b for _, b in nodes])
    r1 = rt.propagate_nodes(p, lb, ub, device="cpu")
    hits = cache_info()["prepare_block_ell"]["hits"]
    r2 = rt.propagate_nodes(p, lb, ub, device="cpu", use_kernels=False)
    assert cache_info()["prepare_block_ell"]["hits"] == hits + 1
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        np.testing.assert_array_equal(getattr(r1, f).numpy(), getattr(r2, f).numpy())


def test_batched_fixed_point_counts_one_read_per_round():
    pr = rd.make_knapsack(n=40, m=12, seed=1)
    nodes = _branched_nodes(pr, 5)
    reads = []
    got = rt.propagate_nodes(
        rt.problem_from_reference(pr), np.stack([a for a, _ in nodes]),
        np.stack([b for _, b in nodes]), device="cpu", on_sync=lambda: reads.append(1),
    )
    assert len(reads) == int(got.rounds.max())


@pytest.mark.parametrize("kw", [dict(policy="TierPolicy"), dict(stop_progress=1e-3),
                                dict(telemetry=8), dict(patience=2)])
def test_node_requests_outside_the_slice_raise(kw):
    """The options of items 5 and 6, ported since, run and are held to the
    reference's result (with telemetry, the rounds each node's snapshot
    recorded)."""
    pr = rd.make_knapsack(n=10, m=4, seed=0)
    p = rt.problem_from_reference(pr)
    port_kw, ref_kw = dict(kw), dict(kw)
    if "policy" in kw:
        port_kw["policy"], ref_kw["policy"] = rt.core.TierPolicy(), rc.TierPolicy()
    got = rt.propagate_nodes(p, p.lb[None], p.ub[None], device="cpu", **port_kw)
    want = rc.propagate_nodes(pr, pr.lb[None], pr.ub[None], use_pallas=False, **ref_kw)
    for f in ("lb", "ub", "rounds", "converged", "infeasible", "tier_rounds"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)))
    if "telemetry" in kw:
        assert (got.node_telemetry(0).rounds_recorded
                == want.node_telemetry(0).rounds_recorded == int(got.rounds[0]))


def test_batched_step_rounds_matches_reference():
    """The resumable loop core, from a carried state with rounds already
    run, over the reference's and the port's plain node rounds."""
    import jax.numpy as jnp
    from repro import kernels as rk
    from repro_torch import kernels as tk

    pr = rd.make_knapsack(n=40, m=12, seed=1)
    nodes = _branched_nodes(pr, 5)
    n_pad = rk.col_pad(pr.n)
    lb = np.zeros((5, n_pad))
    ub = np.zeros((5, n_pad))
    lb[:, : pr.n] = np.stack([a for a, _ in nodes])
    ub[:, : pr.n] = np.stack([b for _, b in nodes])
    active = np.array([True, True, False, True, True])
    rounds = np.array([0, 2, 5, 1, 3], np.int32)
    cfg = rc.PropagatorConfig(max_rounds=4)
    r_fn = rk.node_round_fn_for(rk.prepare_block_ell(pr), cfg, use_pallas=False)
    want = rc.batched_step_rounds(
        r_fn, jnp.asarray(lb), jnp.asarray(ub), jnp.asarray(active), jnp.asarray(active),
        jnp.asarray(rounds), cfg.max_rounds, with_progress=True,
    )
    p = rt.problem_from_reference(pr)
    t_cfg = rt.core.PropagatorConfig(max_rounds=4)
    t_fn = tk.node_round_fn_for(tk.prepare_block_ell(p, device="cpu"), t_cfg, use_kernels=False)
    t = lambda x: torch.from_numpy(np.array(x))
    got = rt.core.batched_step_rounds(
        t_fn, t(lb), t(ub), t(active), t(active), t(rounds), t_cfg.max_rounds,
        with_progress=True,
    )
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, equal_nan=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # A bounded step (the service's) from the same carry: two rounds.
    want = rc.batched_step_rounds(
        r_fn, jnp.asarray(lb), jnp.asarray(ub), jnp.asarray(active), jnp.asarray(active),
        jnp.asarray(rounds), cfg.max_rounds, budget=2, with_progress=True,
    )
    got = rt.core.batched_step_rounds(t_fn, t(lb), t(ub), t(active), t(active), t(rounds), 4,
                                      budget=2, with_progress=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, equal_nan=True)
    # The per-row early stop (item 5) on the same bounded step.
    want = rc.batched_step_rounds(
        r_fn, jnp.asarray(lb), jnp.asarray(ub), jnp.asarray(active), jnp.asarray(active),
        jnp.asarray(rounds), cfg.max_rounds, budget=2, with_progress=True, stop_progress=0.1,
    )
    got = rt.core.batched_step_rounds(t_fn, t(lb), t(ub), t(active), t(active), t(rounds), 4,
                                      budget=2, with_progress=True, stop_progress=0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, equal_nan=True)


@pytest.mark.parametrize("tile_width", [4, 8])
def test_multichunk_node_round_with_free_and_inactive_slots(tile_width):
    """One multi-chunk node round over a pool with FREE (all-zero planes)
    and inactive slots: the reference's plain node round (its vmapped
    single-instance round, inactive rows frozen), and each active slot
    equal to its own single-instance round bitwise; the others pass through
    unchanged and report no change."""
    from repro import kernels as rk
    from repro_torch import kernels as tk

    pr = rd.make_knapsack(n=60, m=8, seed=5) if tile_width == 8 else \
        rd.make_pseudo_boolean(n=60, m=80, seed=4)
    nodes = _branched_nodes(pr, 4, seed=2)
    n_pad = rk.col_pad(pr.n)
    lb = np.zeros((6, n_pad))
    ub = np.zeros((6, n_pad))
    for i, (a, b) in zip((0, 1, 3, 4), nodes):
        lb[i, : pr.n], ub[i, : pr.n] = a, b
    active = np.array([True, False, False, True, True, False])  # slots 2, 5 FREE
    r_prep = rk.prepare_block_ell(pr, tile_rows=2, tile_width=tile_width)
    assert not r_prep.fits_one_chunk
    want = rk.node_round_fn_for(r_prep, use_pallas=False)(
        *(jnp.asarray(x) for x in (lb, ub, active)))
    p = rt.problem_from_reference(pr)
    prep = tk.prepare_block_ell(p, tile_rows=2, tile_width=tile_width, device="cpu")
    t = lambda x: torch.from_numpy(np.array(x))
    got = tk.node_round_fn_for(prep)(t(lb), t(ub), t(active))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    single = tk.round_fn_for(prep, fused=False)
    for i in range(6):
        if active[i]:
            one = single(t(lb[i]), t(ub[i]))
            for g, w in zip(got[:2], one[:2]):
                np.testing.assert_array_equal(g[i].numpy(), w.numpy())
            assert bool(got[2][i]) == bool(one[2])
        else:
            np.testing.assert_array_equal(got[0][i].numpy(), lb[i])
            np.testing.assert_array_equal(got[1][i].numpy(), ub[i])
            assert not bool(got[2][i])
