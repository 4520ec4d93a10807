"""The sharded-step twin of the reference's
``test_sharded_train_step_matches_unsharded``: one train step of
``granite-3-2b`` SMOKE on a ``(2, 2)`` mesh over a world of four gloo ranks
(``make_train_step(..., mesh=)``, params, optimizer state and batch placed
with ``shard_tree``), held to the reference's UNSHARDED jitted step (loss
within 1e-3, params within 2e-2, the reference test's tolerances) and to
the port's unsharded float32 step (within 1e-5).  Runs and tolerances:
``tests/launch_step_common.py``."""
import launch_step_common as c


def test_sharded_step_matches_unsharded():
    ranks = c.sharded((("base", (), 1),))
    c.check("base", ranks, c.reference_step(), c.port_step())


def test_sharded_step_metrics_on_every_rank():
    """The metrics are replicated: every rank reads the same loss, gradient
    norm and learning rate, equal to the port's unsharded step's."""
    ranks = c.sharded((("base", (), 1),))
    first = ranks[0]["base"][0]
    assert all(r["base"][0] == first for r in ranks)
    assert set(first) >= {"loss", "ce", "moe_aux", "grad_norm", "lr"}
    assert abs(first["grad_norm"]) > 0
