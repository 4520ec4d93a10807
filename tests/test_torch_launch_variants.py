"""The sharded step with ``seq_shard=True`` (Megatron sequence
parallelism: the residual stream split over "model") on a ``(2, 2)`` mesh
over four gloo ranks, held to the reference's unsharded jitted step of the
same config (loss 1e-3, params 2e-2) and to the port's unsharded step
(1e-5).  Runs and tolerances: ``tests/launch_step_common.py``."""
import launch_step_common as c


def test_seq_shard_step_matches_unsharded():
    ranks = c.sharded((("seq_shard", (("seq_shard", True),), 1),))
    c.check("seq_shard", ranks, c.reference_step(seq_shard=True), c.port_step(seq_shard=True))
