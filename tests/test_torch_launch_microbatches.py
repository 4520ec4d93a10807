"""The sharded step with ``microbatches=2`` on the data-sharded batch
(each microbatch the reference's slice of the global batch, placed back
over the data axes) on a ``(2, 2)`` mesh over four gloo ranks, held to the
reference's unsharded jitted step with 2 microbatches (loss 1e-3, params
2e-2) and to the port's (1e-5).  Runs and tolerances:
``tests/launch_step_common.py``."""
import launch_step_common as c


def test_microbatched_step_matches_unsharded():
    ranks = c.sharded((("microbatches", (), 2),))
    c.check("microbatches", ranks, c.reference_step(2), c.port_step(2))
