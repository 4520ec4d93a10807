"""Sharded decode on DTensor caches, on a ``(2, 2)`` mesh over four gloo
ranks (``torch_launch_world.decode_cases``): ``cache_update`` writes each
rank's own slots (bitwise the plain update) and ``decode_attention`` reads
the cache where it lies, against the plain functions on the same float32
values (1e-6 of the output's scale).  A cache split over its sequence
completes the softmax with two all-reduces of (B, H, 1, D + 1) partials
and gathers nothing of the cache; one split over its KV heads runs with
no collective; an unsplit one gathers only the query's heads."""
import functools
import sys
from pathlib import Path

import pytest

from repro_torch.core import run_world

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch_world as world  # noqa: E402

TOL = 1e-6


@functools.cache
def cases() -> dict:
    return run_world(world.decode_cases, 4, timeout=300)[0]


@pytest.mark.parametrize("pos,window", world.DECODE_STEPS)
@pytest.mark.parametrize("placement", world.DECODE_PLACEMENTS)
def test_sharded_decode_matches_plain(placement, pos, window):
    cache_gap, gap, scale, counts, kept = cases()[(placement, pos, window)]
    assert cache_gap == 0.0
    assert gap <= TOL * scale, (gap, scale)
    assert kept == placement  # the updated cache keeps its placement
    if "S2" in placement:
        assert counts.get("all_reduce") == 2, counts
    else:
        assert "all_reduce" not in counts, counts
    if placement == "S0,S1":  # q's heads split as the cache's: nothing moves
        assert counts == {}, counts
