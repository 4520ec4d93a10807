"""The bounded, identity-anchored LRU behind the port's caches (prepared
instances, packed batches, batch runners, the service's engines, the
sharded engines' partitions)."""
from __future__ import annotations

import threading
from collections import OrderedDict


class LRU:
    """Bounded LRU keyed by tuples that embed ``id()`` of host objects.

    Every entry pins its ``anchors`` (the objects whose ids appear in the
    key) so an id cannot be recycled while the entry is live, and a hit is
    honoured only if every anchor is still the identical object.  Counts
    hits and misses (``kernels.ops.cache_info``).  Thread-safe."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: "OrderedDict[tuple, tuple[tuple, object]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    def get(self, key, anchors: tuple):
        with self._lock:
            hit = self._d.get(key)
            if hit is not None and all(a is b for a, b in zip(hit[0], anchors)):
                self._d.move_to_end(key)
                self.hits += 1
                return hit[1]
            self.misses += 1
            return None

    def put(self, key, anchors: tuple, value) -> None:
        with self._lock:
            self._d[key] = (anchors, value)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def info(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "size": len(self._d),
                "maxsize": self.maxsize,
            }
