"""Unified metrics registry.

Every metrics source of the port has its own accessor: the engines' LRU
``cache_info()``, the service's per-bucket ``compile_counts()``, packing
``batch_stats()`` fill histograms, service counters.
:class:`MetricsRegistry` puts them behind one ``snapshot()`` with a pinned
top-level schema (:data:`SNAPSHOT_KEYS`), so
``PropagationService.stats()['metrics']`` reports through a single shape.

Sources are zero-arg callables registered by name; a failing source lands
in ``errors`` instead of taking the snapshot down -- observability must
never crash the thing it observes.

:func:`run_metadata` stamps a benchmark's results with the environment that
produced them (git commit, time, torch and CUDA versions, the card and its
power limit).
"""
from __future__ import annotations

import datetime
import subprocess
import threading
from pathlib import Path

#: Pinned top-level snapshot schema.
SNAPSHOT_KEYS = frozenset({"schema_version", "sources", "errors"})

#: Schema version stamped into snapshots (bump on any SNAPSHOT_KEYS change).
SNAPSHOT_SCHEMA_VERSION = 1


class MetricsRegistry:
    """Named zero-arg metric sources behind one pinned-schema snapshot.

    ``register(name, fn)`` adds a source whose ``fn()`` returns any
    JSON-able value; ``snapshot()`` evaluates them all under the pinned
    envelope ``{schema_version, sources, errors}``.  Thread-safe: sources
    may be registered while another thread snapshots.
    """

    def __init__(self):
        self._sources: dict[str, object] = {}
        self._lock = threading.Lock()

    def register(self, name: str, fn, replace: bool = False):
        """Add source ``name`` -> ``fn()``; re-registering needs ``replace``."""
        with self._lock:
            if name in self._sources and not replace:
                raise ValueError(f"metrics source already registered: {name!r}")
            self._sources[name] = fn

    def unregister(self, name: str):
        """Remove a source (missing names are a no-op)."""
        with self._lock:
            self._sources.pop(name, None)

    def source_names(self) -> tuple:
        """Registered source names, sorted."""
        with self._lock:
            return tuple(sorted(self._sources))

    def snapshot(self) -> dict:
        """Evaluate every source: ``{schema_version, sources, errors}``.

        A source that raises contributes ``errors[name] = repr(exc)``
        rather than propagating -- one broken gauge never blinds the rest.
        """
        with self._lock:
            items = list(self._sources.items())
        sources, errors = {}, {}
        for name, fn in items:
            try:
                sources[name] = fn()
            except Exception as e:  # noqa: BLE001 -- isolation is the contract
                errors[name] = repr(e)
        return {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "sources": sources,
            "errors": errors,
        }


def default_registry() -> MetricsRegistry:
    """Registry preloaded with the process-wide sources every run has:
    the kernel engines' LRU ``cache_info()``.  Callers (the service
    constructor) add their own instance-scoped sources on top."""
    from ..kernels.ops import cache_info  # lazy: kernels imports core, core the service

    reg = MetricsRegistry()
    reg.register("kernel_caches", cache_info)
    return reg


def _run(cmd: list, timeout: float = 10.0) -> str:
    """``cmd``'s standard output, stripped, run beside the package; ``""``
    where it cannot run or fails."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, check=True,
                             cwd=Path(__file__).resolve().parent)
    except Exception:  # noqa: BLE001 -- metadata never raises
        return ""
    return out.stdout.strip()


def run_metadata() -> dict:
    """Environment fingerprint for a benchmark's results: ``git_commit``,
    ``timestamp`` (UTC), ``torch_version``, ``cuda_version``, ``backend``
    (``"cuda"`` where a card is usable, else ``"cpu"``), and ``device`` and
    ``power_limit`` as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (the first card's).  Never raises: a
    field that cannot be read is ``"unknown"``."""
    commit = _run(["git", "rev-parse", "--short", "HEAD"]) or "unknown"
    try:
        import torch

        torch_version = str(torch.__version__)
        cuda_version = str(torch.version.cuda) if torch.version.cuda else "unknown"
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:  # noqa: BLE001
        torch_version = cuda_version = backend = "unknown"
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    first = smi.splitlines()[0] if smi else ""
    name, _, power = first.partition(",")
    return {
        "git_commit": commit,
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
        "torch_version": torch_version,
        "cuda_version": cuda_version,
        "backend": backend,
        "device": name.strip() or "unknown",
        "power_limit": power.strip() or "unknown",
    }
