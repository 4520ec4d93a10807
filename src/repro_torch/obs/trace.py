"""Host-side span tracing: structured timing of the service's
pump/admit/step/readback cycle and of every request's submit -> admit ->
retire lifecycle.

Spans are plain records with a pinned schema (:data:`SPAN_KEYS`), exported
as JSON-lines by :meth:`Tracer.export` -- one object per line.
``annotate=True`` also wraps each ``span()`` region in
``torch.profiler.record_function`` so the same names show up on the
profiler's timeline when a trace is being captured.

A :class:`NullTracer` stands in when tracing is off: every call is a
no-op, so instrumented hot paths pay one attribute lookup, not an if-tree.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import threading
import time

#: Pinned span schema: every exported JSON line has exactly these keys.
SPAN_KEYS = frozenset(
    {"name", "span_id", "parent_id", "t_start", "t_end", "dur_ms", "thread", "attrs"}
)

#: Schema version stamped into exports (bump on any SPAN_KEYS change).
SPAN_SCHEMA_VERSION = 1


@dataclasses.dataclass
class Span:
    """One completed span: a named ``[t_start, t_end]`` interval + attrs."""

    name: str
    span_id: int
    parent_id: int | None
    t_start: float
    t_end: float
    thread: str
    attrs: dict

    def to_dict(self) -> dict:
        """The pinned-schema dict this span exports as (one JSON line)."""
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "dur_ms": (self.t_end - self.t_start) * 1e3,
            "thread": self.thread,
            "attrs": self.attrs,
        }


class Tracer:
    """Collects spans; thread-safe; nesting tracked per thread.

    ``span(name, **attrs)`` is the context-manager form (times the block,
    parents nested spans); ``record(name, t_start, t_end, **attrs)`` logs
    an interval whose endpoints were captured elsewhere -- the service uses
    it to emit one ``ticket`` span per request at retirement from the
    timestamps the ticket already carries, with zero tracing work on the
    submit path.
    """

    def __init__(self, annotate: bool = False, clock=time.perf_counter):
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._annotate = annotate
        self._clock = clock

    def _stack(self):
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a ``with`` block as one span (nested spans get parented)."""
        sid = next(self._ids)
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(sid)
        ann = contextlib.nullcontext()
        if self._annotate:
            import torch

            ann = torch.profiler.record_function(name)
        t0 = self._clock()
        try:
            with ann:
                yield sid
        finally:
            t1 = self._clock()
            stack.pop()
            self._append(Span(name, sid, parent, t0, t1, _thread_name(), attrs))

    def record(
        self, name: str, t_start: float, t_end: float, parent_id=None, **attrs
    ) -> int:
        """Log a span from externally captured endpoints; returns its id."""
        sid = next(self._ids)
        if parent_id is None:
            stack = self._stack()
            parent_id = stack[-1] if stack else None
        self._append(Span(name, sid, parent_id, t_start, t_end, _thread_name(), attrs))
        return sid

    def _append(self, span: Span):
        with self._lock:
            self._spans.append(span)

    def spans(self) -> list[Span]:
        """Snapshot of the collected spans (copy; safe to iterate)."""
        with self._lock:
            return list(self._spans)

    def clear(self):
        """Drop every collected span (export first if you want them)."""
        with self._lock:
            self._spans.clear()

    def export(self, path=None) -> str:
        """Serialize spans as JSON-lines; write to ``path`` when given.

        Every line is one span dict with exactly :data:`SPAN_KEYS` keys.
        Returns the serialized text either way.
        """
        buf = io.StringIO()
        for s in self.spans():
            buf.write(json.dumps(s.to_dict(), default=str))
            buf.write("\n")
        text = buf.getvalue()
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


class NullTracer(Tracer):
    """Tracing disabled: same interface, every operation a no-op."""

    def __init__(self):
        super().__init__()
        self._null = contextlib.nullcontext(0)

    def span(self, name, **attrs):  # noqa: D102 -- inherited contract
        return self._null

    def record(self, name, t_start, t_end, parent_id=None, **attrs):  # noqa: D102
        return 0

    def _append(self, span):
        pass


#: Shared do-nothing tracer -- the default collaborator of instrumented code.
NULL_TRACER = NullTracer()


def _thread_name() -> str:
    return threading.current_thread().name
