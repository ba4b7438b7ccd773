"""Clock-injected span primitives with a pluggable structured sink.

A copy of the JAX package's ``obs/trace.py`` with the same record
format, so a ``--trace-log`` written by the port reads like one written
by the JAX server. Span records are emitted on close, one JSON object per
line::

    {"trace": 3, "span": 9, "parent": 8, "name": "serve-step",
     "start": 1722700123.4, "duration_s": 0.018,
     "attrs": {"chunk": 4, "running": 2}, "error": null}

``trace`` groups the spans of one root span; ``parent`` rebuilds the
tree. Durations come from the injected monotonic clock, start stamps
from its wall view.
"""

from __future__ import annotations

import abc
import itertools
import json
import os
import threading
from typing import Any, Dict, List, Optional

from ..utils.clock import Clock, RealClock

# a JSONL sink rotates once its live file crosses this cap: one rename to
# a ".1" sibling, so the disk it takes stays at about twice the cap
DEFAULT_MAX_LOG_BYTES = 64 * 1024 * 1024


def rotate_jsonl(fh, path: str):
    """Close ``fh``, move ``path`` to ``path + ".1"`` (replacing any
    previous rotation), and reopen ``path`` fresh for append."""
    fh.close()
    os.replace(path, path + ".1")
    return open(path, "a", encoding="utf-8")


class Sink(abc.ABC):
    """Where finished span records go."""

    @abc.abstractmethod
    def emit(self, record: Dict[str, Any]) -> None: ...


class NullSink(Sink):
    def emit(self, record: Dict[str, Any]) -> None:
        pass


class ListSink(Sink):
    """Collects records in memory (tests)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def emit(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self.records.append(record)


class JsonlSink(Sink):
    """One JSON object per line, flushed per span, so the file can be
    tailed while the server runs. Past ``max_bytes`` the live file
    rotates to a ``.1`` sibling (one generation kept)."""

    def __init__(self, path: str, max_bytes: int = DEFAULT_MAX_LOG_BYTES):
        self._path = path
        self._max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8")

    def emit(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, separators=(",", ":"), sort_keys=True)
        with self._lock:
            if (self._max_bytes > 0 and self._fh.tell() > 0
                    and self._fh.tell() + len(line) + 1 > self._max_bytes):
                self._fh = rotate_jsonl(self._fh, self._path)
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            self._fh.close()


class Span:
    """One timed unit of work. Use via :meth:`Tracer.span`; set attributes
    with ``span.set(key, value)`` while open."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_wall",
                 "_start_mono", "attrs", "error")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: Optional[int], start_wall: float,
                 start_mono: float, attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_wall = start_wall
        self._start_mono = start_mono
        self.attrs = attrs
        self.error: Optional[str] = None

    def set(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def to_record(self, duration_s: float) -> Dict[str, Any]:
        return {"trace": self.trace_id, "span": self.span_id,
                "parent": self.parent_id, "name": self.name,
                "start": self.start_wall, "duration_s": duration_s,
                "attrs": self.attrs, "error": self.error}


class Tracer:
    """Builds the span tree. Nesting is tracked per thread; a span opened
    with no parent starts a new trace."""

    def __init__(self, sink: Optional[Sink] = None,
                 clock: Optional[Clock] = None):
        self.sink = sink or NullSink()
        self._clock = clock or RealClock()
        self._trace_ids = itertools.count(1)
        self._span_ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs: Any) -> "_SpanContext":
        return _SpanContext(self, name, attrs)


class _SpanContext:
    def __init__(self, tracer: Tracer, name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._span: Optional[Span] = None

    def __enter__(self) -> Span:
        tracer = self._tracer
        stack = tracer._stack()
        parent = stack[-1] if stack else None
        trace_id = parent.trace_id if parent else next(tracer._trace_ids)
        self._span = Span(
            name=self._name, trace_id=trace_id,
            span_id=next(tracer._span_ids),
            parent_id=parent.span_id if parent else None,
            start_wall=tracer._clock.wall(),
            start_mono=tracer._clock.now(), attrs=self._attrs)
        stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        span = self._span
        tracer = self._tracer
        stack = tracer._stack()
        if stack and stack[-1] is span:
            stack.pop()
        if exc_type is not None and span.error is None:
            span.error = exc_type.__name__
        duration = max(0.0, tracer._clock.now() - span._start_mono)
        tracer.sink.emit(span.to_record(duration))
        return False  # never swallow
