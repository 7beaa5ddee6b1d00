"""Nestable tracing spans with a Chrome ``chrome://tracing`` exporter (a
copy of ``repro.obs.trace``: the port imports nothing of the reference).

The paper's value proposition is a *measured* number (0.224 GOPS per IP
core, §5.2), and an accelerator runtime you cannot observe is one you
cannot tune: per-layer latency breakdowns are what the FPGA-accelerator
survey literature (Guo et al. 2017, Jiang et al. 2025 — PAPERS.md) names
as the prerequisite for design-space exploration.  This module is the
span half of the obs subsystem: ``span("compile")`` /
``span("layer:conv1")`` context managers that nest, survive exceptions,
and serialize to the Chrome trace-event JSON format that Perfetto /
``chrome://tracing`` load directly.

Design constraints (the reason this is not a logging veneer):

* **monotonic clocks** — timestamps come from ``time.perf_counter_ns``
  (never ``time.time``: NTP steps corrupt wall-clock deltas), expressed
  in microseconds relative to the tracer's origin;
* **thread-safe context stack** — each thread keeps its own span stack
  (``threading.local``) so concurrent engine/scheduler threads nest
  independently, and the shared event buffer appends under a lock;
* **zero overhead when disabled** — the module-level :func:`span`
  checks one global flag and returns a singleton no-op context manager;
  no allocation, no clock read, no lock.  Tier-1 numerics and the §5.2
  anchor assertions run with tracing disabled and must not be able to
  tell it exists.

Dependency-free by construction: stdlib only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

# Chrome trace-event "complete" phase: one event carries both ts and dur.
_PHASE_COMPLETE = "X"


class _NoopSpan:
    """The disabled-path singleton: enter/exit do nothing, attribute
    writes are swallowed.  Identity-stable so tests can assert the
    disabled path allocates nothing per call."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args: Any) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One live span: a context manager that records a complete trace
    event on exit — including when the body raises (the event is
    recorded with an ``error`` arg and the exception propagates)."""

    __slots__ = ("tracer", "name", "args", "_t0", "_parent")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0
        self._parent: Optional[str] = None

    def set(self, **args: Any) -> "Span":
        """Attach/override args on the live span (e.g. results computed
        inside the body)."""
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        if stack:
            self._parent = stack[-1].name
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        stack = self.tracer._stack()
        # exception safety: pop THIS span even if an inner span leaked
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        if self._parent is not None:
            self.args.setdefault("parent", self._parent)
        self.tracer._record(self.name, self._t0, t1, self.args)
        return False                      # never swallow the exception


class Tracer:
    """A thread-safe trace-event collector.

    Spans append Chrome trace-event dicts to a shared buffer; the
    per-thread nesting stack lives in ``threading.local`` so spans on
    different threads never interleave their parentage.  ``export``
    writes the ``{"traceEvents": [...]}`` JSON object Perfetto and
    ``chrome://tracing`` load as-is."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._local = threading.local()
        self._origin_ns = time.perf_counter_ns()
        self._pid = os.getpid()

    # -- span plumbing ------------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **args: Any) -> Span:
        return Span(self, name, dict(args))

    def current_span(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def _record(self, name: str, t0_ns: int, t1_ns: int,
                args: Dict[str, Any]) -> None:
        ev = {
            "name": name,
            "ph": _PHASE_COMPLETE,
            "ts": (t0_ns - self._origin_ns) / 1e3,       # µs
            "dur": (t1_ns - t0_ns) / 1e3,                # µs
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- instant events (marks) ---------------------------------------------

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration mark (Chrome phase "i") — drift warnings and
        other point-in-time annotations."""
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",                                    # thread-scoped
            "ts": (time.perf_counter_ns() - self._origin_ns) / 1e3,
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- inspection / export -------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
        self._origin_ns = time.perf_counter_ns()

    def to_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON; returns the path (handy for CI
        artifact steps)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
        return path
