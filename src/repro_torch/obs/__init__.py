"""obs — the telemetry subsystem: spans, metrics, per-layer profiles,
drift detection (counterpart of ``repro.obs``).

* ``obs.span("engine.batch", ...)`` — nestable trace spans (``obs/trace.py``)
  exported as Chrome ``chrome://tracing`` JSON that Perfetto loads;
* ``obs.metrics`` — the process-global :class:`MetricsRegistry`
  (``obs/metrics.py``): counters, gauges, p50/p90/p99 histograms, JSONL
  export, ``reset()`` for tests;
* ``obs.profile.profile_network`` — per-layer wall time / psums /
  achieved GOPS / the §5.2 model's predicted time over an int8
  ``NetworkPlan`` program, plus the drift detector (``obs/profile.py``).

**Disabled by default, zero overhead when disabled.**  ``obs.span``
checks one module flag and returns a shared no-op context manager.
Enable with ``obs.enable()`` or by exporting ``REPRO_OBS=1`` before
import.  ``obs.metrics`` is live regardless of the flag (serving code
reads its counts), but nothing records spans or profiles layers unless
enabled.  ``obs.dump(dir)`` writes the trace (``obs_trace.json``) and the
metrics (``obs_metrics.jsonl``).

``metrics`` and ``trace`` are stdlib-only copies of the reference's
modules; the package imports nothing of ``repro``.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, default_buckets)
from repro_torch.obs.trace import NOOP_SPAN, Span, Tracer  # noqa: F401

_enabled = False
tracer = Tracer()
metrics = MetricsRegistry()


def enable() -> None:
    """Turn span recording / profiling on (idempotent)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Back to the no-op sink (idempotent); collected events and metrics
    stay until ``reset()``."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Clear the trace buffer and zero every metric."""
    tracer.reset()
    metrics.reset()


def span(name: str, **args: Any):
    """A trace span when enabled, the shared no-op otherwise."""
    if not _enabled:
        return NOOP_SPAN
    return tracer.span(name, **args)


def instant(name: str, **args: Any) -> None:
    """A zero-duration trace mark; no-op when disabled."""
    if _enabled:
        tracer.instant(name, **args)


def dump(out_dir: str = ".", prefix: str = "obs") -> Optional[dict]:
    """Export the Chrome trace + metrics JSONL into ``out_dir``; returns
    the written paths (None when disabled: nothing was collected)."""
    if not _enabled:
        return None
    os.makedirs(out_dir, exist_ok=True)
    return {
        "trace": tracer.export(
            os.path.join(out_dir, f"{prefix}_trace.json")),
        "metrics": metrics.export_jsonl(
            os.path.join(out_dir, f"{prefix}_metrics.jsonl")),
    }


# REPRO_OBS=1 (or any non-empty value except "0") enables at import
if os.environ.get("REPRO_OBS", "0") not in ("", "0"):
    enable()
