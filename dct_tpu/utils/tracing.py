"""Profiling / tracing harness (SURVEY.md section 5.1 — absent in the
reference, whose only observability is test printfs).

Wraps jax.profiler for kernel-level traces and provides a tiny named-scope
timing registry for pipeline stages (host wall clock; see
utils/metrics.measure_throughput for the bench-grade variant).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax

_timings: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def named_scope(name: str):
    """jax.named_scope + wall-clock accumulation (host-side)."""
    t0 = time.perf_counter()
    with jax.named_scope(name):
        yield
    _timings[name].append(time.perf_counter() - t0)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timings_summary() -> dict[str, dict[str, float]]:
    out = {}
    for name, ts in _timings.items():
        out[name] = {
            "calls": len(ts),
            "total_s": sum(ts),
            "mean_ms": 1e3 * sum(ts) / len(ts),
        }
    return out


def reset_timings() -> None:
    _timings.clear()
