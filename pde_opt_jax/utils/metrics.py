"""Lightweight metrics / observability.

The reference's only observability is optimizer ``verbose`` frozensets and
notebook prints (SURVEY.md §5).  Here: a host-side metric logger fed from
device code via tiny scalar fetches (or ``jax.debug.callback`` inside jit),
throughput counters for env fleets, and profiler trace scopes.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, Optional

import jax

__all__ = ["MetricLogger", "Throughput", "trace_scope", "named_scope"]

named_scope = jax.named_scope  # re-export: annotate rhs/FFT/collective regions


class MetricLogger:
    """Append-only scalar metric stream with periodic flush to JSONL."""

    def __init__(self, path: Optional[str] = None, flush_every: int = 100):
        self.path = path
        self.flush_every = flush_every
        self._buffer = []
        self._history = defaultdict(list)

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": int(step), "time": time.time()}
        # Pull any device arrays across in ONE transfer — per-value float()
        # costs one device->host round-trip each.
        if any(hasattr(v, "device") or hasattr(v, "devices")
               for v in metrics.values()):
            metrics = jax.device_get(metrics)
        for k, v in metrics.items():
            v = float(v)
            rec[k] = v
            self._history[k].append((int(step), v))
        self._buffer.append(rec)
        if self.path and len(self._buffer) >= self.flush_every:
            self.flush()

    def history(self, key: str):
        return list(self._history[key])

    def flush(self) -> None:
        if self.path and self._buffer:
            with open(self.path, "a") as f:
                for rec in self._buffer:
                    f.write(json.dumps(rec) + "\n")
            self._buffer.clear()


class Throughput:
    """Env-steps/s counter (the BASELINE headline metric)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def update(self, env_steps: int):
        self._steps += env_steps

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0


@contextmanager
def trace_scope(logdir: str):
    """Capture a ``jax.profiler`` trace for everything inside the scope."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
