"""Metrics registry, stage timers and the device trace.

Counterpart of ``artalk_tpu/utils/metrics.py``:

- a process-wide registry (counters, gauges, timing histograms with p50/p95)
  that the engine feeds per window and per stage, under the JAX engine's
  names (``inference.generate``, ``inference.windows``, ``render.rasterize``,
  ...);
- ``stage()``, which times a host stage and opens a
  ``torch.profiler.record_function`` range of the same name, so a profiler
  trace lines up with the host stages;
- ``device_trace(log_dir)``, a ``torch.profiler`` capture of the CPU and,
  where a card exists, the CUDA activity, written as a Chrome trace;
- one-line JSON snapshots for benches and services.

A stage times the host: CUDA work it enqueues may finish after it closes, as
the JAX stages time an asynchronous dispatch. The registry adds no
synchronisation of its own. It is fed from the HTTP server's threads too, so
its updates take a lock.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch


class Metrics:
    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.timings: Dict[str, List[float]] = defaultdict(list)
        self._lock = threading.Lock()

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def record_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self.timings[name].append(seconds)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Time a stage and mark the profiler trace with the same name."""
        start = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.record_time(name, time.perf_counter() - start)

    @staticmethod
    def _pct(values: List[float], q: float) -> float:
        if not values:
            return 0.0
        s = sorted(values)
        idx = min(int(q * len(s)), len(s) - 1)
        return s[idx]

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = {"counters": dict(self.counters), "gauges": dict(self.gauges)}
            timings = {name: list(values) for name, values in self.timings.items()}
        for name, values in timings.items():
            out[f"{name}_p50_ms"] = round(self._pct(values, 0.50) * 1000, 2)
            out[f"{name}_p95_ms"] = round(self._pct(values, 0.95) * 1000, 2)
            out[f"{name}_count"] = len(values)
        return out

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.timings.clear()


GLOBAL_METRICS = Metrics()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where a card exists) and write the
    trace to ``<log_dir>/trace.json`` (chrome://tracing, Perfetto). Yields the
    profiler, whose ``key_averages()`` sums the events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
