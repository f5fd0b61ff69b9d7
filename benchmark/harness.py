"""What every run shares: the manifest and the cell and configuration files,
the device checks, spans, the traced stretch and its reduction, and the
result line.

Spans are the benchmark's own: ``Spans.wrap`` replaces a bound method on one
instance of the program by a wrapper that keeps one record of each call (its
name, start and end on ``clock``, and what a hook reads from the call) and,
in a traced run, opens a ``torch.profiler.record_function`` range of the
same name. The method itself is not changed.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "artalk_tpu")


class BenchmarkError(RuntimeError):
    """A run that cannot give a result: it exits non-zero and prints none."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(workload: str) -> tuple:
    """(manifest entry, cell file, configuration file) of a workload."""
    man = manifest()
    entry = next((w for w in man["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise BenchmarkError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in man["configs"] if c["name"] == entry["config"])
    cell = load_json(BENCH / "cells" / f"{entry['traffic']}.json")
    return entry, cell, load_json(ROOT / config["file"])


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_devices(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise BenchmarkError("CUDA is not available")
    if torch.cuda.device_count() < chips:
        raise BenchmarkError(f"the cell needs {chips} GPUs, {torch.cuda.device_count()} found")


def device_info(device, count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics; +inf values (missed requests) sort last."""
    v = sorted(values)
    if not v:
        return float("inf")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    if v[hi] == float("inf"):
        return float("inf") if pos > lo or v[lo] == float("inf") else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Span:
    """One call into the program: its name, start and end on ``clock``, the
    thread, and what the wrapper's ``after`` hook read from the call."""

    __slots__ = ("name", "start", "end", "thread", "info")

    def __init__(self, name: str, start: float, thread: int):
        self.name, self.start, self.end, self.thread, self.info = name, start, start, thread, None


def clock() -> float:
    """The clock of every span and window time: ``time.monotonic``, which
    the client processes read too."""
    return time.monotonic()


class Spans:
    """Spans around calls into the program, one record per call."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.records: List[Span] = []

    def wrap(self, obj, method: str, name: str, before: Optional[Callable] = None,
             after: Optional[Callable] = None) -> None:
        """Record a span ``name`` around every call of ``obj.method``.
        ``before(*args, **kwargs)`` runs ahead of the span;
        ``after(result, *args, **kwargs)`` runs once it has ended, and what
        it returns is kept as the span's ``info``."""
        import torch

        orig = getattr(obj, method)

        def wrapper(*args, **kwargs):
            if before is not None:
                before(*args, **kwargs)
            rec = Span(name, clock(), threading.get_ident())
            ctx = torch.profiler.record_function(name) if self.traced else contextlib.nullcontext()
            try:
                with ctx:
                    out = orig(*args, **kwargs)
            finally:
                rec.end = clock()
                self.records.append(rec)
            if after is not None:
                rec.info = after(out, *args, **kwargs)
            return out

        setattr(obj, method, wrapper)

    def of(self, name: str, since: float = float("-inf"), until: float = float("inf")) -> List[Span]:
        """The spans ``name`` that lie inside [since, until]."""
        return [r for r in self.records if r.name == name and r.start >= since and r.end <= until]

    def durations(self, name: str, since: float = float("-inf"),
                  until: float = float("inf")) -> List[float]:
        return [r.end - r.start for r in self.of(name, since, until)]


class Trace:
    """The device trace of the traced stretch, reduced to what the per-layer
    readers take: kernels and copies on the device, the host's ranges."""

    def __init__(self, events: List[dict], t_host0: float, t_host1: float):
        self.window_s = t_host1 - t_host0
        self.ops: List[tuple] = []            # (name, start ns, end ns) on the device
        self.ranges: List[tuple] = []         # (name, start ns, end ns) on the host
        for ev in events:
            if ev.get("ph") != "X":
                continue
            start = int(float(ev["ts"]) * 1000)
            span = (ev.get("name", ""), start, start + int(float(ev.get("dur", 0)) * 1000))
            if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                self.ops.append(span)
            elif ev.get("cat") == "user_annotation":
                self.ranges.append(span)
        self.ops.sort(key=lambda o: o[1])
        self.busy = self._union([(s, e) for _, s, e in self.ops])

    @staticmethod
    def _union(intervals):
        out = []
        for s, e in sorted(intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        """Seconds in which a kernel, copy or memset ran on the card."""
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_s(self, names: List[str]) -> tuple:
        """(seconds, launches) of device kernels whose name holds one of
        ``names`` as a whole identifier."""
        hits = [(e - s) for n, s, e in self.ops
                if any(re.search(rf"(?<![A-Za-z0-9_]){k}(?![A-Za-z0-9_])", n) for k in names)]
        return sum(hits) / 1e9, len(hits)

    def breakdown(self) -> dict:
        """The ten device operations with the most time, and the ten longest
        idle gaps named by the innermost host range open at their start."""
        by_op: Dict[str, float] = {}
        for n, s, e in self.ops:
            by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e9
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = [(self.busy[i][1], self.busy[i + 1][0]) for i in range(len(self.busy) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        for s, e in gaps:
            inside = [(re - rs, n) for n, rs, re in self.ranges if rs <= s <= re]
            named.append([min(inside)[1] if inside else "(no range)", (e - s) / 1e9])
        return {"device_ops": [[n, v] for n, v in top], "idle_gaps": named}


class Tracer:
    """torch.profiler over a stretch of a traced run's window, started and
    stopped by the driver at boundaries of its work: one clip, or the ticks
    of about ``seconds``."""

    def __init__(self, traced: bool, seconds: float):
        self.traced = traced
        self.seconds = seconds
        self.prof = None
        self.trace: Optional[Trace] = None
        self.t0 = 0.0

    def start(self) -> None:
        if not self.traced:
            return
        import torch
        from torch.profiler import ProfilerActivity

        self.prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = clock()

    def prime(self) -> None:
        """Initialise the profiler on this thread (the main one), so that a
        driver may start its stretch on another thread."""
        if not self.traced:
            return
        import torch
        from torch.profiler import ProfilerActivity

        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)

    def due(self) -> bool:
        return self.prof is not None and clock() - self.t0 >= self.seconds

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        torch.cuda.synchronize()
        t1 = clock()
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        # the chrome trace is the profiler's stable export across versions;
        # it is read back and deleted at once
        path = BENCH / "_cache" / "trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        try:
            events = load_json(path).get("traceEvents", [])
        finally:
            path.unlink(missing_ok=True)
        self.trace = Trace(events, self.t0, t1)


def emit(result: dict, numbers: List[tuple]) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output with
    the same numbers under ``checks``, last."""
    for name, value, limit in numbers:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in numbers}
    print(json.dumps(result), flush=True)


HOST_THREADS = 4   # of the machine's 8 cores: the rest serve the clients and the driver


def set_environment() -> None:
    """Build and kernel caches of the program inside the checkout, at fixed
    paths (the port builds its CUDA libraries into ``artalk_tpu_torch/_build``
    beside its sources already), and a fixed number of host threads."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    cache = BENCH / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
