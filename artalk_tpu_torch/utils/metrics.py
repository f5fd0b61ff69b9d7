"""Metrics registry, spans, stage timers and the device trace.

Counterpart of ``artalk_tpu/utils/metrics.py``:

- a process-wide registry (counters, gauges, timing histograms with p50/p95)
  that the engine feeds per window and per stage, under the JAX engine's
  names (``inference.generate``, ``inference.windows``, ``render.rasterize``,
  ...); a timing keeps its count and its last ``TIMINGS_KEPT`` durations;
- spans (``span(name, **attrs)``): intervals of host work recorded where the
  work happens, kept in a bounded in-memory ring (``spans()`` reads it);
- ``stage()``, a span that also feeds the timing histogram of its name;
- ``device_trace(log_dir)``, a ``torch.profiler`` capture of the CPU and,
  where a card exists, the CUDA activity, written as a Chrome trace;
- one-line JSON snapshots for benches and services (counters, gauges and
  stage timings; spans are not in them).

A span records its name, its start and end on ``time.monotonic_ns()``
(CLOCK_MONOTONIC, the clock of ``time.monotonic``), its thread, its own id
and its parent's (the span open on the same thread when it began), a few
integer attributes (a request, session or tick id, rows) and, made with
``cpu_time=True``, the CPU time its thread spent inside it
(``time.thread_time_ns()``). Recording is always on: a span costs two clock
reads and an append to the ring, which takes no lock (a deque's append is
atomic under the GIL); when the ring is full the oldest spans go and
``spans_dropped()`` counts them. The CPU clock is a system call, a point
where the scheduler may run another thread: on an H100's host, reading it in
every span of the GAGAvatar clip (about four reads a frame) cost 8 % of the
frame, so only the spans whose CPU time a reader takes read it. While a profiler records the
thread (``torch.autograd._profiler_enabled()``), a span also opens a
``torch.profiler.record_function`` range of its name, entered right after
its start stamp; a span already open when the profiler started gets its
range when its first child opens (``Span.ranged`` = ``LATE_RANGE``), so a
trace that starts inside a span still names what the thread does after its
child. While ``torch.compiler.is_compiling()`` (``torch.export`` included) a
span records nothing and opens no range.

Spans and stages time the host: CUDA work a span enqueues may finish after
it closes, and the registry adds no synchronisation of its own. A span made
with ``device=`` a CUDA device also records a CUDA event on that device's
current stream at its start and at its end; ``read_device_times()``, called
where the caller has already waited for the device (the stream pool's and
the engine's downloads), gives each such span whose end event the device has
passed the integer attribute ``device_us``: the microseconds between its two
events, the stream's time for the work the span enqueued. It is fed
from the HTTP server's threads too, so the counters, gauges and timings take
a lock.

The spans of the package, by module (``engine.py``, ``server.py``,
``serving.py`` and the models list theirs): ``http.*`` and ``batcher.*``
(the HTTP front), ``pool.*`` (the stream pool), ``window.*`` (the window
step), ``mimi.*`` (the Mimi encoder's stages inside ``window.encode``:
``mimi.resample``, ``mimi.seanet``, ``mimi.transformer`` and ``mimi.rvq``,
each with ``rows`` and ``frames`` and, on a card, ``device_us``),
``whisper.*`` (the Whisper encoder's stages inside ``window.encode``:
``whisper.logmel``, ``whisper.stem`` and ``whisper.layers``, each with
``rows`` and ``frames`` and, on a card, ``device_us``),
``wav2vec.frontend`` (the wav2vec2 conv front; ``device_us`` on a card),
``inference.download``, ``mesh.*`` and ``gaga.*`` (the renderers), and the
engine's stages.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Collection, Deque, Dict, Iterator, List, Optional, Union

import torch

SPAN_RING = 65536      # spans kept; a 50-s stream run of 140 sessions makes about 12,000
DEVICE_PENDING = 4096  # device-timed spans awaiting ``read_device_times``; older ones go
TIMINGS_KEPT = 10000   # durations kept per stage for its p50 / p95

NO_RANGE, RANGE, LATE_RANGE = 0, 1, 2

# bound once: a span's cost is a few attribute lookups more or less
monotonic_ns, thread_time_ns = time.monotonic_ns, time.thread_time_ns
get_ident = threading.get_ident
_profiler_enabled, _is_compiling = torch.autograd._profiler_enabled, torch.compiler.is_compiling


class Span:
    """One interval of host work on one thread; a context manager made by
    ``Metrics.span``. ``start_ns`` / ``end_ns`` are ``time.monotonic_ns()``,
    ``cpu_ns`` the thread's CPU time inside it (None unless made with
    ``cpu_time=True``), ``parent`` the id of the span open on the thread
    when it began (0: none), ``attrs`` its integer attributes."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "cpu_ns", "thread", "id", "parent",
                 "seq", "ranged", "_metrics", "_stack", "_cpu", "_cpu0", "_range", "_device",
                 "_event0")

    def __init__(self, metrics: "Metrics", name: str, attrs: Dict[str, int],
                 cpu_time: bool = False, device: Optional[torch.device] = None):
        self.name, self.attrs, self._metrics = name, attrs, metrics
        self.cpu_ns, self._cpu = None, cpu_time
        self._device = device if device is not None and device.type == "cuda" else None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        m = self._metrics
        try:
            stack = m._local.stack
        except AttributeError:
            stack = m._local.stack = []
        self.parent = stack[-1].id if stack else 0
        self.id = next(m._ids)
        self.thread = get_ident()
        self._stack = stack
        self._range = None
        self.ranged = NO_RANGE
        stack.append(self)
        rf = None
        if _profiler_enabled():
            for sp in stack[:-1]:          # opened before the profiler started
                if sp._range is None:
                    sp._range = torch.profiler.record_function(sp.name)
                    sp._range.__enter__()
                    sp.ranged = LATE_RANGE
            rf = torch.profiler.record_function(self.name)
        self.start_ns = monotonic_ns()
        if rf is not None:
            # entered right after the stamp: entering releases the
            # interpreter lock after the range's own stamp, so a wait for
            # the lock falls after both
            rf.__enter__()
            self._range, self.ranged = rf, RANGE
        if self._cpu:
            self._cpu0 = thread_time_ns()
        if self._device is not None:
            self._event0 = _recorded_event(self._device)
        return self

    def __exit__(self, *exc) -> bool:
        if self._device is not None:
            end = _recorded_event(self._device)
            with self._metrics._lock:
                self._metrics._device_pending.append((self, self._event0, end))
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._cpu:
            self.cpu_ns = thread_time_ns() - self._cpu0
        self.end_ns = monotonic_ns()
        self._stack.pop()
        m = self._metrics
        self.seq = next(m._seq)
        m._ring.append(self)
        return False


def _recorded_event(device: torch.device) -> "torch.cuda.Event":
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


class Metrics:
    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.timings: Dict[str, Deque[float]] = defaultdict(lambda: deque(maxlen=TIMINGS_KEPT))
        self.timing_counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ring: Deque[Span] = deque(maxlen=SPAN_RING)
        self._device_pending: Deque[tuple] = deque(maxlen=DEVICE_PENDING)
        self._ids = itertools.count(1)
        self._seq = itertools.count()

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def record_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self.timings[name].append(seconds)
            self.timing_counts[name] += 1

    # ------------------------------------------------------------------ spans

    def span(self, name: str, cpu_time: bool = False, device: Optional[torch.device] = None,
             **attrs: int):
        """A span ``name`` around a ``with`` block (with the thread's CPU time
        where ``cpu_time``, and CUDA events around it where ``device`` is a
        CUDA device: see ``read_device_times``); ``as`` gives the Span, whose
        ``attrs`` the block may still fill. Inside a compiled or exported
        region, a context that records nothing (``as`` gives None)."""
        if _is_compiling():
            return contextlib.nullcontext()
        return Span(self, name, attrs, cpu_time, device)

    def read_device_times(self) -> None:
        """Give each span recorded with a CUDA ``device`` whose end event the
        device has passed its ``device_us`` attribute; the others wait for a
        later call. Adds no synchronisation: call it where the device has
        been waited for."""
        with self._lock:
            pending = list(self._device_pending)
            self._device_pending.clear()
            for sp, start, end in pending:
                if end.query():
                    sp.attrs["device_us"] = int(round(start.elapsed_time(end) * 1e3))
                else:
                    self._device_pending.append((sp, start, end))

    def record_span(self, name: str, start_ns: int, end_ns: int, **attrs: int) -> Span:
        """Keep a span whose interval was stamped elsewhere, for instance its
        start on another thread; it is given to this thread and has no
        parent, no CPU time and no range."""
        sp = Span(self, name, attrs)
        sp.start_ns, sp.end_ns, sp.parent = int(start_ns), int(end_ns), 0
        sp.ranged = NO_RANGE
        sp.id, sp.thread, sp.seq = next(self._ids), get_ident(), next(self._seq)
        self._ring.append(sp)
        return sp

    def spans(self, name: Union[str, Collection[str], None] = None,
              since_ns: Optional[int] = None, until_ns: Optional[int] = None) -> List[Span]:
        """The kept spans (of ``name``, one name or a collection of them)
        that lie inside [since_ns, until_ns], in order of their start."""
        names = {name} if isinstance(name, str) else name
        out = [sp for sp in list(self._ring)
               if (names is None or sp.name in names)
               and (since_ns is None or sp.start_ns >= since_ns)
               and (until_ns is None or sp.end_ns <= until_ns)]
        out.sort(key=lambda sp: sp.start_ns)
        return out

    def spans_dropped(self) -> int:
        """Spans recorded since the last ``reset`` that the ring no longer
        holds (the oldest go first)."""
        kept = list(self._ring)
        return max(sp.seq for sp in kept) + 1 - len(kept) if kept else 0

    # ----------------------------------------------------------------- stages

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Time a stage: a span of the name, whose duration feeds the timing
        histogram (and, under a profiler, its range marks the trace)."""
        with self.span(name) as sp:
            yield
        if sp is not None:
            self.record_time(name, sp.duration_ns / 1e9)

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
            counts = dict(self.timing_counts)
        for name, values in timings.items():
            out[f"{name}_p50_ms"] = round(self._pct(values, 0.50) * 1000, 2)
            out[f"{name}_p95_ms"] = round(self._pct(values, 0.95) * 1000, 2)
            out[f"{name}_count"] = counts[name]
        return out

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def reset(self) -> None:
        """Clear the counters, gauges, timings and the span ring."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.timings.clear()
            self.timing_counts.clear()
            self._ring.clear()
            self._device_pending.clear()
            self._seq = itertools.count()


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
