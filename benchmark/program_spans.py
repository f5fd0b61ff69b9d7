"""The program's own spans (``artalk_tpu_torch/utils/metrics.py``): read from
its registry's ring, their self time, and their place on the device trace.

The program stamps its spans on ``time.monotonic_ns``, the clock of
``harness.clock`` and of the client processes, so its spans compare with the
harness's spans and the clients' times directly. The device trace runs on
another clock. ``trace_offset`` finds the offset from the first to the
second: the median, over the spans whose profiler range opened with them
inside the traced stretch, of their range's start less their own start,
each span paired with the range of its name in the same order. With it any
kept span, of any thread, lies on the trace's timeline: the handler threads'
spans too, whose ranges the profiler does not record.

Every reader here returns None where the program records no spans (its
registry has no ``spans``), where it kept none of the asked names, or where
its ring dropped any span.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

RANGE = 1   # ``Span.ranged`` of a span whose range opened with it


def ns(seconds: float) -> int:
    """Seconds of ``harness.clock`` as the program's nanoseconds."""
    return int(round(seconds * 1e9))


def registry():
    """The program's metrics registry where it records spans, else None."""
    try:
        from artalk_tpu_torch.utils.metrics import GLOBAL_METRICS
    except ImportError:
        return None
    if not (hasattr(GLOBAL_METRICS, "spans") and hasattr(GLOBAL_METRICS, "spans_dropped")):
        return None
    return GLOBAL_METRICS


def kept(names=None, since_s: Optional[float] = None,
         until_s: Optional[float] = None) -> Optional[list]:
    """The program's spans of ``names`` (a name, a collection of names or
    None for all) inside [since_s, until_s] of ``harness.clock``, in order of
    their start; None without a registry of spans or when its ring dropped
    any."""
    reg = registry()
    if reg is None or reg.spans_dropped():
        return None
    return reg.spans(names, None if since_s is None else ns(since_s),
                     None if until_s is None else ns(until_s))


def by_parent(spans: Iterable) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for sp in spans:
        out.setdefault(sp.parent, []).append(sp)
    return out


def union(intervals: Iterable) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_ns(intervals: List[list], start: int, end: int) -> int:
    """Nanoseconds of [start, end] that a union of intervals covers."""
    return sum(max(0, min(e, end) - max(s, start)) for s, e in intervals)


def self_ns(span, children: Iterable) -> int:
    """A span's duration less the part of it its children cover."""
    return span.duration_ns - overlap_ns(union((c.start_ns, c.end_ns) for c in children),
                                         span.start_ns, span.end_ns)


def window_ns(tracer, trace) -> tuple:
    """The traced stretch on the program's clock: from the profiler's start
    to the synchronise that ends it."""
    return ns(tracer.t0), ns(tracer.t0 + trace.window_s)


def trace_offset(tracer, trace) -> Optional[dict]:
    """The offset (ns) that takes the program's clock to the trace's, its
    spread (largest less smallest pair, ns) and the number of pairs: the
    spans whose range opened with them, begun and ended inside the traced
    stretch, each paired with its name's range of the same order; names
    whose spans and ranges differ in number are left out."""
    if trace is None:
        return None
    since, until = window_ns(tracer, trace)
    spans = kept(None)
    if not spans:
        return None
    mine: Dict[str, list] = {}
    for sp in spans:
        if getattr(sp, "ranged", 0) == RANGE and since <= sp.start_ns and sp.end_ns <= until:
            mine.setdefault(sp.name, []).append(sp.start_ns)
    theirs: Dict[str, list] = {}
    for name, start, _ in trace.ranges:
        if name in mine:
            theirs.setdefault(name, []).append(start)
    diffs = []
    for name, starts in mine.items():
        ranges = sorted(theirs.get(name, []))
        if len(ranges) == len(starts):
            diffs += [r - s for r, s in zip(ranges, starts)]
    if not diffs:
        return None
    return {"offset_ns": statistics.median(diffs), "spread_ns": max(diffs) - min(diffs),
            "pairs": len(diffs)}


def idle_intervals(tracer, trace, offset_ns: float) -> List[list]:
    """The card's idle intervals over the traced stretch, on the trace's
    clock."""
    since, until = (t + offset_ns for t in window_ns(tracer, trace))
    out, at = [], since
    for s, e in trace.busy:
        if s > at:
            out.append([at, min(s, until)])
        at = max(at, e)
        if at >= until:
            break
    if at < until:
        out.append([at, until])
    return [iv for iv in out if iv[1] > iv[0]]


# ---------------------------------------------------------------- the stream


def stream_ticks(data: dict) -> Optional[list]:
    """The program's ``pool.tick`` spans inside the harness's ``pool.step``
    spans of ``data["ticks"]`` (the ticks after the traced stretch), in
    order; None where there are none."""
    ticks = data.get("ticks") or []
    if not ticks:
        return None
    spans = kept("pool.tick", ticks[0].start, ticks[-1].end)
    if not spans:
        return None
    bounds = [(ns(t.start), ns(t.end)) for t in ticks]
    out = [sp for sp in spans if any(a <= sp.start_ns and sp.end_ns <= b for a, b in bounds)]
    return out or None


def tick_ids(ticks: list) -> list:
    """Each ``pool.tick``'s tick id, from the ``batcher.tick`` that holds it
    (None where none does)."""
    outer = {sp.id: sp.attrs.get("tick") for sp in kept("batcher.tick") or []}
    return [outer.get(t.parent) for t in ticks]


def queue_spans(ticks: list) -> Optional[list]:
    """The ``batcher.queue`` spans of the chunks those ticks carried."""
    ids = set(tick_ids(ticks)) - {None}
    spans = kept("batcher.queue")
    if spans is None or not ids:
        return None
    return [q for q in spans if q.attrs.get("tick") in ids] or None
