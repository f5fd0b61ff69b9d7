"""HTTP front (``server.py``, the tick thread): the median over consecutive
ticks after the traced stretch of the time from one ``pool.tick``'s end to
the next one's start, less the time the tick thread spent in
``batcher.idle`` (no chunk pending) between them: the host work and waits
that hold the next tick back (``benchmark/program_spans.py``)."""

import statistics

from benchmark import program_spans


def read(ctx, data, spans, trace):
    ticks = program_spans.stream_ticks(data)
    idle = program_spans.kept("batcher.idle")
    if not ticks or idle is None:
        return None
    idle = program_spans.union((s.start_ns, s.end_ns) for s in idle)
    ids = program_spans.tick_ids(ticks)
    gaps = [b.start_ns - a.end_ns - program_spans.overlap_ns(idle, a.end_ns, b.start_ns)
            for a, b, ia, ib in zip(ticks, ticks[1:], ids, ids[1:])
            if ia is not None and ib == ia + 1]
    return statistics.median(gaps) / 1e6 if gaps else None
