"""Pool (``serving.py``) and its tick thread (``server.py``): the median
over the ticks after the traced stretch of the tick thread's wall time less
its CPU time inside the tick's ``batcher.tick`` span, less the same inside
its ``pool.download`` (where the thread waits for the card) and less the
cell's ``tick_ms`` (the aggregation sleep): the time the tick thread was
held off the CPU by the interpreter lock, a lock or the scheduler
(``benchmark/program_spans.py``)."""

import statistics

from benchmark import program_spans


def read(ctx, data, spans, trace):
    ticks = program_spans.stream_ticks(data)
    outer = program_spans.kept("batcher.tick")
    downloads = program_spans.kept("pool.download")
    if not ticks or not outer or downloads is None:
        return None
    outer = {t.id: t for t in outer}
    down = program_spans.by_parent(downloads)
    tick_ns = float(ctx.cell["tick_ms"]) * 1e6
    off = []
    for t in ticks:
        b, d = outer.get(t.parent), down.get(t.id, [])
        if b is None or b.cpu_ns is None or any(x.cpu_ns is None for x in d):
            continue
        waited = sum(x.duration_ns - x.cpu_ns for x in d)
        off.append(b.duration_ns - b.cpu_ns - waited - tick_ns)
    return statistics.median(off) / 1e6 if off else None
