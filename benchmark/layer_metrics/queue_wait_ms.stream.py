"""HTTP front (``server.py``, ``_TickBatcher``): the median of the program's
``batcher.queue`` spans over the chunks carried by the ticks after the
traced stretch: a chunk's wait from its enqueue to the moment the tick
that carries it hands its batch to ``StreamPool.step``
(``benchmark/program_spans.py``)."""

import statistics

from benchmark import program_spans


def read(ctx, data, spans, trace):
    ticks = program_spans.stream_ticks(data)
    queued = program_spans.queue_spans(ticks) if ticks else None
    if not queued:
        return None
    return statistics.median(q.duration_ns for q in queued) / 1e6
