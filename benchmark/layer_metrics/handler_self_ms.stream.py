"""HTTP front (``server.py``, the request threads): the median over the
chunks carried by the ticks after the traced stretch of the program's
``http.chunk`` span less its ``batcher.wait`` child: the server's own work
on a chunk (reading the request, the reply's encoding and its write), the
waits for the interpreter lock included (``benchmark/program_spans.py``)."""

import statistics

from benchmark import program_spans


def read(ctx, data, spans, trace):
    ticks = program_spans.stream_ticks(data)
    queued = program_spans.queue_spans(ticks) if ticks else None
    chunks = program_spans.kept("http.chunk")
    waits = program_spans.kept("batcher.wait")
    if not queued or not chunks or waits is None:
        return None
    carried = {q.attrs.get("request") for q in queued}
    wait_of = program_spans.by_parent(waits)
    own = [program_spans.self_ns(c, wait_of[c.id])
           for c in chunks if c.attrs.get("request") in carried and c.id in wait_of]
    return statistics.median(own) / 1e6 if own else None
