"""HTTP front (``server.py``, the request threads) against the device: the
share of the card's idle time over the traced stretch during which at
least one request thread was inside ``http.encode`` (a reply's ``tolist``,
``json.dumps`` and ``encode``, which hold the interpreter lock). The
profiler records only the tick thread, so the request threads' spans are
placed on the trace's clock by ``program_spans.trace_offset``."""

from benchmark import program_spans


def read(ctx, data, spans, trace):
    found = program_spans.trace_offset(ctx.tracer, trace)
    encodes = program_spans.kept("http.encode")
    if found is None or encodes is None:
        return None
    idle = program_spans.idle_intervals(ctx.tracer, trace, found["offset_ns"])
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    off = found["offset_ns"]
    busy = program_spans.union((sp.start_ns + off, sp.end_ns + off) for sp in encodes)
    return sum(program_spans.overlap_ns(busy, s, e) for s, e in idle) / total
