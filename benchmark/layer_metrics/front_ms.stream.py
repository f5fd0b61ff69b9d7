"""HTTP front (``server.py``): the median over chunks of the client's time
from sending a chunk to having its parsed motion, less the span of that
chunk's ``batcher.submit`` (which waits for the tick that carries it): the
request's transfer, the handler, JSON encoding and the client's decoding."""

import statistics


def read(ctx, data, spans, trace):
    return statistics.median(data["fronts"]) if data["fronts"] else None
