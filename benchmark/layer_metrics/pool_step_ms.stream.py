"""Pool (``serving.py``): the median span of ``StreamPool.step`` over the
ticks after the traced stretch; a step ends with the motion's copy to the
host, so the span holds its device work."""

import statistics


def read(ctx, data, spans, trace):
    ticks = data["ticks"]
    return statistics.median((t.end - t.start) * 1e3 for t in ticks) if ticks else None
