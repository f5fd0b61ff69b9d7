"""Mimi encoder (``models/mimi.py``): the device time of its four stages in
a pool step, the summed ``device_us`` of the tick's ``mimi.resample``,
``mimi.seanet``, ``mimi.transformer`` and ``mimi.rvq`` spans (CUDA events at
the stage boundaries, read after the pool's download), median over the ticks
after the traced stretch, in ms."""

import statistics


def read(ctx, data, spans, trace):
    ms = data.get("mimi_ms")
    return statistics.median(ms) if ms else None
