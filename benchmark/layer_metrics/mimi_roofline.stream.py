"""Mimi encoder (``models/mimi.py``): the bound time of its window over
every row the pool steps (its whole capacity), from shapes
(``benchmark/work_mimi.py``: the larger of the FLOPs at 67 TFLOP/s fp32 and
the bytes at 3.35 TB/s; the encoder runs in float32 with TF32 off), over the
median device time of its stages in a tick (``mimi_ms_per_tick.stream``), in
percent."""

import statistics

from benchmark import work, work_mimi


def read(ctx, data, spans, trace):
    ms = data.get("mimi_ms")
    if not ms:
        return None
    m = data["model"]
    bound = work_mimi.mimi_window_work(m["mimi"], m["window_samples"],
                                       rows=data["capacity"]).bound_s(work.FP32_FLOP_PER_S)
    return 100.0 * bound / (statistics.median(ms) / 1e3)
