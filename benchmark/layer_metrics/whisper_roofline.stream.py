"""Whisper encoder (``models/whisper.py``): the bound time of its window
over every row the pool steps (its whole capacity), from shapes
(``benchmark/work_whisper.py``: the larger of the FLOPs at 989 TFLOP/s bf16
and the bytes at 3.35 TB/s; the stem and layers compute in bfloat16), over
the median device time of its stages in a tick
(``whisper_ms_per_tick.stream``), in percent."""

import statistics

from benchmark import work, work_whisper


def read(ctx, data, spans, trace):
    ms = data.get("whisper_ms")
    if not ms:
        return None
    bound = work_whisper.whisper_window_work(data["model"]["whisper"], rows=data["capacity"])
    return 100.0 * bound.bound_s(work.BF16_FLOP_PER_S) / (statistics.median(ms) / 1e3)
