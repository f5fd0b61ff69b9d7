"""Whisper encoder (``models/whisper.py``): the device time of its three
stages in a pool step, the summed ``device_us`` of the tick's
``whisper.logmel``, ``whisper.stem`` and ``whisper.layers`` spans (CUDA
events at the stage boundaries, read after the pool's download), median over
the ticks after the traced stretch, in ms. None where the program records
no such spans."""

import statistics


def read(ctx, data, spans, trace):
    ms = data.get("whisper_ms")
    return statistics.median(ms) if ms else None
