"""Device, whole pool step: the FLOPs from shapes (``benchmark/work.py``) of
the windows that carried a session's audio, over the summed ``StreamPool.step``
time of the ticks after the traced stretch times 989 TFLOP/s (bf16: the int8
packs compute in bf16), in percent. Rows stepped on silence to keep the
batch's shape are not useful work and are not counted."""

from benchmark import work


def read(ctx, data, spans, trace):
    ticks = data["ticks"]
    seconds = sum(t.end - t.start for t in ticks)
    rows = sum(t.info[0] for t in ticks)
    if seconds <= 0 or rows == 0:
        return None
    return 100.0 * rows * data["step_flops"] / (seconds * work.BF16_FLOP_PER_S)
