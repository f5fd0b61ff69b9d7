"""Kernels (``ops/attention.py``, ``csrc/flash_attention.cu``): the bound
time of the Whisper layers' attention over every row the pool steps (its
whole capacity), from shapes (``benchmark/work_whisper.flash_work``: per
head 2 Lq Lk hd for Q K^T and twice 2 Lq Lk hd for the bf16 P V, at 989
TFLOP/s, against q, k, v and the output at 3.35 TB/s), over the device time
the profiler gives the kernels named below, in percent. Each traced tick
launches the kernel once per encoder layer; a trace that holds another
number of launches gives no reading."""

import sys

from benchmark import work, work_whisper

KERNELS = ["flash_kernel", "flash_split_kernel"]


def read(ctx, data, spans, trace):
    if trace is None or "whisper" not in data.get("model", {}):
        return None
    seconds, launches = trace.kernel_s(KERNELS)
    if not launches or seconds <= 0:
        return None
    w = data["model"]["whisper"]
    ticks = data["traced_ticks"]
    if launches != ticks * w["encoder_layers"]:
        print(f"flash_roofline: {launches} launches in {ticks} traced ticks", file=sys.stderr)
        return None
    bound = work_whisper.flash_work(w, data["capacity"]).bound_s(work.BF16_FLOP_PER_S)
    return 100.0 * launches * bound / seconds
