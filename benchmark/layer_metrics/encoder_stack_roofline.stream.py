"""Kernels (``ops/encoder_block_stack.py``, ``csrc/encoder_block_stack.cu``):
the bound time of the 24 wav2vec2 layers' work over every row of each
launch (the pool's whole capacity), from shapes (``benchmark/work.py``:
``encoder_window_work`` with the int8 pack), over the device time the
profiler gives the kernels named below, in percent; one launch a traced
tick."""

import sys

from benchmark import work

KERNELS = ["encoder_kernel"]


def read(ctx, data, spans, trace):
    if trace is None:
        return None
    seconds, launches = trace.kernel_s(KERNELS)
    if not launches or seconds <= 0:
        return None
    w2v = data["model"]["wav2vec"]
    frames = work.conv_frames(data["model"]["window_samples"], w2v["conv_kernel"],
                              w2v["conv_stride"])
    one = work.encoder_window_work(w2v["num_hidden_layers"], w2v["hidden_size"],
                                   w2v["intermediate_size"], frames, itemsize=1, int8=True,
                                   rows=data["capacity"])
    if launches != data["traced_ticks"]:
        print(f"encoder_stack_roofline: {launches} launches in {data['traced_ticks']} traced "
              "ticks", file=sys.stderr)
        return None
    return 100.0 * launches * one.bound_s(work.BF16_FLOP_PER_S) / seconds
