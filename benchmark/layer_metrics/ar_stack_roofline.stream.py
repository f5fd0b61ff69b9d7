"""Kernels (``ops/ar_block_stack.py``, ``csrc/ar_block_stack.cu``): the bound
time of the 12 AdaLN blocks' work over every row the pool gives each level
(the pool steps its whole capacity), from shapes (``benchmark/work.py``:
``ar_level_work`` with the int8 pack's bytes and bf16 caches), over the
device time the profiler gives the kernels named below, in percent. Each
traced tick launches the stack once per level; a trace that holds another
number of launches gives no reading."""

import sys

from benchmark import work

KERNELS = ["ar_kernel"]


def read(ctx, data, spans, trace):
    if trace is None:
        return None
    seconds, launches = trace.kernel_s(KERNELS)
    if not launches or seconds <= 0:
        return None
    m = data["model"]
    ar, pns = m["ar"], m["vae"]["patch_nums"]
    d, depth = ar["embed_dim"], ar["depth"]
    hidden = round(d * ar["mlp_ratio"])
    starts = [sum(pns) * ar["prev_ratio"] + sum(pns[:i]) for i in range(len(pns))]
    ticks = data["traced_ticks"]
    if launches != ticks * len(pns):
        print(f"ar_stack_roofline: {launches} launches in {ticks} traced ticks",
              file=sys.stderr)
        return None
    bound = sum(work.ar_level_work(depth, d, hidden, ar["num_heads"], pn, st, itemsize=1,
                                   int8=True, cache_bytes=2, rows=data["capacity"])
                .bound_s(work.BF16_FLOP_PER_S) for pn, st in zip(pns, starts))
    return 100.0 * ticks * bound / seconds
