"""Device: 1 minus the union of kernel, copy and memset intervals on the
card over the traced stretch of whole clips (``torch.profiler``)."""


def read(ctx, data, spans, trace):
    if trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    return 1.0 - trace.busy_s() / trace.window_s
