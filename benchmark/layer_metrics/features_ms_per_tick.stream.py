"""Engine inference (``models/wav2vec.py``): the device time of the wav2vec2
conv front in a pool step, the ``device_us`` of the ``wav2vec.frontend``
span (CUDA events around the z-norm, the feature convs, the projection and
the positional conv's residual, read after the pool's download) inside each
``pool.tick``, median over the ticks after the traced stretch, in ms. None
where the program records no such span."""

import statistics

from benchmark import program_spans


def read(ctx, data, spans, trace):
    ticks = program_spans.stream_ticks(data)
    fronts = program_spans.kept("wav2vec.frontend")
    if not ticks or not fronts:
        return None
    out = []
    for t in ticks:
        inside = [s for s in fronts if s.thread == t.thread and t.start_ns <= s.start_ns
                  and s.end_ns <= t.end_ns]
        if inside and all("device_us" in s.attrs for s in inside):
            out.append(sum(s.attrs["device_us"] for s in inside) / 1e3)
    return statistics.median(out) if out else None
