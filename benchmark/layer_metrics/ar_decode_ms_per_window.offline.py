"""Engine inference (``models/ar_model.py``): ms of the program's
``window.decode`` spans (the AR level walk of one window step) per window,
summed inside each clip after the traced stretch
(``benchmark/program_spans.py``). The span times the host: on this
launch-bound path, with the card mostly idle, that is the walk's time."""

from benchmark import program_spans


def read(ctx, data, spans, trace):
    spent, found = 0, False
    for c in data.get("clips") or []:
        got = program_spans.kept("window.decode", c["t0"], c["t1"])
        if got is None:
            return None
        found = found or bool(got)
        spent += sum(sp.duration_ns for sp in got)
    return spent / 1e6 / data["windows"] if found and data.get("windows") else None
