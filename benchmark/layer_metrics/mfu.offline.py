"""Device, whole clip: the FLOPs of the clips after the traced stretch, from
shapes (``benchmark/work.py``: every window step, the smoothing and, for the
mesh, FLAME and the shading per frame), over their wall time times the
peak the cell names, in percent."""


def read(ctx, data, spans, trace):
    seconds = data["until"] - data["since"]
    return 100.0 * data["flops"] / (seconds * data["peak"]) if seconds > 0 else None
