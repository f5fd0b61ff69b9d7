"""GAGAvatar renderer (``models/gagavatar/avatar.py``): ms of the program's
``gaga.avatar`` spans (selecting the avatar and encoding it, which
``render_motion_sequence`` repeats for every clip it is given an avatar id)
per frame, summed inside each clip after the traced stretch
(``benchmark/program_spans.py``)."""

from benchmark import program_spans


def read(ctx, data, spans, trace):
    spent, found = 0, False
    for c in data.get("clips") or []:
        got = program_spans.kept("gaga.avatar", c["t0"], c["t1"])
        if got is None:
            return None
        found = found or bool(got)
        spent += sum(sp.duration_ns for sp in got)
    return spent / 1e6 / data["frames"] if found and data.get("frames") else None
