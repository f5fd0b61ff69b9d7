"""GAGAvatar (``models/gagavatar/``): ms of
``render_motion_sequence(..., colorspace="yuv420")`` (which ends with the
frames on the host) per frame, over the clips after the traced stretch."""


def read(ctx, data, spans, trace):
    spent = sum(spans.durations("gagavatar.render_motion_sequence", data["since"],
                                data["until"]))
    return spent * 1e3 / data["frames"] if spent and data["frames"] else None
