"""Mesh renderer (``models/flame.py``, ``models/renderer.py``): ms of
``flame.motion_to_verts`` and ``mesh_renderer.render_frames`` (which ends
with the yuv420 frames on the host) per frame, over the clips after the
traced stretch."""


def read(ctx, data, spans, trace):
    spent = sum(sum(spans.durations(n, data["since"], data["until"]))
                for n in ("flame.motion_to_verts", "mesh_renderer.render_frames"))
    return spent * 1e3 / data["frames"] if spent and data["frames"] else None
