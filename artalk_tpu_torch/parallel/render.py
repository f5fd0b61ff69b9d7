"""Render-tier scale-out: frame-parallel mesh rendering over the dp axis
(counterpart of ``artalk_tpu/parallel/render.py``).

Mesh preview frames are independent (no cross-frame carry, unlike the
GAGAvatar chunk scan's forehead EMA), so a clip shards embarrassingly over
the ``dp`` axis of a :func:`artalk_tpu_torch.parallel.mesh.make_mesh` mesh:
each rank renders its contiguous block of frames through the full raster
(the rasterizer kernel on the card) + shade pipeline, and one all-gather over
the dp group gives every rank the whole clip.

Ragged clips are padded to a multiple of the dp size with repeats of the last
frame and trimmed after, so every rank renders a block of one shape.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def render_frames_dp(renderer, verts: torch.Tensor, mesh: DeviceMesh,
                     axis: str = "dp") -> torch.Tensor:
    """(B, V, 3) world verts (the same on every rank) -> (B, H, W, 3) RGB on
    every rank, frames split over ``axis``. Bit-identical to
    ``renderer(verts)`` (same per-frame math, no reduction)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    b = verts.shape[0]
    pad = (-b) % n
    if pad:
        verts = torch.cat([verts, verts[-1:].expand(pad, -1, -1)], dim=0)
    per_rank = verts.shape[0] // n
    rank = mesh.get_local_rank(axis)
    local = renderer(verts[rank * per_rank:(rank + 1) * per_rank]).contiguous()
    frames = local.new_empty((n * per_rank,) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(frames, local, group=mesh.get_group(axis))
    return frames[:b]
