"""Scenes for the rasterizer's culling tests (CPU and card): the synthetic
FLAME head at 512x512 and an adversarial scene. Imports neither jax nor
artalk_tpu, so tests/test_torch_cuda.py can use it on a machine without them.

The adversarial scene (128 x 256, five kinds of faces, a huge far face in
every chunk so that every chunk's vertex box spans the image and only the
per-face cull decides):
  - needles: a 1e-4 to 1e-2 px edge across a pixel-centre row (or column)
    just before a tile edge, the apex up to 40 px away; the constant term of
    the short edge's plane loses its digits to cancellation, so the rounded
    planes cover centres pixels beyond the vertices, past the tile edge. Only
    needles that do so (checked by evaluating their planes) are kept;
  - slivers at the 1e-12 area cut: right triangles a few float32 ulps wide at
    pixel centres, some just below the cut (degenerate) and some above;
  - small triangles with vertices exactly on tile edges and corners;
  - faces behind the camera: a vertex with z < 0 thousands of pixels away,
    as a perspective divide throws it;
  - small random triangles at random depths.
"""

from __future__ import annotations

import numpy as np
import torch

from artalk_tpu_torch.models.flame import FlameModel
from artalk_tpu_torch.models.renderer import MeshRenderer
from artalk_tpu_torch.ops import rasterizer as tr
from artalk_tpu_torch.utils.assets import synthetic_flame

ADV_H, ADV_W = 128, 256


def flame_head(size: int = 512):
    """(verts (5023, 3) float32 screen, faces (F, 3) int64, size, size): the
    synthetic head (the asset chip_smoke.py synthesizes without a real FLAME)
    at a seeded pose, as its phase 3 poses it; made in memory, so that no
    test writes the asset file."""
    flame_data = synthetic_flame()
    flame = FlameModel(flame_data)
    renderer = MeshRenderer(size, flame_data["faces"], template_verts=flame_data["v_template"],
                            device="cpu")
    motion = (np.random.default_rng(7).standard_normal((1, 106)) * 0.5).astype(np.float32)
    motion[:, 100:] *= 0.2
    with torch.no_grad():
        verts = flame.motion_to_verts(torch.zeros(1, 300), torch.from_numpy(motion))
        return (renderer.camera_transform(verts[0]).contiguous(), renderer.faces.long(),
                size, size)


def _spills(v: np.ndarray, axis: int, edge: float, sign: int, coord: float) -> bool:
    """Do the rounded planes of triangle ``v`` cover a centre of the row (or
    column) ``coord`` beyond ``edge`` on the side ``sign``?"""
    a0, a1, _ = (t[0] for t in tr.face_planes(torch.from_numpy(v), torch.tensor([[0, 1, 2]])))
    n = ADV_W if axis == 0 else ADV_H
    s = torch.arange(n, dtype=torch.float32) + 0.5
    c = torch.full_like(s, coord)
    px, py = (s, c) if axis == 0 else (c, s)
    w0 = px * a0[0] + py * a0[1] + a0[2]
    w1 = px * a1[0] + py * a1[1] + a1[2]
    beyond = (s - edge) * sign > 0
    return bool(((w0 >= 0) & (w1 >= 0) & (w0 + w1 <= 1) & beyond).any())


def _needles(rng, count: int, axis: int) -> list:
    tile = (tr.TILE_W, tr.TILE_H)[axis]
    n, m = (ADV_W, ADV_H) if axis == 0 else (ADV_H, ADV_W)
    out = []
    while len(out) < count:
        coord = float(rng.integers(1, m - 1)) + 0.5        # a pixel-centre row (column)
        sign = 1 if rng.integers(2) else -1                 # the side it spills to
        edge = float(tile * rng.integers(1, n // tile))
        tip = edge - sign * float(rng.uniform(0.05, 0.45))
        eps = float(10 ** rng.uniform(-4, -2))
        length = float(rng.uniform(2, 40))
        pts = [(tip - sign * length, coord), (tip, coord - eps / 2), (tip, coord + eps / 2)]
        v = np.array([(a, b, 1.0) if axis == 0 else (b, a, 1.0) for a, b in pts], np.float32)
        if _spills(v, axis, edge, sign, coord):
            out.append(v)
    return out


def _slivers() -> list:
    out = []
    for i, (k1, k2) in enumerate([(1, 1), (1, 2), (2, 1), (1, 3), (3, 1), (2, 2), (1, 4),
                                  (3, 2), (2, 3), (5, 1), (1, 6), (4, 2)]):
        cx, cy = np.float32(10.5 + 21 * i), np.float32(4.5 + 8 * (i % 12))
        dx = np.spacing(cx) * k1
        dy = np.spacing(cy) * k2
        out.append(np.array([[cx, cy, 1.5], [cx + dx, cy, 1.5], [cx, cy + dy, 1.5]], np.float32))
    return out


def _on_tile_edges(rng) -> list:
    out = []
    for _ in range(24):
        x, y = tr.TILE_W * float(rng.integers(1, ADV_W // tr.TILE_W)), \
            tr.TILE_H * float(rng.integers(1, ADV_H // tr.TILE_H))
        sx, sy = rng.choice([-1.0, 1.0], 2)
        dx, dy = float(rng.integers(1, 6)), float(rng.integers(1, 6))
        z = float(rng.uniform(1.2, 3.0))
        out.append(np.array([[x, y, z], [x + sx * dx, y, z], [x, y + sy * dy, z]], np.float32))
    return out


def _behind_camera(rng) -> list:
    out = []
    for _ in range(8):
        far = [float(rng.uniform(-6000, -1000)), float(rng.uniform(2000, 8000))]
        a = rng.uniform([0, 0], [ADV_W, ADV_H])
        b = a + rng.uniform(-20, 20, 2)
        out.append(np.array([[a[0], a[1], 2.0], [b[0], b[1], 2.5], [far[0], far[1], -1.0]],
                            np.float32))
    return out


def _small_random(rng, count: int) -> list:
    centres = rng.uniform([0, 0], [ADV_W, ADV_H], (count, 2))
    out = []
    for c in centres:
        pts = c + rng.uniform(-4, 4, (3, 2))
        z = rng.uniform(1.2, 8.0, (3, 1))
        out.append(np.concatenate([pts, z], 1).astype(np.float32))
    return out


def adversarial_scene():
    """(verts (V, 3) float32, faces (F, 3) int64, ADV_H, ADV_W), from seed 5."""
    rng = np.random.default_rng(5)
    tris = (_needles(rng, 16, 0) + _needles(rng, 16, 1) + _slivers() + _on_tile_edges(rng)
            + _behind_camera(rng) + _small_random(rng, 200))
    order = rng.permutation(len(tris))
    spanner = np.array([[-1000, -1000, 50.0], [3000, -1000, 50.0], [-1000, 3000, 50.0]],
                       np.float32)
    seq = []
    for i in order:       # a far face opens every chunk, so every chunk spans the image
        if len(seq) % tr.FACE_CHUNK == 0:
            seq.append(spanner)
        seq.append(tris[i])
    verts = np.concatenate(seq)
    faces = np.arange(len(verts)).reshape(-1, 3)
    return torch.from_numpy(verts), torch.from_numpy(faces), ADV_H, ADV_W


def vertex_boxes(verts: torch.Tensor, faces: torch.Tensor, padded: int) -> torch.Tensor:
    """Each face's vertex bounding box, padding rows empty: the culling rule
    without its safeguard, a planted fault."""
    tri = verts[faces.long()]
    box = torch.stack([tri[..., 0].amin(1), tri[..., 0].amax(1), tri[..., 1].amin(1),
                       tri[..., 1].amax(1)], dim=1)
    pad = torch.tensor([[float("inf"), -float("inf")] * 2]).expand(padded - len(box), 4)
    return torch.cat([box, pad])


def culled_raster(planes: torch.Tensor, keep: torch.Tensor, height: int, width: int):
    """rasterize_tiles_plain over the faces ``keep`` (tiles_y, tiles_x, padded) lists."""
    return tr.rasterize_tiles_plain(planes, lambda ty, tx: keep[ty, tx].nonzero().flatten(),
                                    height=height, width=width)
