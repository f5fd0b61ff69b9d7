"""Mesh z-buffer rasterizer: a hand-written CUDA kernel and its plain version.

Counterpart of ``artalk_tpu/ops/rasterizer.py``. ``face_planes`` turns
screen-space vertices into per-face affine planes (barycentrics w0, w1 and
depth z) and ``chunk_bboxes`` bounds each 128-face chunk, as the JAX
package's XLA setup does. ``rasterize`` runs the setup and the visibility
resolve as the two CUDA kernels of ``csrc/rasterizer.cu`` for CUDA tensors
(the setup adds each face's ``cull_boxes`` row, by which the raster kernel
culls faces per tile), and ``rasterize_plain`` for CPU tensors; for a CUDA
tensor it launches the kernels or raises.

Both keep the TPU kernel's truncated-key semantics: a face covers a pixel
centre when w0 >= 0, w1 >= 0, w0 + w1 <= 1 and z > 0, and the winner is the
lexicographic minimum of ``(z_bits & ~0xFF, face_id)``; zbuf holds that
truncated depth (``BIG`` for background) and face_id the winner (-1 for
background).

The kernel's shared library is built with nvcc at first use from the source
in the package, into ``_build/`` beside it, and named by the source's hash.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from ._nvcc import CSRC, build_library, library_lock

FACE_CHUNK = 128   # faces per culling chunk
BIG = 3.4e38
_KEY_MASK = ~0xFF
TILE_W, TILE_H = 32, 8   # the raster kernel's pixel tile
# bounds of cull_boxes: a plane evaluation's rounding error relative to
# |px a| + |py b| + |c| (gamma_3 = 3u / (1 - 3u) < 2^-22, u = 2^-24); the slack
# of fl(w0 + w1) <= 1 (2u); subnormal results; float64 rounding in the map
# back to pixels, relative to the magnitudes it was computed from
_EVAL_ERR = 2.0 ** -22
_SUM_SLACK = 2.0 ** -23
_UNDERFLOW = 2.0 ** -120
_MAP_ERR = 2.0 ** -48

# Launches of the CUDA kernel in this process; rasterize() adds one per launch.
LAUNCHES = 0

SOURCE = CSRC / "rasterizer.cu"
_LIB = None


def face_planes(verts_screen: torch.Tensor, faces: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-face plane coefficients (a0, a1, az), each (F, 3) rows
    [coef_x, coef_y, const] with w0 = a0 . (x, y, 1) etc.

    verts_screen: (V, 3) with (x_pix, y_pix, z_cam); faces: (F, 3) int.
    Degenerate faces get a0 = (0, 0, -1) and are never covered."""
    faces = faces.long()
    v0, v1, v2 = verts_screen[faces[:, 0]], verts_screen[faces[:, 1]], verts_screen[faces[:, 2]]
    x0, y0, z0 = v0.unbind(-1)
    x1, y1, z1 = v1.unbind(-1)
    x2, y2, z2 = v2.unbind(-1)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)   # signed double area
    ok = torch.abs(area) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, area, torch.ones_like(area)),
                      torch.zeros_like(area))
    a0x = (y1 - y2) * inv
    a0y = (x2 - x1) * inv
    a0c = (x1 * y2 - x2 * y1) * inv
    a1x = (y2 - y0) * inv
    a1y = (x0 - x2) * inv
    a1c = (x2 * y0 - x0 * y2) * inv
    # z = w0 z0 + w1 z1 + w2 z2 = w0 (z0 - z2) + w1 (z1 - z2) + z2
    dz0, dz1 = z0 - z2, z1 - z2
    azx = a0x * dz0 + a1x * dz1
    azy = a0y * dz0 + a1y * dz1
    azc = a0c * dz0 + a1c * dz1 + z2
    degenerate = verts_screen.new_tensor([0.0, 0.0, -1.0])
    a0 = torch.where(ok[:, None], torch.stack([a0x, a0y, a0c], dim=1), degenerate)
    a1 = torch.where(ok[:, None], torch.stack([a1x, a1y, a1c], dim=1), 0.0)
    az = torch.stack([azx, azy, azc], dim=1)
    return a0, a1, az


def edge_ties(verts_screen: torch.Tensor, faces: torch.Tensor, pix,
              tol: float = 1e-6) -> torch.Tensor:
    """(N,) bool on the CPU: for pixels ``pix`` (N, 2) of (y, x), does the
    centre lie on an edge of a face (one barycentric within ``tol`` of 0 in
    float64, none below)? There two roundings of the plane evaluation (the
    kernel's uncontracted one, an FMA elsewhere) may decide coverage either
    way, so comparisons of coverage allow differences only at such pixels."""
    a0, a1, _ = face_planes(verts_screen.detach().double().cpu(), faces.cpu())
    p = torch.as_tensor(pix).reshape(-1, 2).flip(1).double() + 0.5       # (N, 2) x, y
    w0 = p[:, 0:1] * a0[:, 0] + p[:, 1:2] * a0[:, 1] + a0[:, 2]
    w1 = p[:, 0:1] * a1[:, 0] + p[:, 1:2] * a1[:, 1] + a1[:, 2]
    ws = torch.stack([w0, w1, 1.0 - w0 - w1], dim=-1)                   # (N, F, 3)
    return ((ws.amin(-1).abs() <= tol) & (ws >= -tol).all(-1)).any(-1)


def chunk_bboxes(verts_screen: torch.Tensor, faces: torch.Tensor,
                 num_chunks: int) -> torch.Tensor:
    """(num_chunks, 4) [xmin, xmax, ymin, ymax] over each FACE_CHUNK of faces."""
    tri = verts_screen[faces.long()]                       # (F, 3, 3)
    fx = tri[..., 0].reshape(num_chunks, FACE_CHUNK * 3)
    fy = tri[..., 1].reshape(num_chunks, FACE_CHUNK * 3)
    return torch.stack([fx.amin(1), fx.amax(1), fy.amin(1), fy.amax(1)], dim=1)


def cull_boxes(planes: torch.Tensor, *, height: int, width: int) -> torch.Tensor:
    """(N, 4) float32 [xmin, xmax, ymin, ymax] per plane row of ``planes`` (N,
    9): a box holding every pixel centre of the image at which the rounded
    evaluation of the row can report coverage (``csrc/rasterizer.cu`` computes
    the same numbers, operation by operation).

    Why it is safe. At a centre p (0 < px < width, 0 < py < height) the kernel
    evaluates W0 = ((px * a) + (py * b)) + c in float32; its distance from the
    exact value w0 = a px + b py + c of the same float32 coefficients is at
    most gamma_3 (|a px| + |b py| + |c|) < _EVAL_ERR (|a| width + |b| height +
    |c|) = e0 (plus _UNDERFLOW for subnormal results), and likewise for W1
    with e1. A covered centre has W0 >= 0, W1 >= 0 and fl(W0 + W1) <= 1, so
    W0 + W1 <= 1 + 2^-24; hence w0 >= -e0, w1 >= -e1 and w0 + w1 <= 1 +
    _SUM_SLACK + e0 + e1. That triangle of (w0, w1), mapped back through the
    inverse of p -> (w0, w1) in float64 (each corner widened by _MAP_ERR of
    the magnitudes it was computed from) and rounded outward to float32,
    holds every such p. Nothing here assumes the planes came from the
    vertices accurately: a sliver whose constant term lost its digits to
    cancellation gets the box of the triangle its planes describe, which may
    lie pixels beyond its vertices. A degenerate row (a0 = (0, 0, -1): w0 =
    -1 everywhere) gets an empty box (+inf, -inf, +inf, -inf); a row whose
    map is singular or not finite gets the box of everything."""
    p = planes.double()
    a, b, c, d, e, f = p[:, :6].unbind(-1)
    degenerate = (p[:, 0] == 0) & (p[:, 1] == 0) & (p[:, 2] == -1) & (p[:, 3:6] == 0).all(-1)
    e0 = _EVAL_ERR * ((a.abs() * width + b.abs() * height) + c.abs()) + _UNDERFLOW
    e1 = _EVAL_ERR * ((d.abs() * width + e.abs() * height) + f.abs()) + _UNDERFLOW
    far0 = ((1.0 + _SUM_SLACK) + e0) + 2.0 * e1
    far1 = ((1.0 + _SUM_SLACK) + 2.0 * e0) + e1
    det = a * e - b * d
    xs, ys, finite = [], [], (det != 0) & torch.isfinite(det)
    for u0, u1 in ((-e0, -e1), (far0, -e1), (-e0, far1)):
        r0, r1 = u0 - c, u1 - f
        x = (e * r0 - b * r1) / det
        y = (a * r1 - d * r0) / det
        m0, m1 = u0.abs() + c.abs(), u1.abs() + f.abs()
        mx = _MAP_ERR * (e.abs() * m0 + b.abs() * m1) / det.abs()
        my = _MAP_ERR * (a.abs() * m1 + d.abs() * m0) / det.abs()
        finite &= torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(mx) & torch.isfinite(my)
        xs += [x - mx, x + mx]
        ys += [y - my, y + my]
    xs, ys = torch.stack(xs, -1), torch.stack(ys, -1)
    box = torch.stack([_round_down(xs.amin(-1)), _round_up(xs.amax(-1)),
                       _round_down(ys.amin(-1)), _round_up(ys.amax(-1))], dim=-1)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=planes.device)
    box = torch.where(finite[:, None], box, torch.stack([-inf, inf, -inf, inf]))
    return torch.where(degenerate[:, None], torch.stack([inf, -inf, inf, -inf]), box)


def _round_down(x: torch.Tensor) -> torch.Tensor:
    """float64 -> the largest float32 <= x."""
    f = x.float()
    return torch.where(f.double() > x, torch.nextafter(f, f.new_tensor(-float("inf"))), f)


def _round_up(x: torch.Tensor) -> torch.Tensor:
    """float64 -> the smallest float32 >= x."""
    f = x.float()
    return torch.where(f.double() < x, torch.nextafter(f, f.new_tensor(float("inf"))), f)


def kernel_inputs_plain(verts_screen: torch.Tensor, faces: torch.Tensor, *, height: int,
                        width: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch version of the setup kernel (``kernel_inputs``): faces
    padded to whole chunks with faces of vertex 0 (degenerate, never
    covered); returns the (padded, 9) plane table [a0 a1 az] of
    ``face_planes``, the (padded, 4) ``cull_boxes`` and the (num_chunks, 4)
    ``chunk_bboxes`` of the padded faces."""
    num_chunks = (faces.shape[0] + FACE_CHUNK - 1) // FACE_CHUNK
    pad = faces.new_zeros((num_chunks * FACE_CHUNK - faces.shape[0], 3))
    faces = torch.cat([faces, pad]).long()
    planes = torch.cat(face_planes(verts_screen, faces), dim=1)
    return (planes, cull_boxes(planes, height=height, width=width),
            chunk_bboxes(verts_screen, faces, num_chunks))


def tile_hits(boxes: torch.Tensor, *, height: int, width: int) -> torch.Tensor:
    """(tiles_y, tiles_x, N) bool: does each box [xmin, xmax, ymin, ymax]
    overlap each TILE_W x TILE_H pixel tile? The comparison of the TPU
    kernel's chunk test, against the tile's edges (the pixel centres lie half
    a pixel inside them)."""
    x0 = torch.arange(0, width, TILE_W, device=boxes.device, dtype=torch.float32)[:, None]
    y0 = torch.arange(0, height, TILE_H, device=boxes.device, dtype=torch.float32)[:, None]
    in_x = (boxes[:, 1] >= x0) & (boxes[:, 0] <= x0 + TILE_W)
    in_y = (boxes[:, 3] >= y0) & (boxes[:, 2] <= y0 + TILE_H)
    return in_y[:, None, :] & in_x[None, :, :]


def face_culling(boxes: torch.Tensor, chunk_boxes: torch.Tensor, *, height: int,
                 width: int) -> torch.Tensor:
    """The kernel's culling rule: (tiles_y, tiles_x, padded) bool, True for
    the faces a tile evaluates, those of the chunks whose vertex box overlaps
    the tile whose own cull box overlaps it too."""
    chunks = tile_hits(chunk_boxes, height=height, width=width)
    return chunks.repeat_interleave(FACE_CHUNK, dim=-1) & tile_hits(boxes, height=height,
                                                                     width=width)


def kernel_inputs(verts_screen: torch.Tensor, faces: torch.Tensor, *, height: int,
                  width: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The setup kernel alone on CUDA tensors (``kernel_inputs_plain`` for
    CPU tensors): planes, cull boxes and chunk boxes."""
    if verts_screen.device.type == "cpu":
        return kernel_inputs_plain(verts_screen, faces, height=height, width=width)
    verts_screen, faces = _check(verts_screen, faces)
    planes, boxes, chunks = _scratch(faces.shape[0], verts_screen.device)
    stream = torch.cuda.current_stream(verts_screen.device).cuda_stream
    err = _LIB.artalk_rasterize_setup(
        verts_screen.data_ptr(), faces.data_ptr(), faces.element_size(), verts_screen.shape[0],
        faces.shape[0], height, width, planes.data_ptr(), boxes.data_ptr(), chunks.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"rasterizer setup kernel launch failed: cudaError {err}")
    return planes, boxes, chunks


def build() -> float:
    """Build (or reuse) and load the kernels' shared library. Returns the
    seconds spent, 0.0 when it was already loaded."""
    global _LIB
    with library_lock(SOURCE):
        if _LIB is not None:
            return 0.0
        lib, seconds, _ = build_library(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.artalk_rasterize.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr,
                                         ptr, ptr]
        lib.artalk_rasterize_setup.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr,
                                               ptr]
        lib.artalk_rasterize_tiles.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
        for fn in (lib.artalk_rasterize, lib.artalk_rasterize_setup, lib.artalk_rasterize_tiles):
            fn.restype = ctypes.c_int
        _LIB = lib
        return seconds


def _check(verts_screen: torch.Tensor, faces: torch.Tensor):
    """What the kernels take: (V, 3) float32 verts and (F, 3) int32 or int64
    faces, contiguous, on one CUDA device. Builds the library."""
    if verts_screen.device.type != "cuda":
        raise ValueError(f"rasterize: unsupported device {verts_screen.device}")
    if verts_screen.dtype != torch.float32 or verts_screen.ndim != 2 or verts_screen.shape[1] != 3:
        raise ValueError(f"rasterize: want (V, 3) float32 verts, got "
                         f"{tuple(verts_screen.shape)} {verts_screen.dtype}")
    if (faces.device != verts_screen.device or faces.ndim != 2 or faces.shape[1] != 3
            or faces.dtype not in (torch.int32, torch.int64)):
        raise ValueError("rasterize: faces must be (F, 3) int32 or int64 on the verts' device")
    build()
    return verts_screen.contiguous(), faces.contiguous()


def _scratch(num_faces: int, device: torch.device):
    """The setup's outputs, carved from one allocation: planes (padded, 9),
    cull boxes (padded, 4) and chunk boxes (num_chunks, 4)."""
    num_chunks = (num_faces + FACE_CHUNK - 1) // FACE_CHUNK
    padded = num_chunks * FACE_CHUNK
    buf = torch.empty(padded * 13 + num_chunks * 4, dtype=torch.float32, device=device)
    return (buf[:padded * 9].view(padded, 9), buf[padded * 9:padded * 13].view(padded, 4),
            buf[padded * 13:].view(num_chunks, 4))


def rasterize(verts_screen: torch.Tensor, faces: torch.Tensor, *,
              height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Z-buffer rasterization of one mesh.

    verts_screen: (V, 3) float32 pixel-space x, y and camera-space z (z > 0 in
    front); faces: (F, 3) vertex indices. Returns (zbuf (H, W) float32, BIG for
    background; face_id (H, W) int32, -1 for background). A CUDA tensor goes
    through the two CUDA kernels (setup, raster), a CPU tensor through
    ``rasterize_plain``."""
    global LAUNCHES
    if verts_screen.device.type == "cpu":
        return rasterize_plain(verts_screen, faces, height=height, width=width)
    verts_screen, faces = _check(verts_screen, faces)
    dev = verts_screen.device
    planes, boxes, chunks = _scratch(faces.shape[0], dev)
    zbuf = torch.empty((height, width), dtype=torch.float32, device=dev)
    fid = torch.empty((height, width), dtype=torch.int32, device=dev)
    err = _LIB.artalk_rasterize(
        verts_screen.data_ptr(), faces.data_ptr(), faces.element_size(), verts_screen.shape[0],
        faces.shape[0], height, width, planes.data_ptr(), boxes.data_ptr(), chunks.data_ptr(),
        zbuf.data_ptr(), fid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rasterizer kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return zbuf, fid


def rasterize_tiles_plain(planes: torch.Tensor, tile_faces: Callable[[int, int], torch.Tensor],
                          *, height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raster kernel in plain torch: each TILE_W x TILE_H tile (ty, tx)
    evaluates the faces ``tile_faces(ty, tx)`` (ids into ``planes``) at its
    pixel centres, ((px * ax) + (py * ay)) + c as the kernel rounds, and keeps
    the minimum key. One row of tiles at a time, its lists padded."""
    device = planes.device
    none = torch.iinfo(torch.int64).max
    tiles_x = (width + TILE_W - 1) // TILE_W
    zbuf = torch.full((height, width), BIG, dtype=torch.float32, device=device)
    fid = torch.full((height, width), -1, dtype=torch.int32, device=device)
    px = (torch.arange(tiles_x * TILE_W, device=device, dtype=torch.float32) + 0.5
          ).view(tiles_x, 1, TILE_W, 1)
    for ty, y0 in enumerate(range(0, height, TILE_H)):
        lists = [tile_faces(ty, tx) for tx in range(tiles_x)]
        longest = max(len(f) for f in lists)
        if longest == 0:
            continue
        sel = torch.full((tiles_x, longest), -1, dtype=torch.int64, device=device)
        for tx, f in enumerate(lists):
            sel[tx, :len(f)] = f
        rows = min(TILE_H, height - y0)
        py = (torch.arange(y0, y0 + rows, device=device, dtype=torch.float32) + 0.5
              ).view(1, rows, 1, 1)
        p = planes[sel.clamp(min=0)][:, None, None]                 # (tiles, 1, 1, F, 9)
        w0 = px * p[..., 0] + py * p[..., 1] + p[..., 2]           # (tiles, rows, TILE_W, F)
        w1 = px * p[..., 3] + py * p[..., 4] + p[..., 5]
        z = px * p[..., 6] + py * p[..., 7] + p[..., 8]
        covered = (w0 >= 0.0) & (w1 >= 0.0) & (w0 + w1 <= 1.0) & (z > 0.0) \
            & (sel >= 0)[:, None, None]
        zbits = (z.view(torch.int32) & _KEY_MASK).long()
        key = torch.where(covered, (zbits << 32) | sel[:, None, None], none).amin(dim=-1)
        key = key.permute(1, 0, 2).reshape(rows, tiles_x * TILE_W)[:, :width]
        hit = key != none
        zbuf[y0:y0 + rows] = torch.where(hit, (key >> 32).to(torch.int32).view(torch.float32),
                                         BIG)
        fid[y0:y0 + rows] = torch.where(hit, key & 0xFFFFFFFF, -1).to(torch.int32)
    return zbuf, fid


def rasterize_plain(verts_screen: torch.Tensor, faces: torch.Tensor, *,
                    height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch version of ``rasterize`` (same truncated-key semantics),
    culled by chunk only: each tile evaluates every face of every chunk whose
    vertex box overlaps it, the function the kernel computes with its
    per-face cull (``face_culling``)."""
    planes, _, chunk_boxes = kernel_inputs_plain(verts_screen, faces, height=height,
                                                 width=width)
    hits = tile_hits(chunk_boxes, height=height, width=width)
    chunk_faces = torch.arange(planes.shape[0], device=planes.device).view(-1, FACE_CHUNK)
    return rasterize_tiles_plain(planes, lambda ty, tx: chunk_faces[hits[ty, tx]].flatten(),
                                 height=height, width=width)
