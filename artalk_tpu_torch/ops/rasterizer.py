"""Mesh z-buffer rasterizer: a hand-written CUDA kernel and its plain version.

Counterpart of ``artalk_tpu/ops/rasterizer.py``. Setup is plain torch, as it
is XLA in JAX: ``face_planes`` turns screen-space vertices into per-face
affine planes (barycentrics w0, w1 and depth z) and ``chunk_bboxes`` bounds
each 128-face chunk. ``rasterize`` resolves visibility with the CUDA kernel in
``csrc/rasterizer.cu`` for CUDA tensors, and with ``rasterize_plain`` for CPU
tensors; for a CUDA tensor it launches the kernel or raises.

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
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

import torch

FACE_CHUNK = 128   # faces per culling chunk
BIG = 3.4e38
_KEY_MASK = ~0xFF
_PLAIN_ROWS = 8    # pixel rows per band of rasterize_plain

# Launches of the CUDA kernel in this process; rasterize() adds one per launch.
LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rasterizer.cu"
_BUILD_DIR = _PKG / "_build"
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


def chunk_bboxes(verts_screen: torch.Tensor, faces: torch.Tensor,
                 num_chunks: int) -> torch.Tensor:
    """(num_chunks, 4) [xmin, xmax, ymin, ymax] over each FACE_CHUNK of faces."""
    tri = verts_screen[faces.long()]                       # (F, 3, 3)
    fx = tri[..., 0].reshape(num_chunks, FACE_CHUNK * 3)
    fy = tri[..., 1].reshape(num_chunks, FACE_CHUNK * 3)
    return torch.stack([fx.amin(1), fx.amax(1), fy.amin(1), fy.amax(1)], dim=1)


def _kernel_inputs(verts_screen: torch.Tensor, faces: torch.Tensor):
    """Faces padded to whole chunks with degenerate faces; returns the packed
    (padded, 9) plane table, the chunk bboxes and the chunk count."""
    num_faces = faces.shape[0]
    num_chunks = (num_faces + FACE_CHUNK - 1) // FACE_CHUNK
    padded = num_chunks * FACE_CHUNK
    faces = torch.cat([faces.long(), faces.new_zeros((padded - num_faces, 3)).long()])
    a0, a1, az = face_planes(verts_screen, faces)
    a0[num_faces:] = verts_screen.new_tensor([0.0, 0.0, -1.0])  # padding never covers
    planes = torch.cat([a0, a1, az], dim=1).contiguous()
    return planes, chunk_bboxes(verts_screen, faces, num_chunks).contiguous(), num_chunks


def build() -> float:
    """Build (or reuse) and load the kernel's shared library. Returns the
    seconds spent, 0.0 when it was already loaded."""
    global _LIB
    if _LIB is not None:
        return 0.0
    t0 = time.perf_counter()
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"librasterizer-{digest}.so"
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.artalk_rasterize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LIB = lib
    return time.perf_counter() - t0


def rasterize(verts_screen: torch.Tensor, faces: torch.Tensor, *,
              height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Z-buffer rasterization of one mesh.

    verts_screen: (V, 3) float32 pixel-space x, y and camera-space z (z > 0 in
    front); faces: (F, 3) vertex indices. Returns (zbuf (H, W) float32, BIG for
    background; face_id (H, W) int32, -1 for background). A CUDA tensor goes
    through the CUDA kernel, a CPU tensor through ``rasterize_plain``."""
    global LAUNCHES
    if verts_screen.device.type == "cpu":
        return rasterize_plain(verts_screen, faces, height=height, width=width)
    if verts_screen.device.type != "cuda":
        raise ValueError(f"rasterize: unsupported device {verts_screen.device}")
    if verts_screen.dtype != torch.float32 or verts_screen.shape[-1] != 3:
        raise ValueError(f"rasterize: want (V, 3) float32 verts, got "
                         f"{tuple(verts_screen.shape)} {verts_screen.dtype}")
    if faces.device != verts_screen.device or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError("rasterize: faces must be (F, 3) on the verts' device")
    build()
    planes, bbox, num_chunks = _kernel_inputs(verts_screen, faces)
    zbuf = torch.empty((height, width), dtype=torch.float32, device=verts_screen.device)
    fid = torch.empty((height, width), dtype=torch.int32, device=verts_screen.device)
    stream = torch.cuda.current_stream(verts_screen.device).cuda_stream
    err = _LIB.artalk_rasterize(planes.data_ptr(), bbox.data_ptr(), num_chunks,
                                height, width, zbuf.data_ptr(), fid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterizer kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return zbuf, fid


def rasterize_plain(verts_screen: torch.Tensor, faces: torch.Tensor, *,
                    height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch version of ``rasterize`` (same truncated-key semantics).

    Works on bands of a few pixel rows so that (pixels x faces) fits in
    memory; a face whose bbox misses the band (by the band's edges, half a
    pixel beyond its centres) cannot cover any of its pixels and is skipped.
    Plane evaluation is ((px * ax) + (py * ay)) + c, as in the kernel."""
    device = verts_screen.device
    a0, a1, az = face_planes(verts_screen, faces)
    fy = verts_screen[faces.long(), 1]
    ymin, ymax = fy.amin(1), fy.amax(1)
    px = (torch.arange(width, device=device, dtype=torch.float32) + 0.5)[None, :, None]
    none = torch.iinfo(torch.int64).max
    zbuf = torch.full((height, width), BIG, dtype=torch.float32, device=device)
    fid = torch.full((height, width), -1, dtype=torch.int32, device=device)
    for y0 in range(0, height, _PLAIN_ROWS):
        y1 = min(y0 + _PLAIN_ROWS, height)
        sel = torch.nonzero((ymax >= y0) & (ymin <= y1)).flatten()
        if sel.numel() == 0:
            continue
        py = (torch.arange(y0, y1, device=device, dtype=torch.float32) + 0.5)[:, None, None]
        p0, p1, pz = a0[sel], a1[sel], az[sel]
        w0 = px * p0[:, 0] + py * p0[:, 1] + p0[:, 2]       # (R, W, S)
        w1 = px * p1[:, 0] + py * p1[:, 1] + p1[:, 2]
        z = px * pz[:, 0] + py * pz[:, 1] + pz[:, 2]
        covered = (w0 >= 0.0) & (w1 >= 0.0) & (w0 + w1 <= 1.0) & (z > 0.0)
        zbits = (z.view(torch.int32) & _KEY_MASK).long()
        key = torch.where(covered, (zbits << 32) | sel, none).amin(dim=-1)
        hit = key != none
        zb = (key >> 32).to(torch.int32).view(torch.float32)
        zbuf[y0:y1] = torch.where(hit, zb, BIG)
        fid[y0:y1] = torch.where(hit, key & 0xFFFFFFFF, -1).to(torch.int32)
    return zbuf, fid
