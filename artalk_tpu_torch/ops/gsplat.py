"""3D Gaussian splatting with 32 feature channels: a hand-written CUDA kernel
and its plain version.

Counterpart of ``artalk_tpu/ops/gsplat.py``. The prepass is plain PyTorch, as
it is XLA in JAX:

1. ``_project_components``: EWA projection of each gaussian to a 2-D conic,
   its pixel mean, depth and radius (elementwise, in the JAX order of
   operations).
2. ``_build_instances``: a stable depth argsort; each gaussian emits one
   instance per 16x128-pixel tile of its bbox-anchored 2x4-tile window that
   its clamped bbox meets (``_slot_validity``); the int32 instance keys
   ``tile << rank_bits | depth rank`` are sorted by ``ops/sort.sort_keys``
   (the radix-sort CUDA kernel of ``csrc/sort.cu`` for CUDA tensors) and
   ``searchsorted`` gives each tile's segment. Instances are counted per
   frame, so there is no static budget: this is the JAX package's exact path
   (``max_instances=None``).

``splat_tiles`` composites every tile's segment front to back with the CUDA
kernel in ``csrc/gsplat.cu`` (CUDA tensors only), ``splat_tiles_plain`` with
plain PyTorch, vectorised over (pixels x instances) per tile. The kernel
culls, per 16x16 block of a tile, the instances that cannot pass the alpha
cut at any of the block's pixels; ``block_culling`` is the plain version of
that rule, and ``composite_plain(..., keep=)`` composites each block from its
culled list.
``rasterize_gaussians`` runs the prepass and the kernel for CUDA tensors, and
``rasterize_gaussians_plain`` for CPU tensors; any other device raises.

What the port keeps of the JAX kernel's function (not of the 3DGS CUDA
original): the 2x4-tile emission window with radii clamped to
``MAX_RX``/``MAX_RY``, alpha evaluated at every pixel of a listed tile, and
the order of a stable depth argsort. What differs: JAX stops a whole tile
after a 512-gaussian chunk once every pixel's transmittance T <= ``T_EPS``;
here each pixel stops once its own T <= ``T_EPS``. The difference is at most
``T_EPS`` times the largest |color| per channel.

The kernel's shared library is built with nvcc at first use (``ops/_nvcc.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ._nvcc import CSRC, build_library, library_lock
from .sort import sort_keys

CHANNELS = 32
GTILE_H = 16       # the JAX tile: the unit of the instance lists
GTILE_W = 128
DUP_X = 2          # tile slots per gaussian in x (128-px tiles)
DUP_Y = 4          # tile slots per gaussian in y (16-px tiles)
DUP = DUP_X * DUP_Y
MAX_RX = (DUP_X - 1) * GTILE_W // 2    # 64 px: emission radius clamp
MAX_RY = (DUP_Y - 1) * GTILE_H // 2    # 24 px
ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
BLOCK = 16         # the kernel's CTA: a 16x16-pixel block of a tile
CULL_REL = 2.0 ** -16   # the culling box's slack (csrc/gsplat.cu: kCullRel,
CULL_TAU = 1e-4         # kCullTau, kCullPx)
CULL_PX = 1.0 / 64.0
_PLAIN_CHUNK = 1024  # instances per step of splat_tiles_plain

# Launches of the CUDA kernel in this process; splat_tiles() adds one per launch.
LAUNCHES = 0

SOURCE = CSRC / "gsplat.cu"
BUILD_REPORT = ""
_LIB = None


def _project_components(xyz: torch.Tensor, scales: torch.Tensor, rotations: torch.Tensor,
                        cam_matrix: torch.Tensor, focal: float, size: int
                        ) -> Dict[str, torch.Tensor]:
    """Projection in structure-of-arrays form, every output (N,): pixel mean
    (mx, my), depth, conic (ca, cb, cc) of the inverse 2-D covariance, radius
    and in_front. cam_matrix: (3, 4) world->view in the reference's
    row-vector convention (p_view = p @ V[:3, :3] + t, x and y negated)."""
    r = cam_matrix[:3, :3]
    t = cam_matrix[:3, 3]
    flip = (-1.0, -1.0, 1.0)
    x0, x1, x2 = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    pv = [(x0 * r[0, i] + x1 * r[1, i] + x2 * r[2, i] + t[i]) * flip[i] for i in range(3)]
    depth = pv[2]
    in_front = depth > 0.01

    fpix = focal * (size / 2.0)  # focal in NDC units -> pixels
    zs = torch.clamp(depth, min=0.01)
    mx = (focal * pv[0] / zs + 1.0) * (size / 2.0)
    my = (focal * pv[1] / zs + 1.0) * (size / 2.0)

    # cov3d = M M^T with M = R(q) diag(s): 6 unique components
    w, qx, qy, qz = rotations.unbind(-1)
    rot = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - w * qz), 2 * (qx * qz + w * qy)],
        [2 * (qx * qy + w * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - w * qx)],
        [2 * (qx * qz - w * qy), 2 * (qy * qz + w * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]
    s = scales.unbind(-1)
    m = [[rot[i][j] * s[j] for j in range(3)] for i in range(3)]
    cov = {(i, j): m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]
           for i in range(3) for j in range(3) if i <= j}

    # EWA: cov2d = (J W) cov3d (J W)^T, W the constant view rotation incl. the flip
    lim = 1.3 / focal
    txz = torch.clamp(pv[0] / zs, -lim, lim) * zs
    tyz = torch.clamp(pv[1] / zs, -lim, lim) * zs
    j00 = fpix / zs
    j02 = -fpix * txz / (zs * zs)
    j12 = -fpix * tyz / (zs * zs)
    wrow = [[r[k, c] * flip[c] for c in range(3)] for k in range(3)]
    jw0 = [j00 * wrow[0][k] + j02 * wrow[2][k] for k in range(3)]
    jw1 = [j00 * wrow[1][k] + j12 * wrow[2][k] for k in range(3)]

    def quad(a, b):
        """a . cov3d . b for 3-component per-gaussian vectors a, b."""
        return (a[0] * b[0] * cov[(0, 0)] + a[1] * b[1] * cov[(1, 1)]
                + a[2] * b[2] * cov[(2, 2)]
                + (a[0] * b[1] + a[1] * b[0]) * cov[(0, 1)]
                + (a[0] * b[2] + a[2] * b[0]) * cov[(0, 2)]
                + (a[1] * b[2] + a[2] * b[1]) * cov[(1, 2)])

    # low-pass: each splat covers at least ~1 px (3DGS convention)
    c00 = quad(jw0, jw0) + 0.3
    c01 = quad(jw0, jw1)
    c11 = quad(jw1, jw1) + 0.3
    det = torch.clamp(c00 * c11 - c01 * c01, min=1e-12)
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    return {"mx": mx, "my": my, "depth": depth, "ca": c11 / det, "cb": -c01 / det,
            "cc": c00 / det, "radius": torch.ceil(3.0 * torch.sqrt(lam)),
            "in_front": in_front}


def _slot_validity(mx, my, radius, opac, size: int):
    """The bbox-anchored DUP_Y x DUP_X tile window of each gaussian: tiles
    from the bbox's top-left tile, kept where the bbox (radius clamped to
    MAX_RX / MAX_RY) meets the tile, inclusively. Returns (tx, ty, valid),
    each (DUP, N)."""
    rx = torch.clamp(radius, max=float(MAX_RX))
    ry = torch.clamp(radius, max=float(MAX_RY))
    cx0 = torch.floor((mx - rx) / GTILE_W)
    cy0 = torch.floor((my - ry) / GTILE_H)
    offs = [(dy, dx) for dy in range(DUP_Y) for dx in range(DUP_X)]
    ty = torch.stack([cy0 + dy for dy, _ in offs])
    tx = torch.stack([cx0 + dx for _, dx in offs])
    x0, x1 = tx * GTILE_W, (tx + 1) * GTILE_W
    y0, y1 = ty * GTILE_H, (ty + 1) * GTILE_H
    overlap = (mx + rx >= x0) & (mx - rx <= x1) & (my + ry >= y0) & (my - ry <= y1)
    valid = (overlap & (tx >= 0) & (tx < size // GTILE_W) & (ty >= 0)
             & (ty < size // GTILE_H) & (opac > 0) & (radius > 0))
    return tx, ty, valid


def _rank_bits(n: int) -> int:
    """Bits of an instance key that hold the depth rank of one of n gaussians."""
    return max((n - 1).bit_length(), 1)


def _depth_order(comp: Dict[str, torch.Tensor], opac: torch.Tensor):
    """The stable depth argsort ``perm`` and, in its order, the rows the tile
    slots need: (perm, mx, my, radius, opac)."""
    perm = torch.argsort(comp["depth"], stable=True)
    return perm, comp["mx"][perm], comp["my"][perm], comp["radius"][perm], opac[perm]


def _sorted_keys(mx, my, radius, opac, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The valid slots' instance keys of depth-ordered gaussians, sorted by
    ``sort_keys``, and each tile's segment: (sorted_key (P,) int32, offsets
    (num_tiles + 1,) int32)."""
    n = mx.shape[0]
    tiles_x = size // GTILE_W
    num_tiles = tiles_x * (size // GTILE_H)
    rank_bits = _rank_bits(n)
    tx, ty, valid = _slot_validity(mx, my, radius, opac, size)
    # key = tile << rank_bits | depth rank, as in JAX: unique, since a
    # gaussian never emits two slots into one tile; only the valid slots are
    # sorted
    rank = torch.arange(n, dtype=torch.int32, device=mx.device).expand(DUP, n)
    tile = (ty * tiles_x + tx)[valid].to(torch.int32)
    sorted_key = sort_keys((tile << rank_bits) | rank[valid])
    bounds = torch.arange(num_tiles + 1, dtype=torch.int32, device=mx.device) << rank_bits
    return sorted_key, torch.searchsorted(sorted_key, bounds).to(torch.int32)


def _instances(perm: torch.Tensor, sorted_key: torch.Tensor) -> torch.Tensor:
    """The gaussian of each sorted instance: its key's depth rank through
    ``perm``, int32."""
    return perm[sorted_key & ((1 << _rank_bits(perm.shape[0])) - 1)].to(torch.int32)


def _build_instances(comp: Dict[str, torch.Tensor], opac: torch.Tensor, size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-major, depth-minor instance lists. Returns (inst (P,) int32: the
    gaussian of each instance; offsets (num_tiles + 1,) int32: tile t's
    instances are inst[offsets[t]:offsets[t + 1]], front to back by the
    rank of a stable depth argsort)."""
    n = comp["depth"].shape[0]
    num_tiles = (size // GTILE_W) * (size // GTILE_H)
    if not (num_tiles + 1) < (1 << (31 - _rank_bits(n))):
        raise ValueError(f"instance keys overflow int32: {num_tiles} tiles of {n} gaussians")
    perm, *rows = _depth_order(comp, opac)
    sorted_key, offsets = _sorted_keys(*rows, size)
    return _instances(perm, sorted_key), offsets


def prepass(xyz, colors, opacities, scales, rotations, cam_matrix, focal: float = 12.0,
            size: int = 512, bf16_colors: bool = False):
    """Everything before compositing. Returns (geo (N, 8) float32 rows
    [mx, my, ca, cb, cc, opacity, 0, 0] with the opacity zeroed behind the
    camera, colors (N, 32) float32 or bfloat16, inst, offsets)."""
    if size % GTILE_H or size % GTILE_W:
        raise ValueError(f"size {size} must be a multiple of {GTILE_W}")
    comp = _project_components(xyz, scales, rotations, cam_matrix, focal, size)
    opac = torch.where(comp["in_front"], opacities[..., 0], 0.0)
    inst, offsets = _build_instances(comp, opac, size)
    zeros = torch.zeros_like(opac)
    geo = torch.stack([comp["mx"], comp["my"], comp["ca"], comp["cb"], comp["cc"], opac,
                       zeros, zeros], dim=1)
    colors = colors.to(torch.bfloat16 if bf16_colors else torch.float32).contiguous()
    return geo, colors, inst, offsets


def build() -> float:
    """Build (or reuse) and load the kernel's shared library. Returns the
    seconds spent, 0.0 when it was already loaded."""
    global _LIB, BUILD_REPORT
    with library_lock(SOURCE):
        if _LIB is not None:
            return 0.0
        lib, seconds, BUILD_REPORT = build_library(SOURCE)
        fn = lib.artalk_gsplat
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
        return seconds


def splat_tiles(geo: torch.Tensor, colors: torch.Tensor, inst: torch.Tensor,
                offsets: torch.Tensor, size: int) -> torch.Tensor:
    """Composite every tile's instance segment with the CUDA kernel ->
    (32, size, size) float32 on a black background. CUDA tensors only."""
    global LAUNCHES
    dev = geo.device
    if dev.type != "cuda":
        raise ValueError(f"splat_tiles: the kernel takes CUDA tensors, got {dev}")
    n = geo.shape[0]
    if geo.dtype != torch.float32 or geo.shape != (n, 8) or not geo.is_contiguous():
        raise ValueError(f"splat_tiles: want contiguous (N, 8) float32 geo, got "
                         f"{tuple(geo.shape)} {geo.dtype}")
    if (colors.dtype not in (torch.float32, torch.bfloat16)
            or colors.shape != (n, CHANNELS) or not colors.is_contiguous()):
        raise ValueError(f"splat_tiles: want contiguous (N, 32) float32 or bfloat16 colors, "
                         f"got {tuple(colors.shape)} {colors.dtype}")
    num_tiles = (size // GTILE_W) * (size // GTILE_H)
    for name, t, length in (("inst", inst, None), ("offsets", offsets, num_tiles + 1)):
        if t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous() or (
                length is not None and t.shape[0] != length):
            raise ValueError(f"splat_tiles: {name} must be contiguous 1-D int32"
                             + (f" of length {length}" if length else ""))
    if any(t.device != dev for t in (colors, inst, offsets)):
        raise ValueError("splat_tiles: all inputs must be on one device")
    if size % GTILE_H or size % GTILE_W:
        raise ValueError(f"size {size} must be a multiple of {GTILE_W}")
    build()
    out = torch.empty((CHANNELS, size, size), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _LIB.artalk_gsplat(geo.data_ptr(), colors.data_ptr(),
                             int(colors.dtype == torch.bfloat16), inst.data_ptr(),
                             offsets.data_ptr(), size, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gsplat kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def block_culling(geo: torch.Tensor, inst: torch.Tensor, offsets: torch.Tensor, size: int,
                  shrink: float = 0.0) -> torch.Tensor:
    """Plain version of the kernel's culling rule (csrc/gsplat.cu:
    reaches_block). Returns keep (P, GTILE_W // BLOCK) bool: may instance i
    pass the alpha cut at any pixel centre of block j (pixels [16 j, 16 j +
    16) of its tile's columns)? alpha >= 1/255 needs opacity >= 1/255 and
    ca dx^2 + 2 cb dx dy + cc dy^2 <= 2 ln(255 opacity), an ellipse inside
    the box |dx| <= sqrt(2 tau cc / det), |dy| <= sqrt(2 tau ca / det), det =
    ca cc - cb^2, widened by the kernel's slack for rounding. Conics that are
    not finite, not positive definite or conditioned beyond 1 / CULL_REL are
    kept. ``shrink`` narrows the box by that many pixels on each side: a
    planted fault, for tests."""
    dev = geo.device
    tiles_x = size // GTILE_W
    tile = torch.repeat_interleave(torch.arange(len(offsets) - 1, device=dev),
                                   offsets.long().diff())
    g = geo[inst.long()]
    mx, my, ca, cb, cc, op = g[:, :6].unbind(-1)
    finite = torch.isfinite(g[:, :6]).all(dim=-1)
    det = ca * cc - cb * cb
    tr = ca + cc
    shaped = (ca > 0) & (cc > 0) & (det > 0) & (CULL_REL * tr * tr <= det)
    eps = torch.tensor(ALPHA_EPS, dtype=torch.float32, device=dev)
    thr = ((2.0 * (torch.log(op) - torch.log(eps)) + CULL_TAU)
           * (1.0 + CULL_REL * tr * tr / det))
    hx = torch.sqrt(thr * cc / det) + CULL_PX - shrink
    hy = torch.sqrt(thr * ca / det) + CULL_PX - shrink
    x0 = ((tile % tiles_x) * GTILE_W).float()[:, None] + BLOCK * torch.arange(
        GTILE_W // BLOCK, device=dev).float()
    y0 = ((tile // tiles_x) * GTILE_H).float()[:, None]
    inside = ((mx[:, None] + hx[:, None] >= x0 + 0.5) & (mx[:, None] - hx[:, None] <= x0 + 15.5)
              & (my[:, None] + hy[:, None] >= y0 + 0.5)
              & (my[:, None] - hy[:, None] <= y0 + 15.5))
    keep = torch.where(shaped[:, None], inside, True)
    return torch.where(finite[:, None], keep & (op >= eps)[:, None], True)


def composite_plain(geo: torch.Tensor, colors: torch.Tensor, inst: torch.Tensor,
                    offsets: torch.Tensor, size: int, keep: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch compositing of the same instance lists. Returns (image
    (32, size, size), evaluated, composited): the (pixel, instance) pairs
    whose alpha was evaluated before the pixel stopped, and those of them
    that added to the pixel (alpha above ALPHA_EPS). With ``keep``
    (``block_culling``'s (P, 8) mask) each 16x16 block composites only its
    culled list: an instance left out of a block's list adds nothing there
    and leaves T as it was, as if its alpha were 0, and is not counted as
    evaluated."""
    dev = geo.device
    tiles_x = size // GTILE_W
    num_tiles = tiles_x * (size // GTILE_H)
    pidx = torch.arange(GTILE_H * GTILE_W, device=dev)
    ly = (pidx // GTILE_W).float()
    lx = (pidx % GTILE_W).float()
    pblock = pidx % GTILE_W // BLOCK
    out = torch.zeros((num_tiles, GTILE_H * GTILE_W, CHANNELS), device=dev)
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    composited = torch.zeros((), dtype=torch.int64, device=dev)
    bounds = offsets.tolist()
    for tile in range(num_tiles):
        start, end = bounds[tile], bounds[tile + 1]
        if start == end:
            continue
        px = ((tile % tiles_x) * GTILE_W + lx + 0.5)[:, None]
        py = ((tile // tiles_x) * GTILE_H + ly + 0.5)[:, None]
        color = out[tile]
        t = torch.ones((GTILE_H * GTILE_W, 1), device=dev)
        for c0 in range(start, end, _PLAIN_CHUNK):
            idx = inst[c0:min(c0 + _PLAIN_CHUNK, end)].long()
            g = geo[idx]
            dx = px - g[:, 0]
            dy = py - g[:, 1]
            power = -0.5 * (g[:, 2] * dx * dx + g[:, 4] * dy * dy) - g[:, 3] * dx * dy
            alpha = torch.clamp(g[:, 5] * torch.exp(power), max=0.99)
            alpha = torch.where((power > 0) | (alpha < ALPHA_EPS), 0.0, alpha)
            kept = None if keep is None else keep[c0:c0 + len(idx)].T[pblock]
            if kept is not None:
                alpha = torch.where(kept, alpha, 0.0)
            # transmittance before each instance: T times the exclusive cumprod
            trans = torch.cumprod(1.0 - alpha, dim=1)
            before = t * torch.cat([torch.ones_like(t), trans[:, :-1]], dim=1)
            live = before > T_EPS            # a pixel stops once its T <= T_EPS
            weight = torch.where(live, alpha * before, 0.0)
            color += weight @ colors[idx].float()
            evaluated += (live if kept is None else live & kept).sum()
            composited += (live & (alpha > 0)).sum()
            t = t * trans[:, -1:]
            if not bool((t > T_EPS).any()):
                break
    image = out.reshape(size // GTILE_H, tiles_x, GTILE_H, GTILE_W, CHANNELS)
    return image.permute(4, 0, 2, 1, 3).reshape(CHANNELS, size, size), evaluated, composited


def splat_tiles_plain(geo, colors, inst, offsets, size: int) -> torch.Tensor:
    """Plain-torch version of ``splat_tiles`` (same function)."""
    return composite_plain(geo, colors, inst, offsets, size)[0]


def rasterize_gaussians(xyz, colors, opacities, scales, rotations, cam_matrix,
                        focal: float = 12.0, size: int = 512,
                        bf16_colors: bool = False) -> torch.Tensor:
    """Tiled gaussian rasterization of one scene -> (32, size, size) float32.

    xyz (N, 3), colors (N, 32), opacities (N, 1), scales (N, 3), rotations
    (N, 4) (w, x, y, z), cam_matrix (3, 4). Front-to-back per tile in depth
    order, alpha threshold 1/255, per-pixel stop at T <= T_EPS, black
    background. ``bf16_colors`` stores the colors in bfloat16 (products and
    sums stay float32). CUDA tensors go through the kernel, CPU tensors
    through ``rasterize_gaussians_plain``."""
    dev = xyz.device
    if dev.type == "cpu":
        return rasterize_gaussians_plain(xyz, colors, opacities, scales, rotations, cam_matrix,
                                         focal, size, bf16_colors)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_gaussians: unsupported device {dev}")
    return splat_tiles(*prepass(xyz, colors, opacities, scales, rotations, cam_matrix, focal,
                                size, bf16_colors), size)


def rasterize_gaussians_plain(xyz, colors, opacities, scales, rotations, cam_matrix,
                              focal: float = 12.0, size: int = 512,
                              bf16_colors: bool = False) -> torch.Tensor:
    """Plain-torch version of ``rasterize_gaussians`` (same prepass)."""
    return splat_tiles_plain(*prepass(xyz, colors, opacities, scales, rotations, cam_matrix,
                                      focal, size, bf16_colors), size)
