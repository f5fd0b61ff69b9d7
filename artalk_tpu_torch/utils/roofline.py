"""Work models of the card's kernels, the H100's peaks, and ``count``.

Counterpart of ``artalk_tpu/utils/roofline.py``. There XLA's cost model
counted a Pallas call as zero FLOPs; here ``torch.utils.flop_counter`` sees
aten ops only, and every kernel of ``ops/`` launches through ctypes, so it
sees none of them. Each kernel's work is therefore computed from its shapes
(and, where the work depends on the data, from the data's own counts):

- ``ar_level_work``: one launch of the AR block stack (one scale level, B = 1);
- ``encoder_window_work``: one launch of the encoder block stack (one window);
- ``conv_frontend_work``: the wav2vec2 conv front's eight launches;
- ``flash_work``: one flash-attention call;
- ``splat_work``: one splat of a frame's instance lists;
- ``rasterize_work``: one mesh z-buffer frame (``coverage_tests`` counts the
  frame's tests);
- ``sort_work``: one sort of the instance keys.

Each returns a ``Work`` (FLOPs, bytes): each input read once and each output
written once, and the operations the function needs. ``chip_smoke.py`` turns
them into each kernel's bound (``bytes_ms``, ``matmul_ms``, ``fp32_ms``,
``flash_bound``); ``bench.py``'s utilization keys add them, per launch, to
what ``count`` measures over the aten ops.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..ops._nvcc import launches

HBM_BYTES_PER_S = 3.35e12    # HBM3
FP32_FLOP_PER_S = 67e12      # fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12     # TF32 tensor cores, dense
BF16_FLOP_PER_S = 989e12     # bf16 tensor cores, dense

# operations the splat needs for each (pixel, gaussian) pair it composites
# before the pixel stops, i.e. whose alpha passes 1/255 (ops/gsplat.py): the
# alpha evaluation (dx, dy, the conic's quadratic form, exp, opacity, min:
# 14 FLOP) and the composite (w = alpha T, 32 fused multiply-adds,
# T *= 1 - alpha: 67 FLOP). Pairs whose alpha falls below the cut are left
# out: a cull per pixel block could rule most of them out cheaply.
SPLAT_EVAL_FLOP = 14
SPLAT_COMPOSITE_FLOP = 67
# a coverage test of the z-buffer: three planes of 2 mul + 2 add, and w0 + w1
RASTER_TEST_FLOP = 13


@dataclasses.dataclass(frozen=True)
class Work:
    """FLOPs and bytes of some work; sums and integer multiples add up."""

    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)


def bytes_ms(nbytes: float) -> float:
    """ms to move ``nbytes`` at the HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def fp32_ms(flops: float) -> float:
    """ms of ``flops`` at the fp32 rate (outside the tensor cores)."""
    return flops / FP32_FLOP_PER_S * 1e3


def matmul_ms(flops: float, dtype: torch.dtype) -> float:
    """ms of ``flops`` of matrix products at the cheapest rate that keeps the
    precision of weights in ``dtype``: float32 as three TF32 products at
    495 TFLOP/s or one fp32 product at 67, whichever takes less (3xTF32);
    bf16 and int8 weights (bf16 operands) at the bf16 tensor-core rate."""
    if dtype == torch.float32:
        return min(3 * flops / TF32_FLOP_PER_S * 1e3, fp32_ms(flops))
    return flops / BF16_FLOP_PER_S * 1e3


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def pack_bytes(depth: int, d: int, hidden: int, dtype: torch.dtype, floats: int) -> int:
    """Bytes of a block-stack weight pack: per layer the (d, 3d), (d, d),
    (d, hidden) and (hidden, d) weights in ``dtype``, ``floats`` float32
    values (biases, LayerNorm rows, query scales) and, for int8, the float32
    scales of each d-deep chunk of each output column."""
    weights = depth * (4 * d * d + 2 * d * hidden)
    scales = depth * (4 * d + 2 * hidden) * 4 if dtype == torch.int8 else 0
    return weights * _itemsize(dtype) + depth * floats * 4 + scales


def ar_level_work(depth: int, d: int, hidden: int, num_heads: int, pn: int, start: int,
                  dtype: torch.dtype, cache_bytes: int) -> Work:
    """One AR block-stack launch (one scale level of ``pn`` tokens at B = 1,
    ``start`` cached keys before them): the pack (weights in ``dtype``;
    q/k/v, proj, fc1 and fc2 biases and the per-head query scales in
    float32), the tokens, the AdaLN rows and the cache prefix read once, the
    features and the level's k/v (``cache_bytes`` a value) written once;
    2 FLOP per weight per token, and q.k^T and P.V over ``start + pn`` keys."""
    weights = depth * (4 * d * d + 2 * d * hidden)
    moved = pack_bytes(depth, d, hidden, dtype, 5 * d + hidden + num_heads)
    moved += pn * d * 4 + depth * pn * 6 * d * 4 + 2 * depth * start * d * cache_bytes
    moved += pn * d * 4 + 2 * depth * pn * d * cache_bytes
    flops = 2 * weights * pn + depth * 2 * 2 * pn * (start + pn) * d
    return Work(flops, moved)


def encoder_window_work(depth: int, d: int, hidden: int, frames: int,
                        dtype: torch.dtype) -> Work:
    """One encoder block-stack launch (one window of ``frames`` tokens): the
    pack (weights in ``dtype``; biases and LayerNorm rows in float32) and the
    float32 tokens read once, the tokens written once; 2 FLOP per weight per
    token, and q.k^T and P.V over the window."""
    weights = depth * (4 * d * d + 2 * d * hidden)
    moved = pack_bytes(depth, d, hidden, dtype, 9 * d + hidden) + 2 * frames * d * 4
    flops = 2 * weights * frames + depth * 2 * 2 * frames * frames * d
    return Work(flops, moved)


def conv_frontend_work(cfg, samples: int, rows: int) -> Work:
    """The wav2vec2 conv front of ``rows`` windows of ``samples``, as the
    eight launches of ``ops/conv_frontend.py`` run it in bf16: each launch
    reads its input once (the audio, a conv's output, the projected features
    with their residual) and its weights, biases and LayerNorm rows once,
    and writes its output once; 2 FLOP per weight per output step."""
    t, moved, flops = samples, 0, 0
    c_in = 1
    for c, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        moved += rows * t * c_in * 2
        t = (t - k) // s + 1
        flops += 2 * rows * t * c * c_in * k
        moved += rows * t * c * 2 + (c * c_in * k + 3 * c) * 2
        c_in = c
    d, k = cfg.hidden_size, cfg.num_conv_pos_embeddings
    flops += 2 * rows * t * d * (d // cfg.num_conv_pos_embedding_groups) * k
    moved += 2 * rows * t * d * 2 + (d * (d // cfg.num_conv_pos_embedding_groups) * k + d) * 2
    return Work(flops, moved)


def flash_work(b: int, h: int, lq: int, lk: int, hd: int, dtype: torch.dtype) -> Work:
    """One flash-attention call: q, k, v read once, the output written once;
    the two products q.k^T and P.V, 2 * B * H * Lq * Lk * hd FLOP each."""
    moved = (2 * b * h * lq * hd + 2 * b * h * lk * hd) * _itemsize(dtype)
    return Work(2 * (2 * b * h * lq * lk * hd), moved)


def flash_bound(b: int, h: int, lq: int, lk: int, hd: int,
                dtype: torch.dtype) -> Tuple[float, float]:
    """(bytes ms, operations ms) of one flash call, each product at the rate
    of the cheapest instruction sequence that keeps the function's
    precision. bf16 inputs: q.k^T is one bf16 tensor-core product (bf16 x
    bf16 is exact in float32); P.V takes p in float32, kept to 16 bits as
    bf16 hi + lo, so two bf16 products; all at 989 TFLOP/s. float32 inputs:
    three TF32 products per product (hi.hi, hi.lo, lo.hi) at 495 TFLOP/s, or
    one at the 67 TFLOP/s fp32 rate, whichever takes less time."""
    work = flash_work(b, h, lq, lk, hd, dtype)
    product = work.flops / 2
    if dtype == torch.bfloat16:
        ops_s = 3 * product / BF16_FLOP_PER_S
    else:
        ops_s = 2 * min(3 * product / TF32_FLOP_PER_S, product / FP32_FLOP_PER_S)
    return bytes_ms(work.bytes), ops_s * 1e3


def splat_work(num_gaussians: int, color_bytes: int, num_instances: int, num_offsets: int,
               size: int, composites: int) -> Work:
    """One splat of a frame: the gaussians' 6 geometry floats and 32 colors
    (``color_bytes`` each), the instance list and the tile offsets read
    once, the (32, size, size) float32 image written once; the alpha
    evaluation and the composite of each of the ``composites`` (pixel,
    instance) pairs whose alpha passes the cut before the pixel stops
    (``gsplat.composite_plain`` counts them)."""
    moved = (num_gaussians * (6 * 4 + 32 * color_bytes) + num_instances * 4
             + num_offsets * 4 + 32 * size * size * 4)
    return Work(composites * (SPLAT_EVAL_FLOP + SPLAT_COMPOSITE_FLOP), moved)


def coverage_tests(verts_screen: torch.Tensor, faces: torch.Tensor, height: int,
                   width: int) -> int:
    """The coverage tests one frame's z-buffer needs: each face against the
    pixel centres of its own bounding box, clipped to the image."""
    tri = verts_screen[faces.long()]                                  # (F, 3, 3)
    lo = torch.ceil(tri[..., :2].amin(1) - 0.5).clamp(min=0)
    hi = torch.minimum(torch.floor(tri[..., :2].amax(1) - 0.5),
                       tri.new_tensor([width - 1, height - 1]))
    return int((hi - lo + 1).clamp(min=0).prod(1).sum())


def rasterize_work(num_verts: int, num_faces: int, face_bytes: int, height: int, width: int,
                   tests: float) -> Work:
    """One z-buffer frame: the screen-space vertices (3 float32) and the
    faces (3 indices of ``face_bytes``) read once, 8 bytes a pixel (depth,
    face id) written once; ``tests`` coverage tests (``coverage_tests``)."""
    moved = num_verts * 3 * 4 + num_faces * 3 * face_bytes + height * width * 8
    return Work(tests * RASTER_TEST_FLOP, moved)


def sort_work(n: int) -> Work:
    """One sort of ``n`` int32 keys: each read once and written once."""
    return Work(0.0, 8 * n)


# ops that only allocate: they move no bytes
_ALLOCATIONS = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}


class _BytesMode(TorchDispatchMode):
    """Adds up the bytes of every aten op's tensor operands and results (an
    in-place op's tensor counts as read and written); views and bare
    allocations move nothing and count nothing."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _ALLOCATIONS:
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_flatten((args, kwargs, out))[0]
                              if isinstance(t, torch.Tensor))
        return out


def count(fn: Callable[[], object],
          kernels: Optional[Mapping[str, Tuple[int, Work]]] = None) -> Work:
    """Run ``fn()`` once and return its work: the FLOPs that
    ``FlopCounterMode`` counts over its aten ops, and the bytes of their
    operands and results (the eager counterpart of XLA's "bytes accessed"),
    plus the declared kernel launches' work. ``kernels`` maps a kernel's
    name in ``ops._nvcc.launches()`` to (launches, their total work); every
    kernel left out is declared at 0 launches. Raises RuntimeError when a
    kernel's launch count differs from what was declared: a kernel that
    quietly fell back to its plain version would otherwise shrink the count
    unnoticed."""
    kernels = kernels or {}
    before = launches()
    known = [name for name in before if "/" not in name]
    unknown = set(kernels) - set(known)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}; known: {sorted(known)}")
    flops, nbytes = FlopCounterMode(display=False), _BytesMode()
    with flops, nbytes:
        fn()
    after = launches()
    launched = {name: after[name] - before[name] for name in known}
    declared = {name: kernels[name][0] if name in kernels else 0 for name in known}
    if launched != declared:
        raise RuntimeError(f"kernel launches {launched}, declared {declared}")
    return sum((work for _, work in kernels.values()),
               Work(float(flops.get_total_flops()), float(nbytes.total)))
