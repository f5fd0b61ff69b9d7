"""2-D bilinear resizing as separable constant matrices.

Counterpart of ``artalk_tpu/ops/resize2d.py``. The GAGAvatar stack uses three
resize flavours, all at fixed sizes:

- ``F.interpolate(mode='bilinear', align_corners=False)`` (StyleUNet up/down),
- ``align_corners=True`` (the DPT fusion blocks),
- an antialiased resize (image preprocessing and the watermark).

The first two are exact separable float32 matrix products,
``out = My @ img @ Mx^T``, with the matrices built as the JAX package builds
them. The third is ``F.interpolate(..., antialias=True)``, which computes the
same triangle-filter weights as ``jax.image.resize(..., antialias=True)``
(``tests/test_torch_gagavatar.py`` pins the agreement).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .resample1d import linear_resize_matrix


@functools.lru_cache(maxsize=None)
def linear_resize_matrix_align(in_size: int, out_size: int) -> np.ndarray:
    """1-D linear interpolation matrix with align_corners=True semantics."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == 1:
        m[0, 0] = 1.0
        return m.astype(np.float32)
    scale = (in_size - 1) / (out_size - 1)
    for j in range(out_size):
        pos = j * scale
        lo = int(np.floor(pos))
        hi = min(lo + 1, in_size - 1)
        w = pos - lo
        m[j, lo] += 1.0 - w
        m[j, hi] += w
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _matrix(align_corners: bool, in_size: int, out_size: int,
            device: torch.device) -> torch.Tensor:
    build = linear_resize_matrix_align if align_corners else linear_resize_matrix
    return torch.from_numpy(build(in_size, out_size)).to(device)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """(..., C, H, W) -> (..., C, out_h, out_w), torch bilinear semantics.

    The float32 matrices promote the input as JAX's einsum does, so a
    bfloat16 input comes back float32 (callers cast)."""
    h, w = x.shape[-2], x.shape[-1]
    if h == out_h and w == out_w:
        return x
    my = _matrix(align_corners, h, out_h, x.device)
    mx = _matrix(align_corners, w, out_w, x.device)
    return torch.matmul(torch.matmul(my, x.float()), mx.T)


def resize_bilinear_nhwc(x: torch.Tensor, out_h: int, out_w: int,
                         align_corners: bool = False) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C); the matrices of
    ``resize_bilinear`` applied to the channels-last layout."""
    h, w = x.shape[1], x.shape[2]
    if h == out_h and w == out_w:
        return x
    my = _matrix(align_corners, h, out_h, x.device)
    mx = _matrix(align_corners, w, out_w, x.device)
    x = torch.einsum("oh,bhwc->bowc", my, x.float())
    return torch.einsum("pw,bowc->bopc", mx, x)


def resize_antialias(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of the last two axes of (..., H, W)."""
    lead = x.shape[:-2]
    flat = x.reshape((1, -1) + tuple(x.shape[-2:]))
    out = F.interpolate(flat, size=(out_h, out_w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(lead + (out_h, out_w))
