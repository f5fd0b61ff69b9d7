"""Exact 1-D resampling as constant matrices.

Counterpart of ``artalk_tpu/ops/resample1d.py``: ``F.interpolate`` in
``mode='area'`` and ``mode='linear'`` (align_corners=False) at fixed sizes,
each expressed as one ``(out, in)`` matrix built in float64, rounded to
float32, and applied as a float32 matmul. These matmuls decide BSQ signs and
greedy bits, so they must run in full float32: the engine turns TF32 off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def area_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Matrix M (out_size, in_size) equivalent to F.interpolate(mode='area').

    Output j averages input bins [floor(j*i/o), ceil((j+1)*i/o)).
    """
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for j in range(out_size):
        start = int(np.floor(j * in_size / out_size))
        end = int(np.ceil((j + 1) * in_size / out_size))
        m[j, start:end] = 1.0 / (end - start)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Matrix M (out_size, in_size) equivalent to F.interpolate(mode='linear').

    Output j samples the input at (j + 0.5) * in/out - 0.5, interpolating
    linearly between the two neighbours with edge clamping.
    """
    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for j in range(out_size):
        pos = (j + 0.5) * scale - 0.5
        pos = min(max(pos, 0.0), in_size - 1.0)
        lo = int(np.floor(pos))
        hi = min(lo + 1, in_size - 1)
        w_hi = pos - lo
        m[j, lo] += 1.0 - w_hi
        m[j, hi] += w_hi
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _matrix(kind: str, in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    build = area_resize_matrix if kind == "area" else linear_resize_matrix
    return torch.from_numpy(build(in_size, out_size)).to(device)


def resize_area(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Area-resize along axis -2 of a (..., T, C) tensor."""
    in_size = x.shape[-2]
    if in_size == out_size:
        return x
    return torch.matmul(_matrix("area", in_size, out_size, x.device), x)


def resize_linear(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Linear-resize along axis -2 of a (..., T, C) tensor."""
    in_size = x.shape[-2]
    if in_size == out_size:
        return x
    return torch.matmul(_matrix("linear", in_size, out_size, x.device), x)
