"""Savitzky-Golay smoothing as a constant matrix multiply.

Counterpart of ``artalk_tpu/ops/savgol.py``: ``scipy.signal.savgol_filter``
with its default ``mode='interp'`` edges (a polynomial fit over the first and
last window), precomputed as a (T, T) matrix and applied on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def savgol_coeffs(window_length: int, polyorder: int) -> np.ndarray:
    """FIR coefficients of the central tap: a least-squares polynomial fit over
    positions [-half, half], evaluated at 0 (scipy's savgol_coeffs, use='dot')."""
    half = window_length // 2
    pos = np.arange(-half, half + 1, dtype=np.float64)
    vander = np.vander(pos, polyorder + 1, increasing=True)
    return np.linalg.pinv(vander)[0]


@functools.lru_cache(maxsize=None)
def savgol_matrix(n: int, window_length: int, polyorder: int) -> np.ndarray:
    """Full (n, n) smoothing matrix equivalent to savgol_filter(mode='interp')."""
    assert n >= window_length, f"sequence length {n} < window {window_length}"
    half = window_length // 2
    coeffs = savgol_coeffs(window_length, polyorder)
    m = np.zeros((n, n), dtype=np.float64)
    for t in range(half, n - half):
        m[t, t - half : t + half + 1] = coeffs
    pos = np.arange(window_length, dtype=np.float64)
    fit = np.linalg.pinv(np.vander(pos, polyorder + 1, increasing=True))  # (P+1, W)
    eval_head = np.vander(np.arange(half, dtype=np.float64), polyorder + 1, increasing=True)
    m[:half, :window_length] = eval_head @ fit
    eval_tail = np.vander(
        np.arange(window_length - half, window_length, dtype=np.float64),
        polyorder + 1,
        increasing=True,
    )
    m[n - half :, n - window_length :] = eval_tail @ fit
    return m.astype(np.float32)


def savgol_smooth(x: torch.Tensor, window_length: int, polyorder: int) -> torch.Tensor:
    """Smooth along axis -2 of a (..., T, C) tensor.

    Sequences shorter than the window shrink it to the largest odd length that
    fits (identity for T < 3), as the JAX package does.
    """
    n = x.shape[-2]
    if n < window_length:
        window_length = n if n % 2 == 1 else n - 1
        polyorder = min(polyorder, max(window_length - 1, 0))
        if window_length < 3:
            return x
    m = torch.from_numpy(savgol_matrix(n, window_length, polyorder)).to(x.device)
    return torch.matmul(m, x)


def smooth_motion_savgol(motion: torch.Tensor) -> torch.Tensor:
    """Reference motion smoothing: window 5 / order 2 on all 106 dims, window
    9 / order 3 recomputed from the raw motion on the rotation dims 100:103."""
    smoothed = savgol_smooth(motion, 5, 2)
    rot = savgol_smooth(motion[..., 100:103], 9, 3)
    return torch.cat([smoothed[..., :100], rot, smoothed[..., 103:]], dim=-1)
