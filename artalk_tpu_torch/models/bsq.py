"""Binary Spherical Quantization (BSQ) and its multi-scale residual pyramid.

Counterpart of ``artalk_tpu/models/bsq.py`` (inference only): latents are
L2-normalized and binarized per dimension to +/- 1/sqrt(C) over the fixed
scale schedule (1, 5, 25, 50, 100), area-downsampling residuals and linearly
upsampling quantized values with the exact resize matrices.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.resample1d import resize_area, resize_linear
from .nn import l2_normalize


def bsq_quantize(z: torch.Tensor, code_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binarize a latent; returns (quantized, bits int32 in {0, 1}).

    ``quantized`` is computed as ``z + (hard - z)``, the forward value of the
    JAX straight-through estimator, which may differ from ``hard`` in the
    last bit and feeds the residual pyramid."""
    z = l2_normalize(z, dim=-1)
    q_scale = 1.0 / (code_dim ** 0.5)
    hard = torch.where(z > 0, q_scale, -q_scale).to(z.dtype)
    quantized = z + (hard - z)
    bits = (hard > 0).to(torch.int32)
    return quantized, bits


def bits_to_values(bits: torch.Tensor, code_dim: int) -> torch.Tensor:
    """{0,1} bits -> +/- 1/sqrt(code_dim) sphere values."""
    return (bits.float() * 2.0 - 1.0) / (code_dim ** 0.5)


class MultiScaleBSQ:
    """Multi-scale residual BSQ over a fixed scale schedule (no parameters)."""

    def __init__(self, code_dim: int = 32, scale_schedule: Sequence[int] = (1, 5, 25, 50, 100)):
        self.code_dim = code_dim
        self.scale_schedule = tuple(scale_schedule)
        self.num_levels = len(self.scale_schedule)
        self.total_tokens = sum(self.scale_schedule)

    def encode(self, f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantize (B, T, C) features -> (quantized_out (B, T, C),
        bits (B, sum(schedule), C))."""
        t = f.shape[-2]
        assert t == self.scale_schedule[-1], f"expected T={self.scale_schedule[-1]}, got {t}"
        residual = f
        quantized_out = torch.zeros_like(f)
        all_bits = []
        for pt in self.scale_schedule:
            q, bits = bsq_quantize(resize_area(residual, pt), self.code_dim)
            q_up = resize_linear(q, t)
            residual = residual - q_up
            quantized_out = quantized_out + q_up
            all_bits.append(bits)
        return quantized_out, torch.cat(all_bits, dim=-2)

    def _split_levels(self, bits: torch.Tensor) -> list:
        out, start = [], 0
        for pt in self.scale_schedule:
            out.append(bits[..., start : start + pt, :])
            start += pt
        return out

    def bits_to_feat(self, bits: torch.Tensor) -> torch.Tensor:
        """Final (B, T, C) feature from all-level bits."""
        t = self.scale_schedule[-1]
        f_hat = torch.zeros(bits.shape[:-2] + (t, self.code_dim), device=bits.device)
        for lvl, lvl_bits in enumerate(self._split_levels(bits)):
            vals = bits_to_values(lvl_bits, self.code_dim)
            f_hat = f_hat + (resize_linear(vals, t) if lvl < self.num_levels - 1 else vals)
        return f_hat

    def bits_to_ms_feat(self, bits: torch.Tensor) -> torch.Tensor:
        """Per-scale AR inputs (B, sum(schedule[1:]), C): for each level l <
        last, the reconstruction through level l area-resized to schedule[l+1]."""
        t = self.scale_schedule[-1]
        levels = self._split_levels(bits)
        f_hat = torch.zeros(bits.shape[:-2] + (t, self.code_dim), device=bits.device)
        next_scales = []
        for lvl in range(self.num_levels - 1):
            f_hat = f_hat + resize_linear(bits_to_values(levels[lvl], self.code_dim), t)
            next_scales.append(resize_area(f_hat, self.scale_schedule[lvl + 1]))
        return torch.cat(next_scales, dim=-2)
