"""Binary Spherical Quantization (BSQ) and its multi-scale residual pyramid.

Counterpart of ``artalk_tpu/models/bsq.py``: latents are L2-normalized and
binarized per dimension to +/- 1/sqrt(C) over the fixed scale schedule
(1, 5, 25, 50, 100), area-downsampling residuals and linearly upsampling
quantized values with the exact resize matrices. The quantizer is a
straight-through estimator, so the training losses (``bsq_entropy_loss``,
``MultiScaleBSQ.encode_with_losses``) differentiate through it as JAX does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.resample1d import resize_area, resize_linear
from ..parallel.sharding import whole
from .nn import l2_normalize


def bsq_quantize(z: torch.Tensor, code_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binarize a latent; returns (quantized, bits int32 in {0, 1}).

    ``quantized`` is the straight-through estimator ``z + detach(hard - z)``
    of the JAX package: its value (which may differ from ``hard`` in the last
    bit, and feeds the residual pyramid) is ``hard``'s, its gradient the
    identity's."""
    z = l2_normalize(z, dim=-1)
    q_scale = 1.0 / (code_dim ** 0.5)
    hard = torch.where(z > 0, q_scale, -q_scale).to(z.dtype)
    quantized = z + (hard - z).detach()
    bits = (hard > 0).to(torch.int32)
    return quantized, bits


def bits_to_values(bits: torch.Tensor, code_dim: int) -> torch.Tensor:
    """{0,1} bits -> +/- 1/sqrt(code_dim) sphere values."""
    return (bits.float() * 2.0 - 1.0) / (code_dim ** 0.5)


class _GroupSum(torch.autograd.Function):
    """Sum of a plain tensor over a process group; the backward sums the
    gradient over the group too (a DTensor gradient, from a tensor-parallel
    model's ops downstream, taken whole)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = whole(grad).clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def bsq_entropy_loss(z: torch.Tensor, code_dim: int, inv_temperature: float = 100.0,
                     dp_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample and codebook soft entropy of the binary codes (training
    aux): a sigmoid relaxation of each bit's probability. Returns
    (per_sample_entropy, codebook_entropy). With ``dp_group`` z holds this
    rank's rows of a global batch split evenly over the group: the codebook's
    mean probability is the global batch's (an all-reduce whose backward
    all-reduces the gradient, so that the ranks' gradients, averaged, are
    the global batch's)."""
    p = torch.sigmoid(-4.0 * z / (code_dim ** 0.5) * inv_temperature)
    prob = torch.stack([p, 1.0 - p], dim=-1)  # (..., C, 2)

    def entropy(c: torch.Tensor, dim: int) -> torch.Tensor:
        return -torch.sum(c * torch.log(c + 1e-8), dim=dim)

    per_sample = torch.mean(torch.sum(entropy(prob, -1), dim=-1))
    lead = tuple(range(prob.ndim - 2))  # torch.mean over dim=() would reduce every axis
    avg_prob = torch.mean(prob, dim=lead) if lead else prob  # (C, 2)
    if dp_group is not None:
        avg_prob = _GroupSum.apply(whole(avg_prob), dp_group) / dist.get_world_size(dp_group)
    return per_sample, torch.sum(entropy(avg_prob, -1))


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
            residual = residual - q_up.detach()
            quantized_out = quantized_out + q_up
            all_bits.append(bits)
        return quantized_out, torch.cat(all_bits, dim=-2)

    def encode_with_losses(self, f: torch.Tensor, dp_group=None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``encode`` plus the per-level BSQ aux losses (training path):
        (quantized_out, bits, aux_losses (num_levels,)), each level's loss
        the entropy penalty times 0.1 plus the commit term (against the
        detached quantized value) times 0.2, at inverse temperature 100.
        ``dp_group``: f holds this rank's rows of a global batch, and the
        codebook entropy is the global batch's (``bsq_entropy_loss``)."""
        inv_temperature, entropy_w, commit_w = 100.0, 0.1, 0.2
        t = f.shape[-2]
        residual = f
        quantized_out = torch.zeros_like(f)
        all_bits, all_losses = [], []
        for pt in self.scale_schedule:
            r_down = resize_area(residual, pt)
            z = l2_normalize(r_down, dim=-1)
            q, bits = bsq_quantize(r_down, self.code_dim)
            per_sample, codebook = bsq_entropy_loss(z, self.code_dim, inv_temperature,
                                                    dp_group)
            entropy_penalty = (per_sample - codebook) / inv_temperature
            commit = torch.mean(torch.sum((q.detach() - z) ** 2, dim=-1))
            all_losses.append(entropy_penalty * entropy_w + commit * commit_w)
            q_up = resize_linear(q, t)
            residual = residual - q_up.detach()
            quantized_out = quantized_out + q_up
            all_bits.append(bits)
        return quantized_out, torch.cat(all_bits, dim=-2), torch.stack(all_losses)

    def encode_with_flips(self, f: torch.Tensor, flip_ratio: float,
                          generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode with each bit flipped with probability ``flip_ratio``
        (training-time robustness augmentation). The flips draw from
        ``generator`` (on ``f``'s device), one draw per level in order; JAX
        splits a key per level, so the draws are not JAX's."""
        t = f.shape[-2]
        residual = f
        quantized_out = torch.zeros_like(f)
        all_bits = []
        for pt in self.scale_schedule:
            _, bits = bsq_quantize(resize_area(residual, pt), self.code_dim)
            flip = torch.rand(bits.shape, generator=generator, device=bits.device) < flip_ratio
            bits = torch.where(flip, 1 - bits, bits)
            q_up = resize_linear(bits_to_values(bits, self.code_dim), t)
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
        return self.bits_to_ar_feat(self.num_levels - 2, bits)

    def bits_to_ar_feat(self, this_level: int, bits: torch.Tensor) -> torch.Tensor:
        """Next-level AR inputs during decode: ``bits`` covers levels
        0..this_level (sum(schedule[:this_level + 1]) tokens); returns the
        concatenated inputs for levels 1..this_level + 1, each the
        reconstruction through the level before it area-resized to its
        scale (the decode loop in ``ar_model`` keeps the same sum as it goes)."""
        t = self.scale_schedule[-1]
        f_hat = torch.zeros(bits.shape[:-2] + (t, self.code_dim), device=bits.device)
        next_scales = []
        for lvl, lvl_bits in enumerate(self._split_levels(bits)[: this_level + 1]):
            f_hat = f_hat + resize_linear(bits_to_values(lvl_bits, self.code_dim), t)
            next_scales.append(resize_area(f_hat, self.scale_schedule[lvl + 1]))
        return torch.cat(next_scales, dim=-2)
