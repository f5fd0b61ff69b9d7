"""BITWISE_VAE: transformer motion tokenizer with multi-scale BSQ codes.

Counterpart of ``artalk_tpu/models/bitwise_vae.py``. It works on the
two-window layout ``[prev_window, this_window]`` with a block mask: the
previous window attends only to itself, the current window to both. The
reference's tower quirks are kept: the attention scale is hidden_dim**-0.5
(not head_dim), and the FFN residual has no pre-norm.

``motion_mean`` and ``motion_std`` are parameters, as they are leaves of the
JAX parameter tree: stage-1 training (``reconstruct``) updates and decays
them as it does every other leaf.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import VAEConfig
from . import nn as tnn
from .bsq import MultiScaleBSQ
from .data_stats import ALLTALKEMICA_MEAN, ALLTALKEMICA_STD


class _Attn(nn.Module):
    def __init__(self, hidden: int, depth: int):
        super().__init__()
        self.norm = tnn.LayerNorm(hidden, eps=1e-5, stack=(depth,))
        self.qkv = tnn.Linear(hidden, 3 * hidden, bias=False, stack=(depth,))
        self.out = tnn.Linear(hidden, hidden, stack=(depth,))


class _FFN(nn.Module):
    def __init__(self, hidden: int, depth: int):
        super().__init__()
        inner = int(1.5 * hidden)
        self.fc1 = tnn.Linear(hidden, inner, stack=(depth,))
        self.fc2 = tnn.Linear(inner, hidden, stack=(depth,))


class _Tower(nn.Module):
    """Residual attn+ffn tower over parameter-stacked layers."""

    def __init__(self, hidden: int, depth: int, num_heads: int):
        super().__init__()
        self.depth, self.num_heads = depth, num_heads
        self.attn = _Attn(hidden, depth)
        self.ffn = _FFN(hidden, depth)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        hidden = x.shape[-1]
        for i in range(self.depth):
            qkv = self.attn.qkv(self.attn.norm(x, i), i)
            q, k, v = (tnn.split_heads(t, self.num_heads) for t in qkv.chunk(3, dim=-1))
            out = tnn.sdpa(q, k, v, scale=hidden ** -0.5, bias=bias)
            x = x + self.attn.out(tnn.merge_heads(out), i)
            x = x + self.ffn.fc2(tnn.gelu_tanh(self.ffn.fc1(x, i)), i)
        return x

    def init(self, gen: torch.Generator) -> None:
        for lin in (self.attn.qkv, self.attn.out, self.ffn.fc1, self.ffn.fc2):
            tnn.linear_init(lin, gen)


class _Coder(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out_dim: int, depth: int, num_heads: int):
        super().__init__()
        self.inp = tnn.Linear(in_dim, hidden)
        self.layers = _Tower(hidden, depth, num_heads)
        self.out = tnn.Linear(hidden, out_dim)


class BitwiseVAE(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.quantizer = MultiScaleBSQ(cfg.code_dim, cfg.patch_nums)
        self.window = cfg.window
        h = cfg.hidden_dim
        self.encoder = _Coder(cfg.motion_dim, h, cfg.code_dim, cfg.depth, cfg.num_heads)
        self.decoder = _Coder(cfg.code_dim, h, cfg.motion_dim, cfg.depth, cfg.num_heads)
        self.enc_pos_embed = nn.Parameter(torch.empty(1, 2 * self.window, cfg.motion_dim))
        self.dec_pos_embed = nn.Parameter(torch.empty(1, 2 * self.window, cfg.code_dim))
        if cfg.motion_dim == ALLTALKEMICA_MEAN.shape[0]:
            mean, std = torch.from_numpy(ALLTALKEMICA_MEAN), torch.from_numpy(ALLTALKEMICA_STD)
        else:  # non-standard motion dim (tests / custom datasets): identity stats
            mean, std = torch.zeros(cfg.motion_dim), torch.ones(cfg.motion_dim)
        self.motion_mean = nn.Parameter(mean.clone())
        self.motion_std = nn.Parameter(std.clone())

    def init(self, gen: torch.Generator) -> "BitwiseVAE":
        cfg = self.cfg
        for coder in (self.encoder, self.decoder):
            tnn.linear_init(coder.inp, gen)
            coder.layers.init(gen)
        tnn.linear_init(self.encoder.out, gen)
        tnn.linear_init(self.decoder.out, gen, w_init=lambda t, g: tnn.xavier_uniform(
            t, cfg.hidden_dim, cfg.motion_dim, g, gain=0.05))
        tnn.trunc_normal(self.enc_pos_embed.data, gen, std=math.sqrt(1 / cfg.motion_dim / 3))
        tnn.trunc_normal(self.dec_pos_embed.data, gen, std=math.sqrt(1 / cfg.code_dim / 3))
        return self

    def norm(self, motion: torch.Tensor) -> torch.Tensor:
        return (motion - self.motion_mean) / self.motion_std

    def unnorm(self, motion: torch.Tensor) -> torch.Tensor:
        return motion * self.motion_std + self.motion_mean

    def two_window_bias(self) -> torch.Tensor:
        """Additive block mask over [prev, this]: prev is blind to current."""
        w = self.window
        bias = torch.zeros(2 * w, 2 * w, device=self.enc_pos_embed.device)
        bias[:w, w:] = -torch.inf
        return bias[None, None]

    def _encode_feat(self, motion: torch.Tensor, bias: Optional[torch.Tensor],
                     pos_len: int) -> torch.Tensor:
        enc = self.encoder
        x = self.norm(motion) + self.enc_pos_embed[:, :pos_len]
        feat = tnn.leaky_relu(enc.inp(x), 0.2)
        return enc.out(enc.layers(feat, bias))

    def encode_to_bits(self, prev_motion: torch.Tensor,
                       this_motion: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Motion window(s) -> per-window multi-scale bits (B, 181, code_dim)."""
        w = self.window
        if this_motion is not None:
            motion = torch.cat([prev_motion, this_motion], dim=1)
            enc_out = self._encode_feat(motion, self.two_window_bias(), 2 * w)
            _, prev_bits = self.quantizer.encode(enc_out[:, :w])
            _, this_bits = self.quantizer.encode(enc_out[:, w:])
            return prev_bits, this_bits
        _, prev_bits = self.quantizer.encode(self._encode_feat(prev_motion, None, w))
        return prev_bits, None

    def decode_from_bits(self, prev_bits: torch.Tensor, this_bits: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two windows of bits -> (prev_motion, this_motion), unnormalized."""
        w = self.window
        dec = self.decoder
        feat = torch.cat([self.quantizer.bits_to_feat(prev_bits),
                          self.quantizer.bits_to_feat(this_bits)], dim=1)
        h = tnn.leaky_relu(dec.inp(feat + self.dec_pos_embed), 0.2)
        h = dec.layers(h, self.two_window_bias())
        motion = self.unnorm(dec.out(h))
        return motion[:, :w], motion[:, w:]

    def bits_to_ms_feat(self, bits: torch.Tensor) -> torch.Tensor:
        return self.quantizer.bits_to_ms_feat(bits)

    def bits_to_ar_feat(self, level: int, bits: torch.Tensor) -> torch.Tensor:
        """Next-level AR decode input (``MultiScaleBSQ.bits_to_ar_feat``)."""
        return self.quantizer.bits_to_ar_feat(level, bits)

    def reconstruct(self, prev_motion: torch.Tensor, this_motion: torch.Tensor,
                    dp_group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The differentiable autoencode pass of stage-1 training: returns
        (recon_prev, recon_this, aux_losses (2, num_levels)), the per-window
        BSQ entropy + commit terms stacked (``dp_group`` as in
        ``MultiScaleBSQ.encode_with_losses``)."""
        w = self.window
        bias = self.two_window_bias()
        enc_out = self._encode_feat(torch.cat([prev_motion, this_motion], dim=1), bias, 2 * w)
        q_prev, _, loss_prev = self.quantizer.encode_with_losses(enc_out[:, :w], dp_group)
        q_this, _, loss_this = self.quantizer.encode_with_losses(enc_out[:, w:], dp_group)
        dec = self.decoder
        h = tnn.leaky_relu(dec.inp(torch.cat([q_prev, q_this], dim=1) + self.dec_pos_embed), 0.2)
        motion = self.unnorm(dec.out(dec.layers(h, bias)))
        return motion[:, :w], motion[:, w:], torch.stack([loss_prev, loss_this])
