"""Mimi neural audio codec, encode path: the ``AUDIO_ENCODER="mimi"`` front end.

Counterpart of ``artalk_tpu/models/mimi.py`` (HF ``MimiModel`` semantics):
16 kHz audio is resampled to 24 kHz, encoded by the SEANet causal conv
encoder (ELU residual blocks, strided downsampling convs with the EnCodec
extra-padding rule), an 8-layer RoPE transformer with a sliding-window causal
mask and LayerScale, a replicate-padded stride-2 downsample and a split
residual vector quantizer (Euclidean codebooks normalised by their usage);
the RVQ codes are decoded back at once into continuous 512-d embeddings at
12.5 Hz, which condition the AR model (50 frames per 4 s window).

Layouts follow the JAX tree name for name: convs ``(out, in, k)`` with an
optional bias, linear weights ``(in, out)``, the transformer layers stacked
along a leading depth axis. Attention is the plain softmax with an additive
mask (``nn.sdpa``), as in the JAX package; no flash switch.

The convolutions and the RVQ distance ``|r|^2 - 2 r.c + |c|^2`` decide the
integer codes, so ``forward`` and ``encode_codes`` run with TF32 off even when
the module is used without the engine (which turns it off on import). The
distance is computed in that expanded form, not with ``torch.cdist``, so that
argmin ties break as in JAX.

``forward`` records four spans (``utils/metrics.GLOBAL_METRICS``), one per
stage and call, each with ``rows`` (the batch) and ``frames`` (the stage's
output length: 24 kHz samples, then 25 Hz frames, then 12.5 Hz frames):
``mimi.resample``, ``mimi.seanet``, ``mimi.transformer`` and ``mimi.rvq``
(the downsample, the RVQ encode and its decode). On a card each also times
its stage on the device with CUDA events, read into ``device_us`` after the
caller's download has waited for the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import MimiEncoderConfig
from ..utils.metrics import GLOBAL_METRICS
from . import nn as tnn
from .wav2vec import _Conv

__all__ = ["MimiEncoder", "MimiEncoderConfig", "resample_16k_to_24k"]


def _causal_pad_amounts(length: int, kernel: int, stride: int, dilation: int
                        ) -> Tuple[int, int]:
    """(left, right) causal padding with the EnCodec extra-padding rule:
    left = k_eff - stride; right pads up to the ideal length so that no
    sample is dropped."""
    k_eff = (kernel - 1) * dilation + 1
    padding_total = k_eff - stride
    n_frames = (length - k_eff + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + k_eff - padding_total
    return padding_total, ideal - length


def _causal_conv(p: _Conv, x: torch.Tensor, stride: int = 1, dilation: int = 1,
                 pad_mode: str = "constant") -> torch.Tensor:
    """Causal conv on (B, C, T)."""
    left, right = _causal_pad_amounts(x.shape[-1], p.w.shape[-1], stride, dilation)
    x = F.pad(x, (left, right), mode=pad_mode)
    return F.conv1d(x, p.w, p.b, stride=stride, dilation=dilation)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Llama-style rotary embedding over (B, H, T, hd)."""
    hd, t = x.shape[-1], x.shape[-2]
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                             device=x.device) / hd))
    freqs = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv_freq[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return x * torch.cos(emb) + torch.cat([-x2, x1], dim=-1) * torch.sin(emb)


class _ResBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, k: int):
        super().__init__()
        self.conv1 = _Conv(hidden, dim, k)
        self.conv2 = _Conv(dim, hidden, 1)


class _DownBlock(nn.Module):
    def __init__(self, dim: int, ratio: int, cfg: MimiEncoderConfig):
        super().__init__()
        self.resnets = nn.ModuleList(
            _ResBlock(dim, dim // cfg.compress, cfg.residual_kernel_size)
            for _ in range(cfg.num_residual_layers))
        self.down = _Conv(dim * 2, dim, ratio * 2)


class _SEANet(nn.Module):
    def __init__(self, cfg: MimiEncoderConfig, enc_ratios):
        super().__init__()
        f = cfg.num_filters
        self.init_conv = _Conv(f, 1, cfg.kernel_size)
        self.blocks = nn.ModuleList(_DownBlock(f * 2 ** i, r, cfg)
                                    for i, r in enumerate(enc_ratios))
        self.final_conv = _Conv(cfg.hidden_size, f * 2 ** len(enc_ratios), cfg.last_kernel_size)


class _Transformer(nn.Module):
    def __init__(self, cfg: MimiEncoderConfig):
        super().__init__()
        d, hd, s = cfg.hidden_size, cfg.num_heads * cfg.head_dim, (cfg.num_hidden_layers,)
        self.q = tnn.Linear(d, hd, bias=False, stack=s)
        self.k = tnn.Linear(d, hd, bias=False, stack=s)
        self.v = tnn.Linear(d, hd, bias=False, stack=s)
        self.o = tnn.Linear(hd, d, bias=False, stack=s)
        self.norm1 = tnn.LayerNorm(d, eps=cfg.norm_eps, stack=s)
        self.norm2 = tnn.LayerNorm(d, eps=cfg.norm_eps, stack=s)
        self.fc1 = tnn.Linear(d, cfg.intermediate_size, bias=False, stack=s)
        self.fc2 = tnn.Linear(cfg.intermediate_size, d, bias=False, stack=s)
        self.ls_attn = nn.Parameter(torch.full((*s, d), cfg.layer_scale))
        self.ls_mlp = nn.Parameter(torch.full((*s, d), cfg.layer_scale))


class _RVQ(nn.Module):
    """n Euclidean codebooks (``embed_sum`` over ``cluster_usage``) with their
    1x1 input and output projections."""

    def __init__(self, n: int, cfg: MimiEncoderConfig):
        super().__init__()
        self.embed_sum = nn.Parameter(torch.zeros(n, cfg.codebook_size, cfg.codebook_dim))
        self.cluster_usage = nn.Parameter(torch.ones(n, cfg.codebook_size))
        self.input_proj = _Conv(cfg.codebook_dim, cfg.hidden_size, 1, bias=False)
        self.output_proj = _Conv(cfg.hidden_size, cfg.codebook_dim, 1, bias=False)

    def codebooks(self) -> torch.Tensor:
        """(n, codebook_size, dim): usage-normalised embeddings."""
        return self.embed_sum / torch.clamp(self.cluster_usage, min=1e-5)[..., None]

    def encode(self, emb: torch.Tensor) -> torch.Tensor:
        """(B, hidden, T) -> codes (B, n, T): residual nearest centroids."""
        residual = torch.einsum("oi,bit->bto", self.input_proj.w[..., 0], emb)
        codes = []
        for book in self.codebooks():
            d2 = (residual.square().sum(-1, keepdim=True) - 2.0 * residual @ book.T
                  + book.square().sum(-1)[None, None])
            idx = torch.argmin(d2, dim=-1)
            codes.append(idx)
            residual = residual - book[idx]
        return torch.stack(codes, dim=1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, n, T) -> (B, hidden, T)."""
        books = self.codebooks()
        total = sum(books[q][codes[:, q]] for q in range(books.shape[0]))
        return torch.einsum("oi,bti->bot", self.output_proj.w[..., 0], total)


class MimiEncoder(nn.Module):
    """Mimi encode path: 16 kHz audio -> 12.5 Hz RVQ-decoded embeddings."""

    def __init__(self, cfg: MimiEncoderConfig = MimiEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.enc_ratios = list(reversed(cfg.ratios))
        d = cfg.hidden_size
        self.seanet = _SEANet(cfg, self.enc_ratios)
        self.transformer = _Transformer(cfg)
        self.downsample = _Conv(d, d, 4, bias=False)
        self.semantic_rvq = _RVQ(cfg.num_semantic_quantizers, cfg)
        self.acoustic_rvq = _RVQ(cfg.num_quantizers - cfg.num_semantic_quantizers, cfg)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "MimiEncoder":
        """Random init in place, in the JAX ``init``'s distributions: convs
        kaiming-uniform with zero biases, bias-free linears, codebooks
        standard normal with usage 1, LayerScale at ``layer_scale``."""
        for conv in self.modules():
            if isinstance(conv, _Conv):
                tnn.kaiming_uniform(conv.w.data, conv.w.shape[1] * conv.w.shape[2], gen)
                if conv.b is not None:
                    conv.b.zero_()
        tr = self.transformer
        for lin in (tr.q, tr.k, tr.v, tr.o, tr.fc1, tr.fc2):
            tnn.linear_init(lin, gen)
        for rvq in (self.semantic_rvq, self.acoustic_rvq):
            rvq.embed_sum.copy_(torch.randn(rvq.embed_sum.shape, generator=gen))
            rvq.cluster_usage.fill_(1.0)
        return self

    def seanet_encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T_samples) 24 kHz -> (B, hidden, T_frames) at 25 Hz."""
        cfg, p = self.cfg, self.seanet
        x = _causal_conv(p.init_conv, audio[:, None, :])
        for block, stride in zip(p.blocks, self.enc_ratios):
            for j, res in enumerate(block.resnets):
                h = _causal_conv(res.conv1, F.elu(x), dilation=cfg.dilation_growth_rate ** j)
                x = x + _causal_conv(res.conv2, F.elu(h))
            x = _causal_conv(block.down, F.elu(x), stride=stride)
        return _causal_conv(p.final_conv, F.elu(x))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """RoPE transformer over (B, T, hidden), sliding-window causal mask."""
        cfg, tr = self.cfg, self.transformer
        t = x.shape[1]
        i = torch.arange(t, device=x.device)[:, None]
        j = torch.arange(t, device=x.device)[None, :]
        causal = (j <= i) & (i - j < cfg.sliding_window)
        bias = torch.where(causal, 0.0, float("-inf"))[None, None]
        w_qkv = torch.cat([tr.q.w, tr.k.w, tr.v.w], dim=-1)
        for n in range(cfg.num_hidden_layers):
            qkv = torch.matmul(tr.norm1(x, n), w_qkv[n])
            q, k, v = (tnn.split_heads(z, cfg.num_heads) for z in qkv.chunk(3, dim=-1))
            q, k = _rope(q, cfg.rope_theta), _rope(k, cfg.rope_theta)
            attn = tnn.merge_heads(tnn.sdpa(q, k, v, scale=cfg.head_dim ** -0.5, bias=bias))
            x = x + tr.o(attn, n) * tr.ls_attn[n]
            x = x + tr.fc2(tnn.gelu_erf(tr.fc1(tr.norm2(x, n), n)), n) * tr.ls_mlp[n]
        return x

    def quantize(self, emb: torch.Tensor) -> torch.Tensor:
        """(B, hidden, T) at 25 Hz -> RVQ codes (B, num_quantizers, T / 2):
        the replicate-padded stride-2 downsample, then the semantic and the
        acoustic RVQ."""
        emb = _causal_conv(self.downsample, emb, stride=2, pad_mode="replicate")
        return torch.cat([self.semantic_rvq.encode(emb), self.acoustic_rvq.encode(emb)], dim=1)

    def encode_codes(self, audio_24k: torch.Tensor) -> torch.Tensor:
        """(B, T_samples) 24 kHz -> RVQ codes (B, num_quantizers, T_frames)."""
        with tnn.no_tf32():
            emb = self.seanet_encode(audio_24k)
            return self.quantize(self.transform(emb.transpose(1, 2)).transpose(1, 2))

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes -> continuous embeddings (B, hidden, T): the semantic and
        acoustic decodes summed."""
        ns = self.cfg.num_semantic_quantizers
        return (self.semantic_rvq.decode(codes[:, :ns])
                + self.acoustic_rvq.decode(codes[:, ns:]))

    def forward(self, audio_16k: torch.Tensor) -> torch.Tensor:
        """16 kHz audio (B, T) -> (B, T_frames, hidden) embeddings at 12.5 Hz:
        the resampler, the stages of ``encode_codes`` and ``decode_codes``,
        each stage in its span."""
        device, rows = audio_16k.device, audio_16k.shape[0]
        with tnn.no_tf32():
            with GLOBAL_METRICS.span("mimi.resample", device=device, rows=rows) as sp:
                x = resample_16k_to_24k(audio_16k)
            _frames(sp, x)
            with GLOBAL_METRICS.span("mimi.seanet", device=device, rows=rows) as sp:
                x = self.seanet_encode(x)
            _frames(sp, x)
            with GLOBAL_METRICS.span("mimi.transformer", device=device, rows=rows) as sp:
                x = self.transform(x.transpose(1, 2)).transpose(1, 2)
            _frames(sp, x)
            with GLOBAL_METRICS.span("mimi.rvq", device=device, rows=rows) as sp:
                x = self.decode_codes(self.quantize(x))
            _frames(sp, x)
            return x.transpose(1, 2)

    def num_output_frames(self, num_samples_16k: int) -> int:
        return self.cfg.num_output_frames(num_samples_16k * 3 // 2)


def _frames(span, x: torch.Tensor) -> None:
    """A stage's ``frames`` attribute: the time steps of its output."""
    if span is not None:
        span.attrs["frames"] = x.shape[-1]


def _resample_filter() -> np.ndarray:
    """The 2 -> 3 polyphase filter: a Kaiser-windowed sinc of 61 taps."""
    up, down = 3, 2
    half_len = 10 * max(up, down)
    m = np.arange(-half_len, half_len + 1, dtype=np.float64)
    cutoff = 0.5 / max(up, down)
    win = np.kaiser(2 * half_len + 1, 5.0)
    return (2 * cutoff * up * np.sinc(2 * cutoff * m) * win).astype(np.float32)


def resample_16k_to_24k(audio: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz -> (B, ceil(3T / 2)) 24 kHz: zeros inserted between the
    samples (two after each but the last), then the Kaiser-windowed sinc
    convolved at stride 2 with 30 samples of zero padding on each side, as
    the JAX package's lhs-dilated convolution computes it."""
    filt = torch.from_numpy(_resample_filter()).to(audio.device)
    b, t = audio.shape
    up = audio.new_zeros((b, 1, (t - 1) * 3 + 1))
    up[:, 0, ::3] = audio
    half_len = (filt.shape[0] - 1) // 2
    with tnn.no_tf32():
        y = F.conv1d(F.pad(up, (half_len, half_len)), filt[None, None], stride=2)
    return y[:, 0, : -(-t * 3 // 2)]
