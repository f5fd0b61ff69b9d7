"""Whisper encoder: the ``AUDIO_ENCODER="whisper"`` front end.

Whisper large-v3's encoder (Radford et al. 2022, arXiv:2212.04356; HF
``WhisperEncoder`` and ``WhisperFeatureExtractor``): exactly ``chunk_length``
seconds of 16 kHz audio (30 s: 480,000 samples) -> the log-mel front (a
periodic Hann window of ``n_fft`` 400, hop 160, ``torch.stft`` with reflect
padding, the last frame dropped, |X|^2, 128 Slaney-normalised filters on the
Slaney mel scale from 0 to 8 kHz, ``log10(clamp(., 1e-10))``, a floor 8 below
each row's maximum, ``(x + 4) / 4``: 3,000 frames) -> two convolutions with
erf-GELU (k 3, the second of stride 2: 1,500 positions) -> fixed sinusoidal
positions -> 32 pre-LN layers (``x + out(attn(LN(x)))`` with biases on q, v
and out but not k, ``x + fc2(GELU(fc1(LN(x))))``) -> a final LayerNorm.

The JAX package has no Whisper encoder; this module is the port's own. Its
parameters follow the port's layouts: convs ``(out, in, k)`` with a bias,
linears ``(in, out)`` stacked along a leading layer axis. The mel filters
and the positions are buffers computed from their formulas (nothing is
downloaded) and are not in the checkpoint.

Attention goes through ``ops/attention.flash_attention``: the CUDA kernel on
a card (bfloat16 or float32), its plain version on the CPU. The front
computes in float32 with TF32 off in every mode; the stem and the layers
compute in the dtype of the parameters they are given: the AR model passes
bfloat16 copies built once in its bf16 modes (``BitwiseARModel.set_precision``),
where the norm statistics and the softmax stay float32.

``forward`` records three spans (``utils/metrics.GLOBAL_METRICS``), one per
stage and call, each with ``rows`` (the batch) and ``frames`` (the stage's
output length: mel frames, then positions, then positions):
``whisper.logmel``, ``whisper.stem`` and ``whisper.layers`` (the layers and
the final LayerNorm). On a card each also times its stage on the device with
CUDA events, read into ``device_us`` after the caller's download has waited
for the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import WhisperEncoderConfig
from ..ops.attention import flash_attention
from ..utils.metrics import GLOBAL_METRICS
from . import nn as tnn
from .wav2vec import _Conv

__all__ = ["WhisperEncoder", "WhisperEncoderConfig", "mel_filter_bank", "sinusoids"]


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """The Slaney mel scale: linear (3 per 200 Hz) below 1 kHz, logarithmic
    (27 mels per factor 6.4) above it."""
    f = np.asarray(f, np.float64)
    log_step = math.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / log_step,
                    3.0 * f / 200.0)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    log_step = math.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)), 200.0 * m / 3.0)


def mel_filter_bank(n_mels: int, n_fft: int, sample_rate: int, f_min: float = 0.0,
                    f_max: float | None = None) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) Slaney-normalised triangular filters on the
    Slaney mel scale (librosa's ``mel`` with ``htk=False``, ``norm="slaney"``;
    HF's ``mel_filter_bank(..., norm="slaney", mel_scale="slaney")``), in
    float64 and returned as float32."""
    f_max = sample_rate / 2 if f_max is None else f_max
    fft_freqs = np.linspace(0.0, sample_rate / 2, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    widths = np.diff(edges)
    slopes = edges[None, :] - fft_freqs[:, None]                   # (freqs, n_mels + 2)
    rising = -slopes[:, :-2] / widths[:-1]
    falling = slopes[:, 2:] / widths[1:]
    bank = np.maximum(0.0, np.minimum(rising, falling))
    bank *= 2.0 / (edges[2:] - edges[:-2])                          # equal area per filter
    return bank.T.astype(np.float32)


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper's fixed positions (length, channels): sines then cosines of
    ``channels / 2`` geometric timescales from 1 to ``max_timescale``."""
    inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2, dtype=np.float64))
    t = np.arange(length, dtype=np.float64)[:, None] * inv[None]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class _Layers(nn.Module):
    def __init__(self, d: int, ffn: int, depth: int, eps: float):
        super().__init__()
        s = (depth,)
        self.q = tnn.Linear(d, d, stack=s)
        self.k = tnn.Linear(d, d, bias=False, stack=s)
        self.v = tnn.Linear(d, d, stack=s)
        self.out = tnn.Linear(d, d, stack=s)
        self.norm1 = tnn.LayerNorm(d, eps=eps, stack=s)
        self.norm2 = tnn.LayerNorm(d, eps=eps, stack=s)
        self.fc1 = tnn.Linear(d, ffn, stack=s)
        self.fc2 = tnn.Linear(ffn, d, stack=s)


def _norm(ln: tnn.LayerNorm, x: torch.Tensor, i: int | None = None) -> torch.Tensor:
    """LayerNorm ``ln`` (layer ``i`` of a stack) in one pass: float32
    statistics and affine, rounded once to ``x``'s dtype."""
    scale, bias = (ln.scale, ln.bias) if i is None else (ln.scale[i], ln.bias[i])
    return F.layer_norm(x, x.shape[-1:], scale, bias, ln.eps)


def _linear(lin: tnn.Linear, x: torch.Tensor, i: int) -> torch.Tensor:
    """Layer ``i`` of the stacked linear ``lin`` over (B, L, in) as one
    GEMM over every position, the bias added in its epilogue."""
    w = lin.w[i]
    rows = x.reshape(-1, w.shape[0])
    y = rows @ w if lin.b is None else torch.addmm(lin.b[i], rows, w)
    return y.view(*x.shape[:-1], w.shape[1])


def _conv1d(x: torch.Tensor, conv: _Conv, stride: int) -> torch.Tensor:
    """A k-3 convolution padded by 1. On the CPU a bfloat16 one runs in
    float32 on the bf16 values, rounded once (PyTorch's CPU bf16 convolution
    loses most of its precision; ``nn.conv2d`` does the same)."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        y = F.conv1d(x.float(), conv.w.float(), None, stride, 1).to(x.dtype)
        return y + conv.b[:, None]
    return F.conv1d(x, conv.w, conv.b, stride, 1)


class WhisperEncoder(nn.Module):
    """Whisper encoder: (B, n_samples) 16 kHz audio -> (B, positions, d_model)."""

    def __init__(self, cfg: WhisperEncoderConfig = WhisperEncoderConfig()):
        super().__init__()
        if cfg.n_frames != 2 * cfg.max_source_positions:
            raise ValueError(f"whisper: {cfg.chunk_length} s gives {cfg.n_frames} mel frames, "
                             f"not twice max_source_positions {cfg.max_source_positions}")
        self.cfg = cfg
        d = cfg.d_model
        self.conv1 = _Conv(d, cfg.num_mel_bins, 3)
        self.conv2 = _Conv(d, d, 3)
        self.layers = _Layers(d, cfg.encoder_ffn_dim, cfg.encoder_layers, cfg.layer_norm_eps)
        self.final_norm = tnn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.register_buffer("mel_filters", torch.from_numpy(mel_filter_bank(
            cfg.num_mel_bins, cfg.n_fft, cfg.sampling_rate, 0.0, cfg.sampling_rate / 2)),
            persistent=False)
        self.register_buffer("window", torch.hann_window(cfg.n_fft, periodic=True),
                             persistent=False)
        self.register_buffer("positions", torch.from_numpy(
            sinusoids(cfg.max_source_positions, d)), persistent=False)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "WhisperEncoder":
        """Random init in place, torch defaults: convs kaiming-uniform with
        zero biases, linears as ``nn.Linear``; LayerNorms at 1 and 0."""
        for conv in (self.conv1, self.conv2):
            tnn.kaiming_uniform(conv.w.data, conv.w.shape[1] * conv.w.shape[2], gen)
            conv.b.zero_()
        lay = self.layers
        for lin in (lay.q, lay.k, lay.v, lay.out, lay.fc1, lay.fc2):
            tnn.linear_init(lin, gen)
        return self

    def log_mel(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, n_samples) -> (B, n_mels, n_frames) float32, as HF's batched
        ``WhisperFeatureExtractor`` (the floor 8 below each row's maximum)."""
        cfg = self.cfg
        if audio.shape[-1] != cfg.n_samples:
            raise ValueError(f"whisper: want {cfg.n_samples} samples a row, "
                             f"got {audio.shape[-1]}")
        with tnn.no_tf32():
            stft = torch.stft(audio.float(), cfg.n_fft, cfg.hop_length, window=self.window,
                              center=True, pad_mode="reflect", return_complex=True)
            power = stft[..., :-1].abs().square()
            mel = torch.matmul(self.mel_filters, power)
        log_spec = torch.clamp(mel, min=1e-10).log10()
        peak = log_spec.amax(dim=(1, 2), keepdim=True)
        return (torch.maximum(log_spec, peak - 8.0) + 4.0) / 4.0

    def stem(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, frames) -> (B, positions, d): the two GELU convolutions
        in the parameters' dtype, then the fixed positions. The result is
        row-major: a residual stream left in the convolutions' channel-major
        order would keep that order through every layer, and its products
        would run as batched GEMMs on a broadcast weight, several times
        slower on the card than one GEMM over all positions."""
        x = mel.to(self.conv1.w.dtype)
        with tnn.no_tf32():
            x = tnn.gelu_erf(_conv1d(x, self.conv1, 1))
            x = tnn.gelu_erf(_conv1d(x, self.conv2, 2))
        return (x.transpose(1, 2) + self.positions.to(x.dtype)).contiguous()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The pre-LN layers and the final LayerNorm over (B, positions, d)."""
        cfg, lay = self.cfg, self.layers
        heads = cfg.encoder_attention_heads
        scale = (cfg.d_model // heads) ** -0.5
        for i in range(cfg.encoder_layers):
            y = _norm(lay.norm1, x, i)
            q, k, v = (tnn.split_heads(_linear(lin, y, i), heads) for lin in (lay.q, lay.k, lay.v))
            x = x + _linear(lay.out, tnn.merge_heads(flash_attention(q, k, v, scale=scale)), i)
            x = x + _linear(lay.fc2, tnn.gelu_erf(_linear(lay.fc1, _norm(lay.norm2, x, i), i)), i)
        return _norm(self.final_norm, x)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, n_samples) float32 audio -> (B, positions, d) in the
        parameters' dtype: the three stages, each in its span."""
        device, rows = audio.device, audio.shape[0]
        with tnn.no_tf32():
            with GLOBAL_METRICS.span("whisper.logmel", device=device, rows=rows) as sp:
                x = self.log_mel(audio)
            _frames(sp, x.shape[-1])
            with GLOBAL_METRICS.span("whisper.stem", device=device, rows=rows) as sp:
                x = self.stem(x)
            _frames(sp, x.shape[1])
            with GLOBAL_METRICS.span("whisper.layers", device=device, rows=rows) as sp:
                x = self.encode(x)
            _frames(sp, x.shape[1])
        return x


def _frames(span, n: int) -> None:
    """A stage's ``frames`` attribute: the time steps of its output."""
    if span is not None:
        span.attrs["frames"] = n
