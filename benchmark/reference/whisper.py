"""Plain PyTorch reference of Whisper large-v3's encoder as ARTalk uses it
(``AUDIO_ENCODER: "whisper"``): 30 s of 16 kHz speech to 1280-d frames at
50 Hz. Written from the Whisper paper (Radford et al. 2022,
arXiv:2212.04356) and ``openai/whisper-large-v3``'s ``config.json`` and
``preprocessor_config.json`` (HF's ``WhisperFeatureExtractor`` and
``WhisperEncoder``); it imports nothing of the program.

- The log-mel front: the audio reflect-padded by n_fft / 2 on each side,
  cut into frames of 400 every 160 samples, each times a periodic Hann
  window and through a DFT (a matrix of cosines and sines), |X|^2 of the
  first 201 bins, the last frame dropped; 128 triangular filters on the
  Slaney mel scale (linear below 1 kHz, logarithmic above) from 0 to 8 kHz,
  each scaled to unit area (Slaney's norm), built filter by filter from the
  formula; ``log10(max(., 1e-10))``, a floor 8 below the row's maximum,
  ``(x + 4) / 4``.
- The stem: two k-3 convolutions padded by 1 (the second of stride 2), each
  followed by erf GELU, then the fixed sinusoids (sines of 640 geometric
  timescales from 1 to 1e4, then their cosines).
- 32 pre-LN layers: LayerNorm (eps 1e-5), q, k and v (k without a bias),
  softmax attention of 20 heads scaled by 64^-0.5, the output projection and
  the residual; LayerNorm, fc1, erf GELU, fc2 and the residual; a final
  LayerNorm.

Departures from the published description, all the configuration's:

- The context: each 4-s window is encoded with the 26 s of the session
  before it, right-aligned, zeros before the session's start, and the last
  200 positions (the window's own 4 s) are kept. Whisper pads short audio at
  the end, for transcription.
- The floor 8 below the maximum is taken per row over the whole 30 s, as
  HF's batched extractor takes it (openai's ``log_mel_spectrogram`` takes it
  over the whole batch).
- No released checkpoint: the weights are seeded (``params_whisper.py``).

Everything is float32; matmuls and convolutions take TF32 only where the
caller's ``precision_flags`` allow it (the control). The control's
``weight_bits`` round the layers' six linears per output column, as
``motion.quantize_weight`` does the AR blocks'; ``fp8`` rounds them to fp8
e4m3 per output column (scale = the column's largest magnitude over 448).
The encode runs in blocks of rows, so that it fits beside the program on
the card.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .motion import FP32, Precision, attention, heads, layer_norm, quantize_weight, unheads

P = Dict[str, torch.Tensor]
A = "audio_encoder"
BLOCK = 4            # rows encoded at once
FP8_MAX = 448.0      # the largest finite e4m3 value
LINEARS = ("q", "k", "v", "out", "fc1", "fc2")


def hz_to_mel(f: float) -> float:
    """Slaney's mel scale: 3 mels per 200 Hz up to 1 kHz (15 mels), then 27
    mels per factor 6.4."""
    if f < 1000.0:
        return 3.0 * f / 200.0
    return 15.0 + 27.0 * math.log(f / 1000.0) / math.log(6.4)


def mel_to_hz(m: float) -> float:
    if m < 15.0:
        return 200.0 * m / 3.0
    return 1000.0 * 6.4 ** ((m - 15.0) / 27.0)


@functools.lru_cache(maxsize=None)
def slaney_filters(n_mels: int, n_fft: int, sample_rate: int, f_min: float, f_max: float
                   ) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1): filter m rises linearly from edge m to edge
    m + 1 and falls to edge m + 2 (edges evenly spaced in mels from f_min to
    f_max), scaled by 2 / (edge m + 2 - edge m) to unit area; float64
    arithmetic, float32 out."""
    lo, hi = hz_to_mel(f_min), hz_to_mel(f_max)
    edges = [mel_to_hz(lo + (hi - lo) * i / (n_mels + 1)) for i in range(n_mels + 2)]
    bins = n_fft // 2 + 1
    out = np.zeros((n_mels, bins))
    for m in range(n_mels):
        left, centre, right = edges[m], edges[m + 1], edges[m + 2]
        for j in range(bins):
            f = j * sample_rate / n_fft
            rise = (f - left) / (centre - left)
            fall = (right - f) / (right - centre)
            out[m, j] = max(0.0, min(rise, fall)) * 2.0 / (right - left)
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft(n_fft: int) -> np.ndarray:
    """(n_fft, 2 * bins) cosines then negated sines of the real DFT, each
    column times the periodic Hann window's value at its row."""
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)
    return (hann[:, None] * np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's positions: position t, channel c < channels / 2:
    sin(t / 10000^(c / (channels / 2 - 1))); channel channels / 2 + c: the
    cosine."""
    half = channels // 2
    out = np.zeros((length, channels))
    for c in range(half):
        rate = 10000.0 ** (-c / (half - 1))
        out[:, c] = np.sin(np.arange(length) * rate)
        out[:, half + c] = np.cos(np.arange(length) * rate)
    return out.astype(np.float32)


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """(..., in, out) weights rounded to fp8 e4m3 per output column."""
    scale = w.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def contexts(windows: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(N, window) windows of one session, in order -> (N, n_samples): for
    window i, the n_samples that end with it, zeros before the session's
    first window."""
    n, ws = windows.shape
    stream = torch.cat([windows.new_zeros(n_samples), windows.reshape(-1)])
    return torch.stack([stream[(i + 1) * ws:(i + 1) * ws + n_samples] for i in range(n)])


class WhisperReference:
    """The Whisper encoder of configuration group ``cfg`` (the ``whisper``
    group of a configuration file) on the ``audio_encoder//...`` parameters,
    at ``prec``."""

    def __init__(self, cfg: dict, params: P, prec: Precision = FP32):
        self.cfg, self.p, self.prec = cfg, params, prec
        self.n_samples = int(round(cfg["chunk_length"] * cfg["sampling_rate"]))

    def w(self, key: str) -> torch.Tensor:
        return self.p[f"{A}//{key}"]

    def linear(self, name: str, i: int, x: torch.Tensor) -> torch.Tensor:
        w = self.w(f"layers//{name}//w")[i]
        w = fp8_weight(w) if self.prec.fp8 else quantize_weight(w, self.prec.weight_bits)
        y = torch.matmul(x, w)
        b = self.p.get(f"{A}//layers//{name}//b")
        return y if b is None else y + b[i]

    def log_mel(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, n_samples) -> (B, n_mels, n_samples / hop)."""
        c = self.cfg
        n_fft, hop = c["n_fft"], c["hop_length"]
        padded = F.pad(audio[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
        frames = padded.unfold(-1, n_fft, hop)[:, :-1]                  # (B, T, n_fft)
        spec = torch.matmul(frames, torch.from_numpy(_dft(n_fft)).to(audio.device))
        bins = n_fft // 2 + 1
        power = spec[..., :bins].square() + spec[..., bins:].square()    # (B, T, bins)
        filters = torch.from_numpy(slaney_filters(
            c["num_mel_bins"], n_fft, c["sampling_rate"], 0.0, c["sampling_rate"] / 2.0))
        mel = torch.matmul(power, filters.to(audio.device).T).transpose(1, 2)
        log_spec = torch.log10(torch.clamp(mel, min=1e-10))
        floor = log_spec.flatten(1).amax(-1)[:, None, None] - 8.0
        return (torch.maximum(log_spec, floor) + 4.0) / 4.0

    def encoder(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, frames) -> (B, frames / 2, d_model)."""
        c = self.cfg
        x = F.gelu(F.conv1d(mel, self.w("conv1//w"), self.w("conv1//b"), padding=1))
        x = F.gelu(F.conv1d(x, self.w("conv2//w"), self.w("conv2//b"), stride=2, padding=1))
        x = x.transpose(1, 2)
        x = x + torch.from_numpy(sinusoids(x.shape[1], x.shape[2])).to(x.device)
        eps, nh = c.get("layer_norm_eps", 1e-5), c["encoder_attention_heads"]
        L = "layers"
        for i in range(c["encoder_layers"]):
            y = layer_norm(x, eps, self.w(f"{L}//norm1//scale")[i], self.w(f"{L}//norm1//bias")[i])
            q, k, v = (heads(self.linear(nm, i, y), nh) for nm in ("q", "k", "v"))
            x = x + self.linear("out", i, unheads(attention(q, k, v, q.shape[-1] ** -0.5)))
            y = layer_norm(x, eps, self.w(f"{L}//norm2//scale")[i], self.w(f"{L}//norm2//bias")[i])
            x = x + self.linear("fc2", i, F.gelu(self.linear("fc1", i, y)))
        return layer_norm(x, eps, self.w("final_norm//scale"), self.w("final_norm//bias"))

    def encode(self, audio: torch.Tensor) -> dict:
        """(B, n_samples) -> the log-mel ``mel`` (B, n_mels, frames) and the
        encoder's output ``emb`` (B, positions, d_model), BLOCK rows at a
        time."""
        mels, embs = [], []
        for start in range(0, audio.shape[0], BLOCK):
            mel = self.log_mel(audio[start:start + BLOCK])
            mels.append(mel)
            embs.append(self.encoder(mel))
        return {"mel": torch.cat(mels), "emb": torch.cat(embs)}

    def encode_session(self, windows: torch.Tensor, keep: int) -> dict:
        """A session's windows (N, window samples), in order -> each window's
        30-s log-mel (N, n_mels, frames) and the last ``keep`` positions of
        its encode (N, keep, d_model)."""
        out = self.encode(contexts(windows, self.n_samples))
        return {"mel": out["mel"], "emb": out["emb"][:, -keep:]}
