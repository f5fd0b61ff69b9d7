"""Plain PyTorch reference of the Mimi encoder as ARTalk uses it
(``AUDIO_ENCODER: "mimi"``): 16 kHz speech to 512-d conditioning frames at
12.5 Hz. Written from the Moshi paper (Defossez et al. 2024,
arXiv:2410.00037), Hugging Face's ``MimiModel.encode`` and
``quantizer.decode`` (the ``kyutai/mimi`` configuration) and ARTalk's
``app/modules/mimi.py``; it imports nothing of the program.

- The resampler: 16 kHz to 24 kHz by the rational 3/2 polyphase filter, a
  61-tap Kaiser-windowed sinc (beta 5, cutoff at the 16 kHz Nyquist): the
  audio is zero-stuffed by 3 (a transposed convolution with the filter), and
  every second sample is kept, each centred on the filter. Departure from
  torchaudio's ``Resample``: its own filter, and 3T/2 - 1 samples where
  torchaudio keeps ceil(3T/2) (the last output's centre would lie past the
  zero-stuffed signal): the configuration's resampler.
- SEANet: causal convolutions (left padding k_eff - stride, right padding
  up to EnCodec's ideal length), a 7-tap input conv, per stage one ELU
  residual block (a dilated k=3 conv to half the channels, a 1x1 conv back)
  and an ELU then a strided conv of kernel 2 x stride that doubles the
  channels, strides 4, 5, 6, 8; an ELU and a 3-tap conv to 512.
- The transformer: pre-LayerNorm layers, bias-free q/k/v/o with RoPE
  (rotate-half, theta 1e4), a causal mask with a sliding window, erf GELU,
  LayerScale on both branches; no final norm.
- The downsample: a causal stride-2 conv of kernel 4, replicate-padded.
- The split RVQ: a semantic and an acoustic residual quantizer, each from
  the whole 12.5 Hz embedding through its 1x1 input projection, each stage
  the nearest codeword (Euclidean; codebooks ``embed_sum / usage``), the
  decode the sum of the chosen codewords through the 1x1 output projection,
  semantic plus acoustic.

The RVQ is teacher-forced: given the program's codes, each stage's residual
is built from them, so that a near tie decided the other way does not carry
into the stages after it; ``code_gap`` says how far the served codes lie
from each stage's nearest codeword. Without codes the reference picks its
own (the control's run).

Everything is float32; matmuls and convolutions take TF32 only where the
caller's ``precision_flags`` allow it (the control).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .motion import attention, heads, layer_norm, unheads

P = Dict[str, torch.Tensor]
A = "audio_encoder"
QUANTIZERS = ("semantic_rvq", "acoustic_rvq")


@functools.lru_cache(maxsize=None)
def kaiser_filter() -> np.ndarray:
    """The 2 -> 3 resampling filter: 61 taps of a sinc with its cutoff at
    1/3 of the 24 kHz band (the 16 kHz Nyquist), gain 3, Kaiser window of
    beta 5."""
    up, down, taps = 3, 2, 61
    half = (taps - 1) // 2
    n = np.arange(-half, half + 1, dtype=np.float64)
    cutoff = 0.5 / max(up, down)
    return (2 * cutoff * up * np.sinc(2 * cutoff * n) * np.kaiser(taps, 5.0)).astype(np.float32)


def resample_16k_to_24k(audio: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz -> (B, (3T - 3) // 2 + 1) 24 kHz: y[m] = sum_i x[i]
    h[3i - 2m + 30], from the zero-stuffed signal's transposed convolution
    with the reversed filter."""
    h = torch.from_numpy(kaiser_filter()).to(audio.device)
    half = (h.shape[0] - 1) // 2
    z = F.conv_transpose1d(audio[:, None], h.flip(0)[None, None], stride=3)[:, 0]
    n = (3 * audio.shape[-1] - 3) // 2 + 1
    return z[:, half:half + 2 * n:2]


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int = 1,
                dilation: int = 1, mode: str = "constant") -> torch.Tensor:
    """A causal conv over (B, C, T) with EnCodec's padding: k_eff - stride
    on the left, and on the right what brings the last frame's window to
    the end of the input."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    left = k_eff - stride
    frames = math.ceil((x.shape[-1] - k_eff + left) / stride + 1)
    right = (frames - 1) * stride + k_eff - left - x.shape[-1]
    return F.conv1d(F.pad(x, (left, right), mode=mode), w, b, stride=stride, dilation=dilation)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (B, H, T, d) at positions 0..T-1, the halves of
    each head rotated as a pair."""
    d, t = x.shape[-1], x.shape[-2]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang).repeat(1, 2), torch.sin(ang).repeat(1, 2)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


class MimiReference:
    """The Mimi encoder of configuration group ``cfg`` (the ``mimi`` group of
    a configuration file) on the ``audio_encoder//...`` parameters."""

    def __init__(self, cfg: dict, params: P):
        self.cfg, self.p = cfg, params
        self.strides = list(reversed(cfg["ratios"]))

    def w(self, key: str) -> torch.Tensor:
        return self.p[f"{A}//{key}"]

    def conv(self, name: str, x: torch.Tensor, **kw) -> torch.Tensor:
        return causal_conv(x, self.w(f"{name}//w"), self.p.get(f"{A}//{name}//b"), **kw)

    def seanet(self, audio_24k: torch.Tensor) -> torch.Tensor:
        """(B, samples) -> (B, 512, frames at 25 Hz)."""
        c = self.cfg
        x = self.conv("seanet//init_conv", audio_24k[:, None])
        for i, stride in enumerate(self.strides):
            for j in range(c["num_residual_layers"]):
                r = f"seanet//blocks//{i}//resnets//{j}"
                y = self.conv(f"{r}//conv1", F.elu(x), dilation=c["dilation_growth_rate"] ** j)
                x = x + self.conv(f"{r}//conv2", F.elu(y))
            x = self.conv(f"seanet//blocks//{i}//down", F.elu(x), stride=stride)
        return self.conv("seanet//final_conv", F.elu(x))

    def transformer(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, 512) -> (B, T, 512)."""
        c = self.cfg
        t = x.shape[1]
        i = torch.arange(t, device=x.device)
        seen = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < c["sliding_window"])
        bias = torch.where(seen, 0.0, -torch.inf)
        T = "transformer"
        for n in range(c["num_hidden_layers"]):
            y = layer_norm(x, c["norm_eps"], self.w(f"{T}//norm1//scale")[n],
                           self.w(f"{T}//norm1//bias")[n])
            q, k, v = (heads(torch.matmul(y, self.w(f"{T}//{nm}//w")[n]), c["num_heads"])
                       for nm in ("q", "k", "v"))
            q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
            a = unheads(attention(q, k, v, c["head_dim"] ** -0.5, bias))
            x = x + torch.matmul(a, self.w(f"{T}//o//w")[n]) * self.w(f"{T}//ls_attn")[n]
            y = layer_norm(x, c["norm_eps"], self.w(f"{T}//norm2//scale")[n],
                           self.w(f"{T}//norm2//bias")[n])
            y = torch.matmul(F.gelu(torch.matmul(y, self.w(f"{T}//fc1//w")[n])),
                             self.w(f"{T}//fc2//w")[n])
            x = x + y * self.w(f"{T}//ls_mlp")[n]
        return x

    def codebooks(self, q: str) -> torch.Tensor:
        return self.w(f"{q}//embed_sum") / self.w(f"{q}//cluster_usage").clamp(min=1e-5)[..., None]

    def rvq_inputs(self, down: torch.Tensor) -> List[torch.Tensor]:
        """(B, 512, T) -> each quantizer's input (B, T, codebook_dim)."""
        return [torch.matmul(down.transpose(1, 2), self.w(f"{q}//input_proj//w")[..., 0].T)
                for q in QUANTIZERS]

    def distances(self, inputs: List[torch.Tensor], codes: Optional[torch.Tensor] = None
                  ) -> tuple:
        """Every stage's squared distances (B, n_q, T, codebook_size) from
        its residual to each codeword, the residual built from ``codes``
        (B, n_q, T) where given, else from the nearest codewords; and the
        codes used."""
        dists, used = [], []
        for r, q in zip(inputs, QUANTIZERS):
            for book in self.codebooks(q):
                d2 = (r[:, :, None, :] - book[None, None]).square().sum(-1)
                s = len(used)
                idx = d2.argmin(-1) if codes is None else codes[:, s].long()
                dists.append(d2)
                used.append(idx)
                r = r - book[idx]
        return torch.stack(dists, 1), torch.stack(used, 1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, n_q, T) -> (B, T, 512): each quantizer's chosen codewords
        summed, through its output projection, semantic plus acoustic."""
        ns = self.cfg["num_semantic_quantizers"]
        out = 0.0
        for q, part in zip(QUANTIZERS, (codes[:, :ns], codes[:, ns:])):
            books = self.codebooks(q)
            total = sum(books[s][part[:, s].long()] for s in range(books.shape[0]))
            out = out + torch.matmul(total, self.w(f"{q}//output_proj//w")[..., 0].T)
        return out

    def encode(self, audio_16k: torch.Tensor, codes: Optional[torch.Tensor] = None) -> dict:
        """(B, samples) 16 kHz -> the transformer's output ``emb`` (B, T,
        512) at 25 Hz, the downsampled embedding ``down`` (B, 512, T / 2),
        the ``codes`` (B, n_q, T / 2): those given, else the reference's own,
        and the conditioning ``cond`` (B, T / 2, 512) they decode to."""
        x = self.seanet(resample_16k_to_24k(audio_16k))
        emb = self.transformer(x.transpose(1, 2))
        down = causal_conv(emb.transpose(1, 2), self.w("downsample//w"), None, stride=2,
                           mode="replicate")
        if codes is None:
            codes = self.distances(self.rvq_inputs(down))[1]
        return {"emb": emb, "down": down, "codes": codes, "cond": self.decode(codes)}

    def code_gap(self, down: torch.Tensor, codes: torch.Tensor) -> float:
        """The widest relative gap (d2[code] - d2[nearest]) / |d2[nearest]|
        of ``codes`` (B, n_q, T) over every stage and frame, each stage's
        residual built from ``codes``."""
        d2 = self.distances(self.rvq_inputs(down), codes)[0]
        best = d2.amin(-1)
        chosen = torch.gather(d2, -1, codes.long()[..., None])[..., 0]
        return float(((chosen - best) / best.abs().clamp(min=1e-30)).max())
