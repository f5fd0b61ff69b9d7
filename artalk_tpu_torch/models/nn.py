"""NN primitives: linear, LayerNorm, GELUs, attention, initializers.

Counterpart of ``artalk_tpu/models/nn.py``. Parameters keep the JAX layouts so
that the parameter bridge (``utils/params.py``) is a rename and nothing more:
linear weights are ``(in, out)`` and the forward is ``x @ w``; a layer stack
keeps the per-layer parameters stacked along a leading ``depth`` axis, and the
caller picks a layer with ``i``. Activations are ``(B, T, C)`` and attention
heads ``(B, H, L, hd)``, as in the JAX package.

Norm statistics and softmax are computed in float32, as in the JAX helpers.
Initializers draw from an explicit ``torch.Generator`` and follow the torch
defaults the reference relies on; they match the JAX package in distribution,
not in values.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Initializers (in place, on a torch.Generator)
# ---------------------------------------------------------------------------


@torch.no_grad()
def uniform_init(t: torch.Tensor, bound: float, gen: torch.Generator) -> torch.Tensor:
    return t.uniform_(-bound, bound, generator=gen)


def kaiming_uniform(t: torch.Tensor, fan_in: int, gen: torch.Generator,
                    a: float = math.sqrt(5)) -> torch.Tensor:
    """torch nn.Linear/Conv default weight init (kaiming_uniform with a=sqrt(5))."""
    gain = math.sqrt(2.0 / (1 + a * a))
    return uniform_init(t, gain * math.sqrt(3.0 / fan_in), gen)


@torch.no_grad()
def trunc_normal(t: torch.Tensor, gen: torch.Generator, std: float = 1.0,
                 mean: float = 0.0, a: float = -2.0, b: float = 2.0) -> torch.Tensor:
    """nn.init.trunc_normal_: ``a``/``b`` are absolute bounds (torch semantics)."""
    return nn.init.trunc_normal_(t, mean=mean, std=std, a=a, b=b, generator=gen)


def xavier_uniform(t: torch.Tensor, fan_in: int, fan_out: int,
                   gen: torch.Generator, gain: float = 1.0) -> torch.Tensor:
    return uniform_init(t, gain * math.sqrt(6.0 / (fan_in + fan_out)), gen)


# ---------------------------------------------------------------------------
# Linear / LayerNorm modules
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """``y = x @ w + b`` with ``w`` of shape ``stack + (in, out)``.

    ``stack`` is the leading layer axis of a parameter-stacked tower (empty for
    a single layer); ``forward(x, i)`` applies layer ``i``."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 stack: Sequence[int] = ()):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.w = nn.Parameter(torch.empty(*stack, in_dim, out_dim))
        if bias:
            self.b = nn.Parameter(torch.empty(*stack, out_dim))
        else:
            self.register_parameter("b", None)

    def forward(self, x: torch.Tensor, i: Optional[int] = None) -> torch.Tensor:
        w = self.w if i is None else self.w[i]
        y = torch.matmul(x, w)
        if self.b is not None:
            y = y + (self.b if i is None else self.b[i])
        return y


def linear_init(lin: Linear, gen: torch.Generator, w_init=None) -> Linear:
    """torch nn.Linear default init, or ``w_init(tensor, gen)`` for the weight."""
    if w_init is None:
        kaiming_uniform(lin.w.data, lin.in_dim, gen)
    else:
        w_init(lin.w.data, gen)
    if lin.b is not None:
        uniform_init(lin.b.data, 1.0 / math.sqrt(lin.in_dim), gen)
    return lin


def layer_norm(x: torch.Tensor, eps: float = 1e-5,
               scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics (JAX formula:
    ``(x - mean) * rsqrt(mean((x - mean)^2) + eps)``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


class LayerNorm(nn.Module):
    """Affine LayerNorm with parameters ``scale``/``bias`` (JAX names)."""

    def __init__(self, dim: int, eps: float = 1e-5, stack: Sequence[int] = ()):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(*stack, dim))
        self.bias = nn.Parameter(torch.zeros(*stack, dim))

    def forward(self, x: torch.Tensor, i: Optional[int] = None) -> torch.Tensor:
        if i is None:
            return layer_norm(x, self.eps, self.scale, self.bias)
        return layer_norm(x, self.eps, self.scale[i], self.bias[i])


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with tanh approximation (nn.GELU(approximate='tanh'))."""
    return F.gelu(x, approximate="tanh")


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU (torch default; HF wav2vec2 and nn.Transformer)."""
    return F.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, C) -> (B, H, L, c)."""
    b, l, c = x.shape
    return x.reshape(b, l, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, c) -> (B, L, C)."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: float | torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, L, c) tensors, f32 softmax."""
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Matches F.normalize: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(x.square(), dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """Vanilla sinusoidal positional encoding table (max_len, d_model)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)
