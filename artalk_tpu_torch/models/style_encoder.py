"""Style encoder: a 50-frame (2 s) motion clip -> 128-d style vector.

Counterpart of ``artalk_tpu/models/style_encoder.py``: a post-LN transformer
encoder over projected motion, mean-pooled. The reference's positional
encoding quirk is kept for checkpoint parity: the sinusoidal encoding of a
single position (index = sequence length) is added to every frame.

``pe``, ``motion_mean`` and ``motion_std`` are parameters, as they are leaves
of the JAX parameter tree: stage-2 training with style clips updates and
decays them as it does every other leaf.
"""

from __future__ import annotations

import torch
from torch import nn

from . import nn as tnn
from .data_stats import ALLTALKEMICA_MEAN, ALLTALKEMICA_STD


class _Layers(nn.Module):
    def __init__(self, d: int, ffn_dim: int, depth: int):
        super().__init__()
        s = (depth,)
        self.qkv = tnn.Linear(d, 3 * d, stack=s)
        self.out = tnn.Linear(d, d, stack=s)
        self.norm1 = tnn.LayerNorm(d, stack=s)
        self.norm2 = tnn.LayerNorm(d, stack=s)
        self.fc1 = tnn.Linear(d, ffn_dim, stack=s)
        self.fc2 = tnn.Linear(ffn_dim, d, stack=s)


class StyleEncoder(nn.Module):
    def __init__(self, motion_dim: int = 106, feature_dim: int = 128,
                 num_heads: int = 4, num_layers: int = 4, ffn_dim: int = 512,
                 max_len: int = 600):
        super().__init__()
        self.motion_dim, self.feature_dim = motion_dim, feature_dim
        self.num_heads, self.num_layers = num_heads, num_layers
        self.proj = tnn.Linear(motion_dim, feature_dim)
        self.layers = _Layers(feature_dim, ffn_dim, num_layers)
        self.pe = nn.Parameter(torch.from_numpy(tnn.sinusoidal_pe(max_len, feature_dim))[None])
        if motion_dim == ALLTALKEMICA_MEAN.shape[0]:
            mean, std = torch.from_numpy(ALLTALKEMICA_MEAN), torch.from_numpy(ALLTALKEMICA_STD)
        else:  # non-standard motion dim (tests / custom datasets): identity stats
            mean, std = torch.zeros(motion_dim), torch.ones(motion_dim)
        self.motion_mean = nn.Parameter(mean.clone())
        self.motion_std = nn.Parameter(std.clone())

    def init(self, gen: torch.Generator) -> "StyleEncoder":
        d = self.feature_dim
        # torch MultiheadAttention: xavier_uniform over the packed in-projection
        # of every layer, zero bias
        for i in range(self.num_layers):
            tnn.xavier_uniform(self.layers.qkv.w.data[i], d, 3 * d, gen)
        self.layers.qkv.b.data.zero_()
        for lin in (self.layers.out, self.layers.fc1, self.layers.fc2, self.proj):
            tnn.linear_init(lin, gen)
        return self

    def forward(self, motion: torch.Tensor) -> torch.Tensor:
        """(B, L, 106) motion clip -> (B, 128) style vector."""
        p = self.layers
        x = self.proj((motion - self.motion_mean) / self.motion_std)
        x = x + self.pe[:, x.shape[1], :]  # reference quirk: one position for all frames
        for i in range(self.num_layers):
            q, k, v = (tnn.split_heads(t, self.num_heads)
                       for t in p.qkv(x, i).chunk(3, dim=-1))
            attn = tnn.merge_heads(tnn.sdpa(q, k, v, scale=q.shape[-1] ** -0.5))
            x = p.norm1(x + p.out(attn, i), i)
            x = p.norm2(x + p.fc2(tnn.gelu_erf(p.fc1(x, i)), i), i)
        return x.mean(dim=1)
