"""wav2vec2-xls-r-300m audio encoder (stable-LN layout).

Counterpart of ``artalk_tpu/models/wav2vec.py`` on its XLA path: per-utterance
z-norm with unbiased std -> 7-layer conv stack, each conv followed by a
channel LayerNorm and erf-GELU -> feature projection -> grouped positional
conv (SamePad drops the trailing step for an even kernel) -> 24 pre-LN
encoder layers -> final LayerNorm. For the 4 s window (64 000 samples) the
conv stack yields 199 frames.

With a ``fused_pack`` (``pack_fused``) the 24 layers run as one launch of the
encoder block-stack kernel (``ops/encoder_block_stack.py``) instead of the
layer-by-layer plain torch; bf16 and int8 packs also take batches of windows,
float32 packs batch 1 only, as the JAX package routes them.

Not ported yet (ROADMAP.md Queue 1 item 12): the group-norm/HuBERT post-LN
layout. The flash-attention kernel waits in ROADMAP.md Queue 2; its switch
raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Wav2VecConfig
from ..ops.encoder_block_stack import (encoder_block_stack, pack_batched_ok,
                                       pack_encoder_weights)
from . import nn as tnn


def normalize_audio(audio: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-utterance z-norm with torch ``std`` semantics (unbiased, ddof=1)."""
    mean = audio.mean(dim=-1, keepdim=True)
    n = audio.shape[-1]
    var = (audio - mean).square().sum(dim=-1, keepdim=True) / (n - 1)
    return (audio - mean) / (torch.sqrt(var) + eps)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           **kwargs) -> torch.Tensor:
    """``F.conv1d``; bfloat16 inputs are convolved in float32 and rounded
    once, then the bias is added in bfloat16, as XLA computes a bf16
    convolution. (PyTorch's CPU bf16 grouped convolution loses most of its
    precision, and the plain versions must run on the CPU too.)"""
    if x.dtype != torch.bfloat16:
        return F.conv1d(x, w, b, **kwargs)
    y = F.conv1d(x.float(), w.float(), **kwargs).to(torch.bfloat16)
    return y if b is None else y + b[:, None]


class _Conv(nn.Module):
    """1-D conv parameters in the torch weight layout (out, in/groups, k)."""

    def __init__(self, out_ch: int, in_ch: int, k: int, bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.empty(out_ch, in_ch, k))
        if bias:
            self.b = nn.Parameter(torch.zeros(out_ch))
        else:
            self.register_parameter("b", None)


class _ConvLayer(nn.Module):
    def __init__(self, out_ch: int, in_ch: int, k: int, bias: bool, eps: float):
        super().__init__()
        self.conv = _Conv(out_ch, in_ch, k, bias)
        self.norm = tnn.LayerNorm(out_ch, eps=eps)


class _FeatureProjection(nn.Module):
    def __init__(self, conv_out: int, d: int, eps: float):
        super().__init__()
        self.norm = tnn.LayerNorm(conv_out, eps=eps)
        self.proj = tnn.Linear(conv_out, d)


class _Layers(nn.Module):
    def __init__(self, d: int, ffn: int, depth: int, eps: float):
        super().__init__()
        s = (depth,)
        self.q = tnn.Linear(d, d, stack=s)
        self.k = tnn.Linear(d, d, stack=s)
        self.v = tnn.Linear(d, d, stack=s)
        self.out = tnn.Linear(d, d, stack=s)
        self.norm1 = tnn.LayerNorm(d, eps=eps, stack=s)
        self.norm2 = tnn.LayerNorm(d, eps=eps, stack=s)
        self.fc1 = tnn.Linear(d, ffn, stack=s)
        self.fc2 = tnn.Linear(ffn, d, stack=s)


class _Encoder(nn.Module):
    def __init__(self, cfg: Wav2VecConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.pos_conv = _Conv(d, d // cfg.num_conv_pos_embedding_groups,
                              cfg.num_conv_pos_embeddings)
        self.layers = _Layers(d, cfg.intermediate_size, cfg.num_hidden_layers, eps)
        self.final_norm = tnn.LayerNorm(d, eps=eps)


class Wav2VecEncoder(nn.Module):
    def __init__(self, cfg: Wav2VecConfig = Wav2VecConfig()):
        super().__init__()
        if cfg.feat_extract_norm != "layer" or not cfg.do_stable_layer_norm:
            raise NotImplementedError(
                "only the stable-LN xls-r wav2vec2 layout is ported; the "
                "group-norm/HuBERT layout is ROADMAP.md Queue 1 item 12")
        if cfg.use_flash_attention:
            raise NotImplementedError(
                "the flash-attention kernel is not ported yet "
                "(ROADMAP.md Queue 2, ops/attention.py)")
        self.cfg = cfg
        eps = cfg.layer_norm_eps
        in_chs = (1,) + tuple(cfg.conv_dim[:-1])
        self.feature_extractor = nn.ModuleList(
            _ConvLayer(o, i, k, cfg.conv_bias, eps)
            for o, i, k in zip(cfg.conv_dim, in_chs, cfg.conv_kernel))
        self.feature_projection = _FeatureProjection(cfg.conv_dim[-1], cfg.hidden_size, eps)
        self.encoder = _Encoder(cfg)

    def init(self, gen: torch.Generator) -> "Wav2VecEncoder":
        cfg = self.cfg
        for layer in self.feature_extractor:
            w = layer.conv.w.data
            tnn.kaiming_uniform(w, w.shape[1] * w.shape[2], gen)
        pos_w = self.encoder.pos_conv.w.data
        tnn.kaiming_uniform(pos_w, pos_w.shape[1] * pos_w.shape[2], gen)
        tnn.linear_init(self.feature_projection.proj, gen)
        lay = self.encoder.layers
        for lin in (lay.q, lay.k, lay.v, lay.out, lay.fc1, lay.fc2):
            tnn.linear_init(lin, gen)
        return self

    def extract_features(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T_samples) -> (B, T_frames, conv_dim): conv -> channel LN -> erf-GELU."""
        x = audio[:, None, :]
        for layer, stride in zip(self.feature_extractor, self.cfg.conv_stride):
            x = conv1d(x, layer.conv.w, layer.conv.b, stride=stride)
            x = layer.norm(x.transpose(1, 2)).transpose(1, 2)
            x = tnn.gelu_erf(x)
        return x.transpose(1, 2)

    def _pos_conv_embed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        p = self.encoder.pos_conv
        h = conv1d(x.transpose(1, 2), p.w, p.b,
                     padding=cfg.num_conv_pos_embeddings // 2,
                     groups=cfg.num_conv_pos_embedding_groups)
        if cfg.num_conv_pos_embeddings % 2 == 0:  # SamePad: drop trailing step
            h = h[..., :-1]
        return tnn.gelu_erf(h.transpose(1, 2))

    def pack_fused(self, dtype: torch.dtype = torch.float32) -> dict:
        """Weight pack of the encoder layers for the block-stack kernel; pass it
        to ``encode``/``forward`` as ``fused_pack``."""
        return pack_encoder_weights(self.encoder.layers, dtype=dtype)

    def encode(self, features: torch.Tensor, fused_pack: dict | None = None) -> torch.Tensor:
        """Feature projection + pre-LN transformer encoder + final LN."""
        cfg = self.cfg
        num_heads = cfg.num_attention_heads
        fp = self.feature_projection
        x = fp.proj(fp.norm(features))
        x = x + self._pos_conv_embed(x)
        if fused_pack is not None and (x.shape[0] == 1 or pack_batched_ok(fused_pack)):
            x = encoder_block_stack(x.float(), fused_pack, num_heads=num_heads,
                                    eps=cfg.layer_norm_eps)
            return self.encoder.final_norm(x)
        lay = self.encoder.layers
        # one (d, 3d) q/k/v matmul per layer, as the JAX XLA path fuses them
        w_qkv = torch.cat([lay.q.w, lay.k.w, lay.v.w], dim=-1)
        b_qkv = torch.cat([lay.q.b, lay.k.b, lay.v.b], dim=-1)
        for i in range(cfg.num_hidden_layers):
            y = lay.norm1(x, i)
            qkv = torch.matmul(y, w_qkv[i]) + b_qkv[i]
            q, k, v = (tnn.split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
            attn = tnn.merge_heads(tnn.sdpa(q, k, v, scale=q.shape[-1] ** -0.5))
            x = x + lay.out(attn, i)
            y = lay.norm2(x, i)
            x = x + lay.fc2(tnn.gelu_erf(lay.fc1(y, i)), i)
        return self.encoder.final_norm(x)

    def forward(self, audio: torch.Tensor, fused_pack: dict | None = None) -> torch.Tensor:
        """Full forward: z-norm -> convs -> encoder. (B, T) -> (B, frames, d)."""
        return self.encode(self.extract_features(normalize_audio(audio)), fused_pack)

    def num_output_frames(self, num_samples: int) -> int:
        return self.cfg.num_output_frames(num_samples)
