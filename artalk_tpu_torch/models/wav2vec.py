"""wav2vec2 audio encoder: the xls-r (stable-LN) and base/HuBERT layouts.

Counterpart of ``artalk_tpu/models/wav2vec.py`` on its XLA path: per-utterance
z-norm with unbiased std -> conv stack -> feature projection -> grouped
positional conv (SamePad drops the trailing step for an even kernel) -> the
encoder layers. Two layouts, as in HF's wav2vec2 family:

- ``feat_extract_norm="layer"`` + ``do_stable_layer_norm=True`` (xls-r-300m,
  the production encoder): every conv is followed by a channel LayerNorm and
  erf-GELU; pre-LN layers; the final LayerNorm after the stack. For the 4 s
  window (64 000 samples) the conv stack yields 199 frames.
- ``feat_extract_norm="group"`` + ``do_stable_layer_norm=False`` (base and
  HuBERT, ``models/hubert.py``): conv0 is followed by a per-channel norm over
  time (biased variance), later convs by GELU alone (only conv0 has a
  ``norm``); the encoder LayerNorm comes before the stack, and each layer is
  LN(h + attention), then LN(h + FFN).

The conv front (z-norm, feature convs, projection, positional conv and its
residual) runs under the device-timed span ``wav2vec.frontend``. With
bfloat16 audio and parameters in the "layer" layout and no input that needs a
gradient (``frontend_takes``: the bf16 modes of the AR model, which pass the
pack they built once) its eight convolutions go through the kernels of
``ops/conv_frontend.py``; elsewhere (float32, the "group" layout, training)
through ``conv1d`` (cuDNN on the card).

With ``use_flash_attention`` the layer loop's attention runs through the
flash-attention kernel (``ops/attention.py``) instead of the plain softmax.
With a ``fused_pack`` (``pack_fused``; stable layout) the layers run as one
launch of the encoder block-stack kernel (``ops/encoder_block_stack.py``)
instead of the layer loop, so the flash kernel does not launch. The caller
decides which batches go through the kernel (``ar_model.kernel_takes``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Wav2VecConfig
from ..ops import conv_frontend as cf
from ..ops.attention import flash_attention
from ..ops.conv_frontend import conv1d, pos_conv_embed
from ..ops.encoder_block_stack import encoder_block_stack, pack_encoder_weights
from ..utils.metrics import GLOBAL_METRICS
from . import nn as tnn


def normalize_audio(audio: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-utterance z-norm with torch ``std`` semantics (unbiased, ddof=1)."""
    mean = audio.mean(dim=-1, keepdim=True)
    n = audio.shape[-1]
    var = (audio - mean).square().sum(dim=-1, keepdim=True) / (n - 1)
    return (audio - mean) / (torch.sqrt(var) + eps)


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
    """A conv, with the ``norm`` parameters (scale, bias) where the layout has
    them: every layer in "layer" mode, conv0 alone in "group" mode."""

    def __init__(self, out_ch: int, in_ch: int, k: int, bias: bool, eps: float, norm: bool):
        super().__init__()
        self.conv = _Conv(out_ch, in_ch, k, bias)
        self.norm = tnn.LayerNorm(out_ch, eps=eps) if norm else None


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
        if cfg.feat_extract_norm not in ("layer", "group"):
            raise ValueError(f"feat_extract_norm {cfg.feat_extract_norm!r}: "
                             "expected 'layer' or 'group'")
        self.cfg = cfg
        eps = cfg.layer_norm_eps
        in_chs = (1,) + tuple(cfg.conv_dim[:-1])
        self.feature_extractor = nn.ModuleList(
            _ConvLayer(o, i, k, cfg.conv_bias, eps,
                       norm=cfg.feat_extract_norm == "layer" or n == 0)
            for n, (o, i, k) in enumerate(zip(cfg.conv_dim, in_chs, cfg.conv_kernel)))
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
        """(B, T_samples) -> (B, T_frames, conv_dim): each conv, its norm
        (a channel LayerNorm in "layer" mode; in "group" mode, on conv0 only,
        per-channel normalisation over time with biased variance), erf-GELU."""
        cfg = self.cfg
        x = audio[:, None, :]
        for layer, stride in zip(self.feature_extractor, cfg.conv_stride):
            x = conv1d(x, layer.conv.w, layer.conv.b, stride=stride)
            if cfg.feat_extract_norm == "layer":
                x = layer.norm(x.transpose(1, 2)).transpose(1, 2)
            elif layer.norm is not None:
                mean = x.mean(dim=-1, keepdim=True)
                var = (x - mean).square().mean(dim=-1, keepdim=True)
                x = (x - mean) / torch.sqrt(var + cfg.layer_norm_eps)
                x = x * layer.norm.scale[:, None] + layer.norm.bias[:, None]
            x = tnn.gelu_erf(x)
        return x.transpose(1, 2)

    def _pos_conv_embed(self, x: torch.Tensor) -> torch.Tensor:
        p = self.encoder.pos_conv
        return pos_conv_embed(x, p.w, p.b, self.cfg.num_conv_pos_embedding_groups)

    def _project(self, features: torch.Tensor) -> torch.Tensor:
        fp = self.feature_projection
        return fp.proj(fp.norm(features))

    def _embed(self, features: torch.Tensor) -> torch.Tensor:
        """Feature projection, then + the positional embedding."""
        x = self._project(features)
        return x + self._pos_conv_embed(x)

    def pack_frontend(self) -> dict:
        """The bf16 weight pack of the conv front's kernels
        (``ops/conv_frontend.py``); pass it to ``forward`` as ``frontend_pack``."""
        return cf.pack_frontend(self)

    def frontend_takes(self, audio: torch.Tensor) -> bool:
        """Does ``ops/conv_frontend.conv_frontend`` run this audio's conv front:
        bfloat16 audio and parameters in the "layer" layout with conv biases
        (XLS-R's), no input that needs a gradient, and on the card widths the
        kernels take? Elsewhere (float32, the "group" layout, training) the
        eager path runs it."""
        conv0 = self.feature_extractor[0].conv.w
        if audio.dtype != torch.bfloat16 or conv0.dtype != torch.bfloat16:
            return False
        if not cf.layout_takes(self.cfg):
            return False
        params = (*self.feature_extractor.parameters(),
                  *self.feature_projection.parameters(), *self.encoder.pos_conv.parameters())
        if torch.is_grad_enabled() and (audio.requires_grad
                                        or any(p.requires_grad for p in params)):
            return False
        return audio.device.type == "cpu" or cf.supports(self.cfg)

    def frontend(self, audio: torch.Tensor, frontend_pack: dict | None = None) -> torch.Tensor:
        """z-norm -> conv stack -> feature projection -> + positional
        embedding: (B, T_samples) -> (B, frames, d), under the device-timed
        span ``wav2vec.frontend``. Through the conv front's kernels where
        ``frontend_takes`` (with ``frontend_pack``, or one packed here), else
        the eager path."""
        with GLOBAL_METRICS.span("wav2vec.frontend", device=audio.device):
            audio = normalize_audio(audio)
            if self.frontend_takes(audio):
                pack = frontend_pack if frontend_pack is not None else self.pack_frontend()
                return cf.conv_frontend(audio, pack, self._project)
            return self._embed(self.extract_features(audio))

    def pack_fused(self, dtype: torch.dtype = torch.float32) -> dict:
        """Weight pack of the encoder layers for the block-stack kernel; pass it
        to ``encode``/``forward`` as ``fused_pack``."""
        return pack_encoder_weights(self.encoder.layers, dtype=dtype)

    def encode(self, features: torch.Tensor, fused_pack: dict | None = None) -> torch.Tensor:
        """Feature projection + transformer encoder: pre-LN layers and the
        final LN after them (stable layout), or the encoder LN first and
        post-LN layers (base/HuBERT layout)."""
        return self.encode_embedded(self._embed(features), fused_pack)

    def encode_embedded(self, x: torch.Tensor, fused_pack: dict | None = None) -> torch.Tensor:
        """The transformer encoder of the embedded features (after the
        projection and the positional embedding)."""
        cfg = self.cfg
        num_heads = cfg.num_attention_heads
        stable = cfg.do_stable_layer_norm
        if not stable:
            x = self.encoder.final_norm(x)
        if fused_pack is not None and stable:
            x = encoder_block_stack(x.float(), fused_pack, num_heads=num_heads,
                                    eps=cfg.layer_norm_eps)
            return self.encoder.final_norm(x)
        lay = self.encoder.layers
        attend = flash_attention if cfg.use_flash_attention else tnn.sdpa
        # one (d, 3d) q/k/v matmul per layer, as the JAX XLA path fuses them
        w_qkv = torch.cat([lay.q.w, lay.k.w, lay.v.w], dim=-1)
        b_qkv = torch.cat([lay.q.b, lay.k.b, lay.v.b], dim=-1)
        for i in range(cfg.num_hidden_layers):
            y = lay.norm1(x, i) if stable else x
            qkv = torch.matmul(y, w_qkv[i]) + b_qkv[i]
            q, k, v = (tnn.split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
            attn = lay.out(tnn.merge_heads(attend(q, k, v, scale=q.shape[-1] ** -0.5)), i)
            if stable:
                x = x + attn
                x = x + lay.fc2(tnn.gelu_erf(lay.fc1(lay.norm2(x, i), i)), i)
            else:
                x = lay.norm1(x + attn, i)
                x = lay.norm2(x + lay.fc2(tnn.gelu_erf(lay.fc1(x, i)), i), i)
        return self.encoder.final_norm(x) if stable else x

    def forward(self, audio: torch.Tensor, fused_pack: dict | None = None,
                frontend_pack: dict | None = None) -> torch.Tensor:
        """Full forward: z-norm -> convs -> encoder. (B, T) -> (B, frames, d)."""
        return self.encode_embedded(self.frontend(audio, frontend_pack), fused_pack)

    def num_output_frames(self, num_samples: int) -> int:
        return self.cfg.num_output_frames(num_samples)
