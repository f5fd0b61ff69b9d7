"""BitwiseARModel: VAR-style multi-scale autoregressive motion generator.

Counterpart of ``artalk_tpu/models/ar_model.py`` on its inference paths:
exact float32 by default, the 12 AdaLN blocks run block by block (the JAX XLA
scan), greedy decode unless the caller asks for top-k/top-p sampling. An
audio-conditioned AdaLN transformer generates binary BSQ motion codes scale
by scale (1 -> 5 -> 25 -> 50 -> 100 tokens) over 4 s windows, with
the previous window's encoded summary as an attention prefix.

The decode is KV-cached as in JAX: each level's tokens run through the blocks
once and append their K/V to a cache laid out as ``[prev prefix | levels]``,
so the level-causal mask is the cache extent. The caches are local to one
window and are written in place.

The audio encoder is the wav2vec2 encoder (``models/wav2vec.py``; its
``use_flash_attention`` routes the layers' attention through the
flash-attention kernel), with ``ARConfig.audio_encoder = "mimi"`` the Mimi
codec (``models/mimi.py``: 512-d conditioning at 12.5 Hz), or with
``"whisper"`` Whisper large-v3's encoder (``models/whisper.py``: 1280-d at
50 Hz, attention through the flash-attention kernel). Whisper takes a fixed
30 s of audio, so its carry holds a third tensor, ``WindowState.audio_ctx``:
the 26 s before the window (zeros before the stream's start), and each
window is conditioned on the last 200 of the 1,500 positions of the 30 s that
end with it (its own 4 s). The other encoders carry ``audio_ctx = None``.

The model owns its precision mode (``config.precision_from_env`` reads it):
``set_precision`` sets the configuration's switches and builds, or drops,
the block stacks' weight packs, and the switches route the decode as the JAX
model does. ``bf16_audio`` runs the wav2vec2 encoder in bfloat16 (Mimi stays
float32; the XLS-R conv front through ``ops/conv_frontend.py`` with the weight
pack ``frontend_pack`` builds once), and Whisper's stem and layers on the
bfloat16 copies of its weights that ``audio_weights`` builds once;
``bf16_ar`` the block walk; ``fused_ar``
runs each level's blocks as one launch of the AR block-stack kernel (``ops/ar_block_stack.py``)
against a merged-head cache, and the wav2vec2 stable-LN encoder layers as one
launch of ``ops/encoder_block_stack.py`` (Mimi, Whisper and the post-LN layout
have no fused path), with float32, bfloat16 or (``int8_ar``) int8 weight packs
(``pack_type``). Float32 packs keep the JAX package's routing rules
(``kernel_takes``): the AR kernel at batch <= 2 only, the encoder kernel at
batch 1 only.

Sampling (``topk_topp_mask``, ``sample_with_top_k_top_p`` and the ``sample=``
argument of the head, the window decode and the window steps) draws from a
``torch.Generator`` on the logits' device, one draw per level in order, where
JAX splits one key per window and per level: the filter is JAX's, the draws
are not.

A window step records three spans (``utils/metrics.GLOBAL_METRICS``; each
times the host, and records nothing inside ``torch.export``):
``window.encode`` (the audio condition), ``window.decode`` (the AR level
walk) and ``window.vae`` (the VAE decode, the carry's re-encode and the new
prefix).

Training (``training/``) uses the teacher-forced ``forward_logits``: all 181
tokens at once under the explicit VAR mask (``var_attn_bias``), with DropPath
masks drawn by ``drop_path_masks`` from a ``torch.Generator`` (JAX draws them
from keys inside the forward; a caller that needs JAX's draws passes them in).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..ops import conv_frontend
from ..ops.ar_block_stack import ar_block_stack, pack_block_weights
from ..ops.resample1d import resize_area, resize_linear
from ..utils.metrics import GLOBAL_METRICS
from . import nn as tnn
from .bitwise_vae import BitwiseVAE
from .bsq import bits_to_values
from .mimi import MimiEncoder
from .style_encoder import StyleEncoder
from .wav2vec import Wav2VecEncoder
from .whisper import WhisperEncoder


# The float32 packs' largest batch per block stack, as the JAX package routes
# them (its float32 tiles are a parity mode, not a speed path); bf16 and int8
# packs run at any batch.
F32_PACK_MAX_BATCH = {"ar": 2, "encoder": 1}


def pack_type(cfg: ModelConfig, stack: str) -> torch.dtype:
    """The weight type of ``stack``'s pack ("ar": the AdaLN blocks;
    "encoder": the wav2vec2 layers) in ``cfg``'s mode: int8 with
    ``int8_ar``, else bfloat16 where the stack computes in bf16 (``bf16_ar``,
    ``bf16_audio``), else float32."""
    if cfg.int8_ar:
        return torch.int8
    return torch.bfloat16 if (cfg.bf16_ar if stack == "ar" else cfg.bf16_audio) else torch.float32


def kernel_takes(cfg: ModelConfig, stack: str, batch: int) -> bool:
    """Does ``stack``'s block-stack kernel run a batch of ``batch`` rows in
    ``cfg``'s mode? Only with ``fused_ar``, and a float32 pack only up to
    ``F32_PACK_MAX_BATCH``."""
    return cfg.fused_ar and (pack_type(cfg, stack) != torch.float32
                             or batch <= F32_PACK_MAX_BATCH[stack])


def topk_topp_mask(logits: torch.Tensor, top_k: int = 2,
                   top_p: float = 0.95) -> torch.Tensor:
    """VAR's sampling filter, as the JAX ``topk_topp_mask``: keep the top-k
    logits per distribution (entries tied with the k-th stay), then drop the
    ascending tail whose cumulative probability is <= 1 - top_p (the largest
    logit is always kept). Removed entries go to -inf. The ascending sort is
    stable, as ``jnp.argsort`` is, so tied logits keep their order."""
    v = logits.shape[-1]
    if top_k > 0 and top_k < v:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p > 0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, stable=True)
        remove = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1) <= (1.0 - top_p)
        remove[..., -1:] = False
        logits = logits.masked_fill(remove.scatter(-1, sort_idx, remove), -math.inf)
    return logits


def sample_with_top_k_top_p(logits: torch.Tensor, generator: torch.Generator,
                            top_k: int = 2, top_p: float = 0.95) -> torch.Tensor:
    """Categorical sample over the filtered logits (last axis), by the
    Gumbel-max rule as ``jax.random.categorical``. ``generator`` lives on the
    logits' device; the uniforms are kept above 0 so that a kept entry's
    Gumbel noise is finite and a removed entry is never drawn."""
    masked = topk_topp_mask(logits, top_k, top_p)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(masked + gumbel, dim=-1)


def drop_path_masks(rates: torch.Tensor, batch: int,
                    generator: torch.Generator) -> torch.Tensor:
    """DropPath (stochastic depth) keep masks, (depth, 2, batch) float32 in
    {0, 1}: branch j (attention, MLP) of block i is kept for sample b with
    probability 1 - rates[i], as ``jax.random.bernoulli`` draws it (a uniform
    below the keep probability). Drawn from ``generator`` on its device."""
    u = torch.rand((rates.shape[0], 2, batch), generator=generator,
                   device=generator.device)
    return (u < (1.0 - rates.to(u.device))[:, None, None]).float()


class WindowState(NamedTuple):
    """Sliding-window carry."""

    prev_bits: torch.Tensor       # (B, sum(patch_nums), code_dim) int32
    prev_attn_feat: torch.Tensor  # (B, prev_len, embed)
    # Whisper only: (B, context - window samples) float32, the audio before
    # the window, zeros before the stream's start; None for the other encoders
    audio_ctx: Optional[torch.Tensor] = None


class _Blocks(nn.Module):
    """The AdaLN blocks, parameters stacked along a leading depth axis."""

    def __init__(self, depth: int, d: int, cd: int, hidden: int, num_heads: int):
        super().__init__()
        s = (depth,)
        self.ada_lin = tnn.Linear(cd, 6 * d, stack=s)
        self.q = tnn.Linear(d, d, stack=s)
        self.k = tnn.Linear(d, d, bias=False, stack=s)
        self.v = tnn.Linear(d, d, stack=s)
        self.proj = tnn.Linear(d, d, stack=s)
        # learned per-head log attention scale, init log(4)
        self.scale_mul = nn.Parameter(torch.full((depth, 1, num_heads, 1, 1), math.log(4.0)))
        self.fc1 = tnn.Linear(d, hidden, stack=s)
        self.fc2 = tnn.Linear(hidden, d, stack=s)


class _Head(nn.Module):
    def __init__(self, cd: int, d: int, code_dim: int):
        super().__init__()
        self.ada_lin = tnn.Linear(cd, 2 * d)
        self.out = tnn.Linear(d, code_dim * 2)


class BitwiseARModel(nn.Module):
    """The parameters do not require grad when built: serving runs without
    autograd. The trainer (``training/trainer.py``) turns grads on."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.patch_nums = tuple(cfg.vae.patch_nums)
        self.total_tokens = sum(self.patch_nums)
        self.offsets = [sum(self.patch_nums[:i]) for i in range(len(self.patch_nums))]
        self.embed_dim = d = cfg.ar.embed_dim
        self.depth = cfg.ar.depth
        self.num_heads = cfg.ar.num_heads
        self.head_dim = d // self.num_heads
        self.prev_ratio = cfg.ar.prev_ratio
        self.prev_len = self.total_tokens * self.prev_ratio
        self.cache_len = self.prev_len + self.total_tokens
        self.window_samples = cfg.window_audio_samples
        cd = cfg.ar.audio_feature_dim

        self.vae = BitwiseVAE(cfg.vae)
        self.style_encoder = StyleEncoder(motion_dim=cfg.vae.motion_dim,
                                          feature_dim=cfg.ar.style_dim)
        if cfg.ar.audio_encoder == "wav2vec":
            self.audio_encoder = Wav2VecEncoder(cfg.wav2vec)
        elif cfg.ar.audio_encoder == "mimi":
            self.audio_encoder = MimiEncoder(cfg.mimi)
        elif cfg.ar.audio_encoder == "whisper":
            w = cfg.whisper
            if cd != w.d_model or self.window_samples > w.n_samples \
                    or self.window_samples % (2 * w.hop_length):
                raise ValueError(
                    f"whisper: AdaLN input {cd} for d_model {w.d_model}, or a window of "
                    f"{self.window_samples} samples that is not whole positions of the "
                    f"{w.n_samples}-sample context")
            self.audio_encoder = WhisperEncoder(w)
        else:
            raise ValueError(f"unknown audio encoder {cfg.ar.audio_encoder!r}")
        self.vqfeat_embed = tnn.Linear(cfg.vae.code_dim, d)
        self.style_cond_embed = tnn.Linear(cfg.ar.style_dim, d)
        self.blocks = _Blocks(self.depth, d, cd, round(d * cfg.ar.mlp_ratio), self.num_heads)
        self.head = _Head(cd, d, cfg.vae.code_dim)
        self.null_style_cond = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, self.total_tokens, d))
        self.prev_pos_embed = nn.Parameter(torch.empty(1, self.prev_len, d))
        self.lvl_embed = nn.Parameter(torch.empty(len(self.patch_nums), d))
        self.register_buffer("_lvl_idx", torch.cat([
            torch.full((pn,), i, dtype=torch.long) for i, pn in enumerate(self.patch_nums)
        ]), persistent=False)
        # the fused paths' weight packs, built by set_precision, the bf16
        # conv front's (``frontend_pack``) and Whisper's bf16 weights
        # (``audio_weights``)
        self.fused_pack: Optional[dict] = None
        self.fused_audio_pack: Optional[dict] = None
        self._frontend_pack: Optional[dict] = None
        self._audio_weights: Optional[dict] = None
        self.requires_grad_(False)

    # ------------------------------------------------------------------ init

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "BitwiseARModel":
        """Random init in place, torch-default distributions (as the JAX
        ``init``, which these match in distribution, not in values)."""
        pe_std = math.sqrt(1 / self.embed_dim / 3)
        self.vae.init(gen)
        self.style_encoder.init(gen)
        self.audio_encoder.init(gen)
        b = self.blocks
        for lin in (self.vqfeat_embed, self.style_cond_embed, b.ada_lin, b.q, b.k, b.v,
                    b.proj, b.fc1, b.fc2, self.head.ada_lin, self.head.out):
            tnn.linear_init(lin, gen)
        b.scale_mul.fill_(math.log(4.0))
        self.null_style_cond.copy_(torch.randn(self.null_style_cond.shape, generator=gen) * 0.5)
        for p in (self.pos_embed, self.prev_pos_embed, self.lvl_embed):
            tnn.trunc_normal(p.data, gen, std=pe_std)
        return self

    # -------------------------------------------------------------- embeddings

    def lvl_pos_embed(self) -> torch.Tensor:
        """(1, 181, d): level embedding + absolute position embedding."""
        return self.lvl_embed[self._lvl_idx][None] + self.pos_embed

    def prev_lvl_pos_embed(self) -> torch.Tensor:
        """(1, prev_len, d) for the previous-window prefix."""
        lvl = self.lvl_embed[self._lvl_idx][None]
        return lvl.repeat(1, self.prev_ratio, 1) + self.prev_pos_embed

    def encode_style(self, style_motion: Optional[torch.Tensor]) -> torch.Tensor:
        """Style clip -> (B, 1, d) conditioning token, with the reference's
        extrapolation style*1.1 - null*0.1; the null token when None."""
        if style_motion is None:
            return self.null_style_cond
        cond = self.style_cond_embed(self.style_encoder(style_motion))[:, None]
        return cond * 1.1 - self.null_style_cond * 0.1

    # ---------------------------------------------------------------- attention

    def _block_weights(self, dtype: torch.dtype, layers) -> dict:
        """The stacked weights (``<layer>_w``) and biases (``<layer>_b``) of
        the named block layers, in ``dtype`` (the bf16_ar decode casts them;
        float32 returns the parameters)."""
        wts = {}
        for name in layers:
            lin = getattr(self.blocks, name)
            wts[f"{name}_w"] = lin.w.to(dtype)
            if lin.b is not None:
                wts[f"{name}_b"] = lin.b.to(dtype)
        return wts

    def _block_kv(self, i: int, x: torch.Tensor, wts: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block ``i``'s K/V heads for tokens x (keys L2-normalized)."""
        k = tnn.split_heads(torch.matmul(x, wts["k_w"][i]), self.num_heads)
        v = tnn.split_heads(torch.matmul(x, wts["v_w"][i]) + wts["v_b"][i], self.num_heads)
        return tnn.l2_normalize(k), v

    def init_cache(self, prev_feat: torch.Tensor, wts: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-block K/V caches (depth, B, H, cache_len, hd) with the
        previous-window prefix in positions [0, prev_len); the cache dtype
        follows ``prev_feat``."""
        b = prev_feat.shape[0]
        shape = (self.depth, b, self.num_heads, self.cache_len, self.head_dim)
        k_cache = prev_feat.new_zeros(shape)
        v_cache = prev_feat.new_zeros(shape)
        for i in range(self.depth):
            k_cache[i, :, :, : self.prev_len], v_cache[i, :, :, : self.prev_len] = \
                self._block_kv(i, prev_feat, wts)
        return k_cache, v_cache

    def init_cache_merged(self, prev_feat: torch.Tensor, wts: dict
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Merged-head caches (depth, B, cache_len, embed) for the block-stack
        kernel: the contents of ``init_cache`` with the heads folded into the
        feature axis."""
        b = prev_feat.shape[0]
        shape = (self.depth, b, self.cache_len, self.embed_dim)
        k_cache = prev_feat.new_zeros(shape)
        v_cache = prev_feat.new_zeros(shape)
        for i in range(self.depth):
            k, v = self._block_kv(i, prev_feat, wts)
            k_cache[i, :, : self.prev_len] = tnn.merge_heads(k)
            v_cache[i, :, : self.prev_len] = tnn.merge_heads(v)
        return k_cache, v_cache

    def set_precision(self, cfg: ModelConfig) -> None:
        """Decode in ``cfg``'s precision mode from now on: set ``cfg`` and, with
        ``fused_ar``, build both block stacks' weight packs from the current
        parameters on their device, or drop them; likewise the conv front's
        pack (``frontend_pack``) and Whisper's bf16 weights (``audio_weights``)
        in the bf16 modes. A call with the mode the model holds its packs for
        keeps them."""
        if cfg == self.cfg and (self.fused_pack is not None) == cfg.fused_ar:
            return
        self.cfg = cfg
        self.fused_pack = self._pack("ar") if cfg.fused_ar else None
        self.fused_audio_pack = self._pack("encoder") if cfg.fused_ar else None
        self._frontend_pack = self._audio_weights = None
        self.frontend_pack()
        self.audio_weights()

    def frontend_pack(self) -> Optional[dict]:
        """The wav2vec2 conv front's bf16 weight pack (``ops/conv_frontend.py``)
        where ``bf16_audio`` runs it in bfloat16 in the "layer" layout, else
        None: built by ``set_precision`` with the block stacks' packs, or on
        first use where the model's mode was set without it (a model built in
        its mode), and kept."""
        enc = self.audio_encoder
        if not (self.cfg.bf16_audio and isinstance(enc, Wav2VecEncoder)
                and conv_frontend.layout_takes(enc.cfg)):
            return None
        if self._frontend_pack is None:
            self._frontend_pack = enc.pack_frontend()
        return self._frontend_pack

    def audio_weights(self) -> Optional[dict]:
        """Whisper's parameters as bfloat16 copies, by name, where
        ``bf16_audio`` runs it in bfloat16, else None: built by
        ``set_precision``, or on first use where the model's mode was set
        without it, and kept (the encoder's buffers stay float32)."""
        enc = self.audio_encoder
        if not (self.cfg.bf16_audio and isinstance(enc, WhisperEncoder)):
            return None
        if self._audio_weights is None:
            self._audio_weights = {k: p.detach().to(torch.bfloat16)
                                   for k, p in enc.named_parameters()}
        return self._audio_weights

    def _pack(self, stack: str) -> Optional[dict]:
        """``stack``'s weight pack for its block-stack kernel ("ar", "encoder"),
        of ``pack_type``, packed from the float32 parameters; None where the
        encoder has no fused path: Mimi, Whisper, and the post-LN wav2vec2
        layout."""
        dtype = pack_type(self.cfg, stack)
        if stack == "ar":
            return pack_block_weights(self.blocks, self.num_heads, dtype=dtype)
        if self.cfg.ar.audio_encoder != "wav2vec" or not self.cfg.wav2vec.do_stable_layer_norm:
            return None
        return self.audio_encoder.pack_fused(dtype)

    def _kernel_pack(self, stack: str, batch: int) -> Optional[dict]:
        """The pack ``stack``'s kernel runs a batch of ``batch`` rows with, or
        None where the plain path runs it (``kernel_takes``). The pack that
        ``set_precision`` built; a model that holds none packs here, from its
        current weights, on every call: the trainer's ``fused_ar`` steps see
        new weights every step."""
        if not kernel_takes(self.cfg, stack, batch):
            return None
        if self.fused_pack is not None:
            return self.fused_pack if stack == "ar" else self.fused_audio_pack
        return self._pack(stack)

    def _run_level_fused(self, pack: dict, tokens: torch.Tensor, ada: torch.Tensor,
                         caches: Tuple[torch.Tensor, torch.Tensor], level: int) -> torch.Tensor:
        """Counterpart of ``_run_level`` through the block-stack kernel: one
        launch for all blocks; the level's K/V go into the merged caches in
        place. Tested to atol against ``_run_level``, not bit-pinned."""
        start = self.prev_len + self.offsets[level]
        end = start + self.patch_nums[level]
        k_cache, v_cache = caches
        feats, k_new, v_new = ar_block_stack(tokens, ada, pack, k_cache, v_cache,
                                             start=start, num_heads=self.num_heads)
        k_cache[:, :, start:end] = k_new
        v_cache[:, :, start:end] = v_new
        return feats

    def _fused_decode_consts(self, audio_cond: torch.Tensor):
        """Per-block quantities that do not depend on the level's hidden
        state, computed once per window: AdaLN for all blocks and positions,
        and the head's AdaLN scale/shift."""
        b = self.blocks
        silu_cond = tnn.silu(audio_cond)
        ada_full = (torch.einsum("bpc,dce->dbpe", silu_cond, b.ada_lin.w)
                    + b.ada_lin.b[:, None, None])
        head_ss = self.head.ada_lin(silu_cond).chunk(2, dim=-1)
        return ada_full, head_ss

    def _plain_qkv_consts(self, dtype: torch.dtype):
        """The plain block walk's fused (depth, d, 3d) q/k/v weights (k has
        no bias; a zero slot keeps the add exact) and the exp'd per-head
        attention scales, in ``dtype``."""
        b = self.blocks
        w_qkv = torch.cat([b.q.w, b.k.w, b.v.w], dim=-1)
        b_qkv = torch.cat([b.q.b, torch.zeros_like(b.q.b), b.v.b], dim=-1)
        scale_mul = torch.exp(torch.clamp(b.scale_mul, max=math.log(100.0)))
        return w_qkv.to(dtype), b_qkv.to(dtype), scale_mul.to(dtype)

    def _run_level(self, tokens: torch.Tensor, ada: torch.Tensor,
                   caches: Tuple[torch.Tensor, torch.Tensor], level: int,
                   w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                   scale_mul: torch.Tensor, wts: dict) -> torch.Tensor:
        """Run one level's new tokens (B, pn, d) through all blocks, writing
        their K/V into ``caches`` in place. Returns the features.

        ada: (depth, B, pn, 6d) AdaLN parameters at these positions."""
        start = self.prev_len + self.offsets[level]
        end = start + self.patch_nums[level]
        k_cache, v_cache = caches
        x = tokens
        for i in range(self.depth):
            g1, g2, s1, s2, sh1, sh2 = ada[i].chunk(6, dim=-1)
            xm = tnn.layer_norm(x, eps=1e-6) * (s1 + 1.0) + sh1
            qkv = torch.matmul(xm, w_qkv[i]) + b_qkv[i]
            q, k_new, v_new = (tnn.split_heads(t, self.num_heads)
                               for t in qkv.chunk(3, dim=-1))
            q = tnn.l2_normalize(q) * scale_mul[i]
            k_cache[i, :, :, start:end] = tnn.l2_normalize(k_new)
            v_cache[i, :, :, start:end] = v_new
            # level-causal mask is implicit: attend to [prev prefix | levels <= this]
            attn = tnn.sdpa(q, k_cache[i, :, :, :end], v_cache[i, :, :, :end], scale=1.0)
            x = x + (torch.matmul(tnn.merge_heads(attn), wts["proj_w"][i])
                     + wts["proj_b"][i]) * g1
            xm2 = tnn.layer_norm(x, eps=1e-6) * (s2 + 1.0) + sh2
            h = tnn.gelu_tanh(torch.matmul(xm2, wts["fc1_w"][i]) + wts["fc1_b"][i])
            x = x + (torch.matmul(h, wts["fc2_w"][i]) + wts["fc2_b"][i]) * g2
        return x

    def _head_logits(self, feats: torch.Tensor,
                     cond: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """AdaLN head: (B, L, code_dim, 2) float32 logits per bit. ``cond``
        is the precomputed (scale, shift) at these positions."""
        scale, shift = cond
        feats = tnn.layer_norm(feats, eps=1e-6) * (scale + 1.0) + shift
        logits = self.head.out(feats).float()
        b, l, _ = logits.shape
        return logits.reshape(b, l, -1, 2)

    def _head_bits(self, feats: torch.Tensor, cond: Tuple[torch.Tensor, torch.Tensor],
                   sample: Optional[tuple] = None) -> torch.Tensor:
        """AdaLN head + per-bit decision: greedy argmax by default, or
        top-k/top-p sampling when ``sample = (generator, top_k, top_p)``."""
        logits = self._head_logits(feats, cond)
        if sample is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        generator, top_k, top_p = sample
        return sample_with_top_k_top_p(logits, generator, top_k, top_p).to(torch.int32)

    # ------------------------------------------------------------ window decode

    def audio_condition(self, audio_chunk: torch.Tensor,
                        audio_ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, window_samples) audio -> (B, 181, audio_dim) multi-scale
        condition: encoder features area-resized to each scale.

        Mimi runs in float32 in every mode, as in the JAX package. With
        ``bf16_audio`` the wav2vec2 encoder runs on bfloat16 copies of its
        parameters and a bfloat16 chunk (norm statistics and softmax stay
        float32); with ``fused_ar`` its layers go through the block-stack
        kernel (float32 packs at batch 1 only). Whisper encodes the context
        ``audio_ctx`` (the carry's; None: zeros) followed by the chunk, on
        ``audio_weights`` in the bf16 modes, and keeps the positions of the
        chunk. The condition is float32."""
        cfg = self.cfg
        enc = self.audio_encoder
        fused_pack = self._kernel_pack("encoder", audio_chunk.shape[0])
        if isinstance(enc, MimiEncoder):
            feat = enc(audio_chunk)
        elif isinstance(enc, WhisperEncoder):
            if audio_ctx is None:
                audio_ctx = self.initial_audio_ctx(audio_chunk.shape[0], audio_chunk)
            full = torch.cat([audio_ctx, audio_chunk.float()], dim=1)
            weights = self.audio_weights()
            feat = enc(full) if weights is None else \
                torch.func.functional_call(enc, weights, (full,))
            feat = feat[:, -enc.cfg.window_positions(self.window_samples):]
        elif cfg.bf16_audio:
            tensors = {**dict(enc.named_parameters()), **dict(enc.named_buffers())}
            tensors = {k: t.to(torch.bfloat16) if t.dtype == torch.float32 else t
                       for k, t in tensors.items()}
            feat = torch.func.functional_call(enc, tensors, (audio_chunk.to(torch.bfloat16),),
                                              {"fused_pack": fused_pack,
                                               "frontend_pack": self.frontend_pack()})
        else:
            feat = enc(audio_chunk, fused_pack)
        feat = feat.float()
        return torch.cat([resize_area(feat, pn) for pn in self.patch_nums], dim=1)

    def decode_window(self, audio_cond: torch.Tensor, style_cond: torch.Tensor,
                      prev_attn_feat: torch.Tensor, sample: Optional[tuple] = None
                      ) -> torch.Tensor:
        """Code bits of one window, (B, 181, code_dim) int32: greedy, or
        top-k/top-p sampled level by level when ``sample = (generator, top_k,
        top_p)``.

        With ``bf16_ar`` the block walk runs in bfloat16 (weights, AdaLN
        parameters, attention scales, the prefix and the caches); the head
        and the inter-level arithmetic stay float32."""
        cfg = self.cfg
        lvl_pos = self.lvl_pos_embed()
        prev_feat = prev_attn_feat + self.prev_lvl_pos_embed()
        window = self.patch_nums[-1]
        code_dim = cfg.vae.code_dim
        b = audio_cond.shape[0]
        ada_full, (h_scale, h_shift) = self._fused_decode_consts(audio_cond)
        pack = self._kernel_pack("ar", b)
        use_fused = pack is not None
        cdt = torch.bfloat16 if cfg.bf16_ar else torch.float32
        wts = self._block_weights(cdt, ("k", "v") if use_fused
                                  else ("k", "v", "proj", "fc1", "fc2"))
        ada_full, prev_feat = ada_full.to(cdt), prev_feat.to(cdt)
        if use_fused:
            caches = self.init_cache_merged(prev_feat, wts)
        else:
            w_qkv, b_qkv, scale_mul = self._plain_qkv_consts(cdt)
            caches = self.init_cache(prev_feat, wts)

        f_hat = audio_cond.new_zeros((b, window, code_dim))
        tokens = (style_cond + lvl_pos[:, :1]).expand(b, 1, self.embed_dim)
        all_bits = []
        for level, pn in enumerate(self.patch_nums):
            off = self.offsets[level]
            ada = ada_full[:, :, off : off + pn]
            if use_fused:
                feats = self._run_level_fused(pack, tokens.to(cdt), ada, caches, level)
            else:
                feats = self._run_level(tokens.to(cdt), ada, caches, level, w_qkv, b_qkv,
                                        scale_mul, wts)
            bits = self._head_bits(feats.float(),
                                   (h_scale[:, off : off + pn], h_shift[:, off : off + pn]),
                                   sample)
            all_bits.append(bits)
            if level < len(self.patch_nums) - 1:
                next_pn = self.patch_nums[level + 1]
                f_hat = f_hat + resize_linear(bits_to_values(bits, code_dim), window)
                tokens = (self.vqfeat_embed(resize_area(f_hat, next_pn))
                          + lvl_pos[:, off + pn : off + pn + next_pn])
        return torch.cat(all_bits, dim=1)

    # ---------------------------------------------------------------- training

    def var_attn_bias(self) -> torch.Tensor:
        """(1, 1, 181, prev_len + 181) additive bias of the teacher-forced
        forward: the previous-window prefix all visible, then the
        level-causal VAR mask (a token sees the tokens of its level and the
        levels before)."""
        lvl = np.concatenate([np.full(pn, i) for i, pn in enumerate(self.patch_nums)])
        mask = np.where(lvl[:, None] >= lvl[None, :], 0.0, -np.inf).astype(np.float32)
        full = np.concatenate(
            [np.zeros((self.total_tokens, self.prev_len), np.float32), mask], axis=1)
        return torch.from_numpy(full)[None, None].to(self.pos_embed.device)

    def drop_path_rates(self) -> torch.Tensor:
        """Per-block stochastic-depth rates: linspace(0, 0.1 * depth / 24, depth)."""
        return torch.linspace(0.0, 0.1 * self.depth / 24.0, self.depth,
                              device=self.pos_embed.device)

    def forward_logits(self, tokens: torch.Tensor, audio_cond: torch.Tensor,
                       prev_attn_feat: torch.Tensor,
                       drop_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced forward of all 181 token inputs at once -> bit
        logits (B, 181, code_dim, 2), differentiable.

        ``drop_masks`` ((depth, 2, B), from ``drop_path_masks``) turns on
        DropPath: branch j of block i is multiplied per sample by its mask
        and divided by the keep probability 1 - rates[i]. None (eval) leaves
        both branches whole."""
        bias = self.var_attn_bias()
        prev_feat = prev_attn_feat + self.prev_lvl_pos_embed()
        x = tokens + self.lvl_pos_embed()
        b = self.blocks
        # block-state-independent work hoisted out of the block loop; q stays
        # separate because it projects hm while k/v project [prev_feat | hm]
        w_kv = torch.cat([b.k.w, b.v.w], dim=-1)
        b_kv = torch.cat([torch.zeros_like(b.v.b), b.v.b], dim=-1)
        scale_mul = torch.exp(torch.clamp(b.scale_mul, max=math.log(100.0)))
        ada_full, (h_scale, h_shift) = self._fused_decode_consts(audio_cond)
        keep = None if drop_masks is None else 1.0 - self.drop_path_rates()

        def drop(i: int, j: int, branch: torch.Tensor) -> torch.Tensor:
            if drop_masks is None:
                return branch
            return branch * drop_masks[i, j][:, None, None] / keep[i]

        for i in range(self.depth):
            g1, g2, s1, s2, sh1, sh2 = ada_full[i].chunk(6, dim=-1)
            hm = tnn.layer_norm(x, eps=1e-6) * (s1 + 1.0) + sh1
            q = tnn.l2_normalize(tnn.split_heads(b.q(hm, i), self.num_heads)) * scale_mul[i]
            kv = torch.matmul(torch.cat([prev_feat, hm], dim=1), w_kv[i]) + b_kv[i]
            k, v = (tnn.split_heads(t, self.num_heads) for t in kv.chunk(2, dim=-1))
            attn = tnn.sdpa(q, tnn.l2_normalize(k), v, scale=1.0, bias=bias)
            x = x + drop(i, 0, b.proj(tnn.merge_heads(attn), i) * g1)
            hm2 = tnn.layer_norm(x, eps=1e-6) * (s2 + 1.0) + sh2
            x = x + drop(i, 1, b.fc2(tnn.gelu_tanh(b.fc1(hm2, i)), i) * g2)
        return self._head_logits(x, (h_scale, h_shift))

    def teacher_inputs(self, bits: torch.Tensor, style_cond: torch.Tensor) -> torch.Tensor:
        """Teacher-forcing inputs: [style | embedded multi-scale feats of the
        target bits], (B, 181, d)."""
        style = style_cond.expand(bits.shape[0], 1, self.embed_dim)
        return torch.cat([style, self.vqfeat_embed(self.vae.bits_to_ms_feat(bits))], dim=1)

    # ------------------------------------------------------------ sliding window

    def initial_state(self, style_cond: torch.Tensor, batch_size: int = 1) -> WindowState:
        """Bootstrap carry from a zero-motion window (and, for Whisper, a
        silent context)."""
        zero_motion = style_cond.new_zeros(
            (batch_size, self.patch_nums[-1], self.cfg.vae.motion_dim))
        prev_bits, _ = self.vae.encode_to_bits(zero_motion)
        return WindowState(prev_bits, self._prefix_from_bits(style_cond, prev_bits, tile=True),
                           self.initial_audio_ctx(batch_size, style_cond))

    def initial_audio_ctx(self, batch_size: int, like: torch.Tensor
                          ) -> Optional[torch.Tensor]:
        """Whisper's silent context (batch_size, context - window samples),
        float32 on ``like``'s device; None for the other encoders."""
        enc = self.audio_encoder
        if not isinstance(enc, WhisperEncoder):
            return None
        return torch.zeros((batch_size, enc.cfg.n_samples - self.window_samples),
                           dtype=torch.float32, device=like.device)

    def roll_audio_ctx(self, audio_ctx: Optional[torch.Tensor], audio_chunk: torch.Tensor
                       ) -> Optional[torch.Tensor]:
        """The context after a window: the last (context - window) samples of
        the context followed by the chunk; None for the other encoders."""
        if not isinstance(self.audio_encoder, WhisperEncoder):
            return None
        if audio_ctx is None:
            audio_ctx = self.initial_audio_ctx(audio_chunk.shape[0], audio_chunk)
        return torch.cat([audio_ctx[:, self.window_samples:], audio_chunk.float()], dim=1)

    def _prefix_from_bits(self, style_cond: torch.Tensor, bits: torch.Tensor,
                          tile: bool = False) -> torch.Tensor:
        """[style token | embedded multi-scale feats] prefix."""
        ms_feat = self.vae.bits_to_ms_feat(bits)
        prefix = torch.cat(
            [style_cond.expand((bits.shape[0],) + style_cond.shape[1:]),
             self.vqfeat_embed(ms_feat)], dim=1)
        if tile:
            prefix = prefix.repeat(1, self.prev_ratio, 1)
        return prefix

    def window_step(self, state: WindowState, audio_chunk: torch.Tensor,
                    style_cond: torch.Tensor, sample: Optional[tuple] = None
                    ) -> Tuple[WindowState, torch.Tensor]:
        """One sliding-window step: (B, window_samples) audio -> 100 motion
        frames (B, window, motion_dim) + the new carry. ``sample`` as in
        ``decode_window``."""
        with GLOBAL_METRICS.span("window.encode"):
            audio_cond = self.audio_condition(audio_chunk, state.audio_ctx)
        new_state, motion = self.window_step_cond(state, audio_cond, style_cond, sample)
        return new_state._replace(audio_ctx=self.roll_audio_ctx(state.audio_ctx, audio_chunk)), \
            motion

    def window_step_cond(self, state: WindowState, audio_cond: torch.Tensor,
                         style_cond: torch.Tensor, sample: Optional[tuple] = None
                         ) -> Tuple[WindowState, torch.Tensor]:
        """Window step with the audio condition already computed; the
        carry's ``audio_ctx`` is passed on as it is."""
        with GLOBAL_METRICS.span("window.decode"):
            bits = self.decode_window(audio_cond, style_cond, state.prev_attn_feat, sample)
        with GLOBAL_METRICS.span("window.vae"):
            _, this_motion = self.vae.decode_from_bits(state.prev_bits, bits)
            new_prev_bits, _ = self.vae.encode_to_bits(this_motion)
            new_prefix = self._prefix_from_bits(style_cond, new_prev_bits)
        rolled = torch.cat(
            [state.prev_attn_feat[:, new_prefix.shape[1]:], new_prefix], dim=1)
        return WindowState(new_prev_bits, rolled, state.audio_ctx), this_motion

    def generate(self, audio_chunks: torch.Tensor, style_cond: torch.Tensor,
                 sample_generator: Optional[torch.Generator] = None, top_k: int = 2,
                 top_p: float = 0.95) -> torch.Tensor:
        """Offline decode: (N, B, window_samples) chunks ->
        (B, N*window, motion_dim) motions. Greedy unless ``sample_generator``
        (on the model's device) is given; then the bits are top-k/top-p
        sampled, window after window from that one generator.

        Unlike the JAX package, which encodes all N windows in one batched
        pass, the encoder runs window by window: offline and streaming decode
        then launch the same kernels at the same shapes, and agree bit for
        bit on the card. Whisper conditions each window on the 30 s that end
        with it: the clip's earlier chunks, carried in the state."""
        n, b = audio_chunks.shape[0], audio_chunks.shape[1]
        state = self.initial_state(style_cond, batch_size=b)
        sample = None if sample_generator is None else (sample_generator, top_k, top_p)
        motions = []
        for i in range(n):
            state, motion = self.window_step(state, audio_chunks[i], style_cond, sample)
            motions.append(motion)
        return torch.cat(motions, dim=1)
