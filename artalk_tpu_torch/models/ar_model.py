"""BitwiseARModel: VAR-style multi-scale autoregressive motion generator.

Counterpart of ``artalk_tpu/models/ar_model.py`` on its default path: exact
float32, greedy decode, the 12 AdaLN blocks run block by block (the JAX XLA
scan). An audio-conditioned AdaLN transformer generates binary BSQ motion
codes scale by scale (1 -> 5 -> 25 -> 50 -> 100 tokens) over 4 s windows, with
the previous window's encoded summary as an attention prefix.

The decode is KV-cached as in JAX: each level's tokens run through the blocks
once and append their K/V to a cache laid out as ``[prev prefix | levels]``,
so the level-causal mask is the cache extent. The caches are local to one
window and are written in place.

Not ported yet: top-k/top-p sampling and the teacher-forced
``forward_logits`` (training), and the fused block-stack kernel
(ROADMAP.md Queue 2 item 1).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.resample1d import resize_area, resize_linear
from . import nn as tnn
from .bitwise_vae import BitwiseVAE
from .bsq import bits_to_values
from .style_encoder import StyleEncoder
from .wav2vec import Wav2VecEncoder


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configuration values whose code is not ported yet."""
    if cfg.ar.audio_encoder != "wav2vec":
        raise NotImplementedError(
            f"audio encoder {cfg.ar.audio_encoder!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 12)")


class WindowState(NamedTuple):
    """Sliding-window carry."""

    prev_bits: torch.Tensor       # (B, sum(patch_nums), code_dim) int32
    prev_attn_feat: torch.Tensor  # (B, prev_len, embed)


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
    """Inference-only (parameters do not require grad)."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        check_supported(cfg)
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
        self.audio_encoder = Wav2VecEncoder(cfg.wav2vec)
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

    def _block_kv(self, i: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block ``i``'s K/V heads for tokens x (keys L2-normalized)."""
        k = tnn.split_heads(self.blocks.k(x, i), self.num_heads)
        v = tnn.split_heads(self.blocks.v(x, i), self.num_heads)
        return tnn.l2_normalize(k), v

    def init_cache(self, prev_feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-block K/V caches (depth, B, H, cache_len, hd) with the
        previous-window prefix in positions [0, prev_len)."""
        b = prev_feat.shape[0]
        shape = (self.depth, b, self.num_heads, self.cache_len, self.head_dim)
        k_cache = prev_feat.new_zeros(shape)
        v_cache = prev_feat.new_zeros(shape)
        for i in range(self.depth):
            k_cache[i, :, :, : self.prev_len], v_cache[i, :, :, : self.prev_len] = \
                self._block_kv(i, prev_feat)
        return k_cache, v_cache

    def _fused_decode_consts(self, audio_cond: torch.Tensor):
        """Per-block quantities that do not depend on the level's hidden
        state, computed once per window: the fused (depth, d, 3d) q/k/v
        weights (k has no bias; a zero slot keeps the add exact), AdaLN for
        all blocks and positions, the exp'd per-head attention scales, and
        the head's AdaLN scale/shift."""
        b = self.blocks
        w_qkv = torch.cat([b.q.w, b.k.w, b.v.w], dim=-1)
        b_qkv = torch.cat([b.q.b, torch.zeros_like(b.q.b), b.v.b], dim=-1)
        scale_mul = torch.exp(torch.clamp(b.scale_mul, max=math.log(100.0)))
        silu_cond = tnn.silu(audio_cond)
        ada_full = (torch.einsum("bpc,dce->dbpe", silu_cond, b.ada_lin.w)
                    + b.ada_lin.b[:, None, None])
        head_ss = self.head.ada_lin(silu_cond).chunk(2, dim=-1)
        return w_qkv, b_qkv, scale_mul, ada_full, head_ss

    def _run_level(self, tokens: torch.Tensor, ada: torch.Tensor,
                   caches: Tuple[torch.Tensor, torch.Tensor], level: int,
                   w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                   scale_mul: torch.Tensor) -> torch.Tensor:
        """Run one level's new tokens (B, pn, d) through all blocks, writing
        their K/V into ``caches`` in place. Returns the features.

        ada: (depth, B, pn, 6d) AdaLN parameters at these positions."""
        start = self.prev_len + self.offsets[level]
        end = start + self.patch_nums[level]
        k_cache, v_cache = caches
        blk = self.blocks
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
            x = x + blk.proj(tnn.merge_heads(attn), i) * g1
            xm2 = tnn.layer_norm(x, eps=1e-6) * (s2 + 1.0) + sh2
            x = x + blk.fc2(tnn.gelu_tanh(blk.fc1(xm2, i)), i) * g2
        return x

    def _head_bits(self, feats: torch.Tensor,
                   cond: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """AdaLN head + greedy per-bit argmax. ``cond`` is the precomputed
        (scale, shift) at these positions."""
        scale, shift = cond
        feats = tnn.layer_norm(feats, eps=1e-6) * (scale + 1.0) + shift
        logits = self.head.out(feats).float()
        b, l, _ = logits.shape
        return torch.argmax(logits.reshape(b, l, -1, 2), dim=-1).to(torch.int32)

    # ------------------------------------------------------------ window decode

    def audio_condition(self, audio_chunk: torch.Tensor) -> torch.Tensor:
        """(B, window_samples) audio -> (B, 181, audio_dim) multi-scale
        condition: encoder features area-resized to each scale."""
        feat = self.audio_encoder(audio_chunk).float()
        return torch.cat([resize_area(feat, pn) for pn in self.patch_nums], dim=1)

    def decode_window(self, audio_cond: torch.Tensor, style_cond: torch.Tensor,
                      prev_attn_feat: torch.Tensor) -> torch.Tensor:
        """Greedy code bits of one window, (B, 181, code_dim) int32."""
        lvl_pos = self.lvl_pos_embed()
        prev_feat = prev_attn_feat + self.prev_lvl_pos_embed()
        window = self.patch_nums[-1]
        code_dim = self.cfg.vae.code_dim
        b = audio_cond.shape[0]
        w_qkv, b_qkv, scale_mul, ada_full, (h_scale, h_shift) = \
            self._fused_decode_consts(audio_cond)
        caches = self.init_cache(prev_feat)

        f_hat = audio_cond.new_zeros((b, window, code_dim))
        tokens = (style_cond + lvl_pos[:, :1]).expand(b, 1, self.embed_dim)
        all_bits = []
        for level, pn in enumerate(self.patch_nums):
            off = self.offsets[level]
            feats = self._run_level(tokens, ada_full[:, :, off : off + pn], caches, level,
                                    w_qkv, b_qkv, scale_mul)
            bits = self._head_bits(feats.float(),
                                   (h_scale[:, off : off + pn], h_shift[:, off : off + pn]))
            all_bits.append(bits)
            if level < len(self.patch_nums) - 1:
                next_pn = self.patch_nums[level + 1]
                f_hat = f_hat + resize_linear(bits_to_values(bits, code_dim), window)
                tokens = (self.vqfeat_embed(resize_area(f_hat, next_pn))
                          + lvl_pos[:, off + pn : off + pn + next_pn])
        return torch.cat(all_bits, dim=1)

    # ------------------------------------------------------------ sliding window

    def initial_state(self, style_cond: torch.Tensor, batch_size: int = 1) -> WindowState:
        """Bootstrap carry from a zero-motion window."""
        zero_motion = style_cond.new_zeros(
            (batch_size, self.patch_nums[-1], self.cfg.vae.motion_dim))
        prev_bits, _ = self.vae.encode_to_bits(zero_motion)
        return WindowState(prev_bits, self._prefix_from_bits(style_cond, prev_bits, tile=True))

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
                    style_cond: torch.Tensor) -> Tuple[WindowState, torch.Tensor]:
        """One sliding-window step: (B, window_samples) audio -> 100 motion
        frames (B, window, motion_dim) + the new carry."""
        return self.window_step_cond(state, self.audio_condition(audio_chunk), style_cond)

    def window_step_cond(self, state: WindowState, audio_cond: torch.Tensor,
                         style_cond: torch.Tensor) -> Tuple[WindowState, torch.Tensor]:
        """Window step with the audio condition already computed."""
        bits = self.decode_window(audio_cond, style_cond, state.prev_attn_feat)
        _, this_motion = self.vae.decode_from_bits(state.prev_bits, bits)
        new_prev_bits, _ = self.vae.encode_to_bits(this_motion)
        new_prefix = self._prefix_from_bits(style_cond, new_prev_bits)
        rolled = torch.cat(
            [state.prev_attn_feat[:, new_prefix.shape[1]:], new_prefix], dim=1)
        return WindowState(new_prev_bits, rolled), this_motion

    def generate(self, audio_chunks: torch.Tensor, style_cond: torch.Tensor) -> torch.Tensor:
        """Offline greedy decode: (N, B, window_samples) chunks ->
        (B, N*window, motion_dim) motions.

        Unlike the JAX package, which encodes all N windows in one batched
        pass, the encoder runs window by window: offline and streaming decode
        then launch the same kernels at the same shapes, and agree bit for
        bit on the card."""
        n, b = audio_chunks.shape[0], audio_chunks.shape[1]
        state = self.initial_state(style_cond, batch_size=b)
        motions = []
        for i in range(n):
            state, motion = self.window_step(state, audio_chunks[i], style_cond)
            motions.append(motion)
        return torch.cat(motions, dim=1)
