"""BitwiseARModel of artalk_tpu_torch against JAX on the seed-0 JAX weights
(carried over by the parameter bridge): greedy decode bits equal, the
committed golden_small bits reproduced exactly, motions to atol 1e-5 (JAX
holds itself to 1e-6 there; the port's matmuls sum in another order); and
the port's cached decode against its own naive full-recompute decode, as
tests/test_ar_model.py holds JAX's."""

import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artalk_tpu_torch.models import nn as tnn
from artalk_tpu_torch.models.ar_model import WindowState

from test_ar_model import CFG
from test_torch_params import jax_model_and_flat, port_model, to_np
from test_torch_params import torch_threads  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_small.npz")


@pytest.fixture(scope="module")
def models():
    jm, jp, _ = jax_model_and_flat(CFG)
    return jm, jp, port_model(CFG)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_audio_condition_and_style(models, rng):
    jm, jp, tm = models
    audio = (rng.standard_normal((2, jm.window_samples)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(to_np(tm.audio_condition(torch.from_numpy(audio))),
                               np.asarray(jm.audio_condition(jp, jnp.asarray(audio))),
                               atol=1e-5)
    style = rng.standard_normal((2, 50, CFG.vae.motion_dim)).astype(np.float32)
    np.testing.assert_allclose(to_np(tm.encode_style(torch.from_numpy(style))),
                               np.asarray(jm.encode_style(jp, jnp.asarray(style))), atol=1e-5)
    np.testing.assert_array_equal(to_np(tm.encode_style(None)),
                                  np.asarray(jm.encode_style(jp, None)))


def test_decode_window_bits_equal(models, rng):
    """Same audio condition and prefix -> the same greedy bits, batch 2."""
    jm, jp, tm = models
    cond = rng.standard_normal((2, jm.total_tokens, CFG.ar.audio_feature_dim)).astype(np.float32)
    style = jm.encode_style(jp, None)
    state = jm.initial_state(jp, style, batch_size=2)
    tstate = tm.initial_state(tm.encode_style(None), batch_size=2)
    np.testing.assert_array_equal(to_np(tstate.prev_bits), np.asarray(state.prev_bits))
    np.testing.assert_allclose(to_np(tstate.prev_attn_feat), np.asarray(state.prev_attn_feat),
                               atol=1e-6)
    want = np.asarray(jm.decode_window(jp, jnp.asarray(cond), style, state.prev_attn_feat))
    got = to_np(tm.decode_window(torch.from_numpy(cond), _t(style), _t(state.prev_attn_feat)))
    np.testing.assert_array_equal(got, want)


def test_golden_small_reproduced(models):
    """tests/test_golden_regression.py's three windows through the port: the
    committed bits exactly, per level, and the motions to 1e-5."""
    jm, _, tm = models
    rng = np.random.default_rng(1234)
    chunks = (rng.standard_normal((3, 1, tm.window_samples)) * 0.1).astype(np.float32)
    with np.load(GOLDEN) as z:
        want_bits, want_motions = z["bits"], z["motions"]
    style = tm.encode_style(None)
    state = tm.initial_state(style)
    for i in range(chunks.shape[0]):
        chunk = torch.from_numpy(chunks[i])
        bits = to_np(tm.decode_window(tm.audio_condition(chunk), style,
                                      state.prev_attn_feat)).astype(np.int8)
        state, motion = tm.window_step(state, chunk, style)
        assert isinstance(state, WindowState)
        for level, (pn, off) in enumerate(zip(tm.patch_nums, tm.offsets)):
            np.testing.assert_array_equal(
                bits[:, off:off + pn], want_bits[i][:, off:off + pn],
                err_msg=f"window {i} level {level} (pn={pn}) code bits differ")
        np.testing.assert_allclose(to_np(motion), want_motions[i], atol=1e-5,
                                   err_msg=f"window {i} motions differ")


def test_golden_production_shape_reproduced():
    """The production geometry (768/12/12 AR over 181 tokens, 512/8/8 VAE,
    code_dim 32, the real wav2vec conv stack at 1024-d, 2 encoder layers) on
    JAX's seed-0 weights: tests/fixtures/golden_production.npz's bits exactly,
    per level, motions to 1e-5."""
    from test_golden_regression import PROD_FIXTURE, PROD_GOLDEN_CFG

    tm = port_model(PROD_GOLDEN_CFG)
    rng = np.random.default_rng(20260816)
    chunks = (rng.standard_normal((2, 1, tm.window_samples)) * 0.1).astype(np.float32)
    with np.load(PROD_FIXTURE) as z:
        want_bits, want_motions = z["bits"], z["motions"]
    style = tm.encode_style(None)
    state = tm.initial_state(style)
    for i in range(chunks.shape[0]):
        chunk = torch.from_numpy(chunks[i])
        bits = to_np(tm.decode_window(tm.audio_condition(chunk), style,
                                      state.prev_attn_feat)).astype(np.int8)
        state, motion = tm.window_step(state, chunk, style)
        for level, (pn, off) in enumerate(zip(tm.patch_nums, tm.offsets)):
            np.testing.assert_array_equal(
                bits[:, off:off + pn], want_bits[i][:, off:off + pn],
                err_msg=f"window {i} level {level} (pn={pn}) code bits differ")
        np.testing.assert_allclose(to_np(motion), want_motions[i], atol=1e-5)


def test_generate_matches_jax(models, rng):
    """Offline decode over 3 windows, batch 2: JAX encodes all windows in one
    batched pass, the port window by window; the motions agree to 1e-5."""
    jm, jp, tm = models
    chunks = (rng.standard_normal((3, 2, jm.window_samples)) * 0.1).astype(np.float32)
    style = jm.encode_style(jp, None)
    want = np.asarray(jm.generate(jp, jnp.asarray(chunks), style))
    got = to_np(tm.generate(torch.from_numpy(chunks), tm.encode_style(None)))
    assert got.shape == want.shape == (2, 3 * CFG.vae.window, CFG.vae.motion_dim)
    np.testing.assert_allclose(got, want, atol=1e-5)


def naive_decode(model, audio_cond, style_cond, prev_attn_feat):
    """The port's counterpart of tests/test_ar_model.py's ``naive_decode``:
    the literal reference decode, which at each level re-embeds all tokens
    of the levels so far, runs the whole tower with the explicit VAR mask
    (no cache) and takes the argmax bits of every position."""
    pn = model.patch_nums
    lvl_idx = np.concatenate([np.full(p, i) for i, p in enumerate(pn)])
    var_mask = np.where(lvl_idx[:, None] >= lvl_idx[None, :], 0.0, -np.inf)
    full_bias = torch.from_numpy(np.concatenate(
        [np.zeros((model.total_tokens, model.prev_len)), var_mask], axis=1).astype(np.float32))
    lvl_pos = model.lvl_pos_embed()
    prev_feat = prev_attn_feat + model.prev_lvl_pos_embed()
    b = model.blocks

    def run_tower(tokens, cond, bias):
        x = tokens
        for i in range(model.depth):
            g1, g2, s1, s2, sh1, sh2 = b.ada_lin(tnn.silu(cond), i).chunk(6, dim=-1)
            xm = tnn.layer_norm(x, eps=1e-6) * (s1 + 1.0) + sh1
            q = tnn.split_heads(b.q(xm, i), model.num_heads)
            kv_in = torch.cat([prev_feat, xm], dim=1)
            k = tnn.split_heads(b.k(kv_in, i), model.num_heads)
            v = tnn.split_heads(b.v(kv_in, i), model.num_heads)
            scale_mul = torch.exp(torch.clamp(b.scale_mul[i], max=math.log(100.0)))
            q, k = tnn.l2_normalize(q) * scale_mul, tnn.l2_normalize(k)
            attn = tnn.sdpa(q, k, v, scale=1.0, bias=bias[None, None])
            x = x + b.proj(tnn.merge_heads(attn), i) * g1
            xm2 = tnn.layer_norm(x, eps=1e-6) * (s2 + 1.0) + sh2
            x = x + b.fc2(tnn.gelu_tanh(b.fc1(xm2, i)), i) * g2
        return x

    batch = audio_cond.shape[0]
    style_cond = style_cond.expand(batch, 1, style_cond.shape[-1])
    next_tokens = style_cond + lvl_pos[:, :1]
    bits = None
    for level in range(len(pn)):
        cur = sum(pn[: level + 1])
        cond = audio_cond[:, :cur]
        feats = run_tower(next_tokens, cond, full_bias[:cur, : model.prev_len + cur])
        bits = model._head_bits(feats, model.head.ada_lin(tnn.silu(cond)).chunk(2, dim=-1))
        if level < len(pn) - 1:
            # rows of levels 1..level+1 depend only on levels 0..level
            padded = torch.cat([bits, bits.new_zeros(
                (batch, model.total_tokens - cur, bits.shape[-1]))], dim=1)
            nxt = model.vae.bits_to_ms_feat(padded)[:, : sum(pn[1 : level + 2])]
            next_tokens = torch.cat([style_cond, model.vqfeat_embed(nxt)], dim=1)
            next_tokens = next_tokens + lvl_pos[:, : next_tokens.shape[1]]
    return bits


def test_cached_decode_equals_naive(models, rng):
    """The KV-cached level decode (each level's tokens run once, the VAR mask
    implicit in the cache extent) gives the naive full-recompute decode's
    bits exactly, batch 2."""
    _, _, tm = models
    b = 2
    audio_cond = torch.from_numpy(
        rng.standard_normal((b, tm.total_tokens, CFG.ar.audio_feature_dim)).astype(np.float32))
    style_cond = torch.from_numpy(rng.standard_normal((1, 1, CFG.ar.embed_dim)).astype(np.float32))
    prev_attn_feat = torch.from_numpy(
        rng.standard_normal((b, tm.prev_len, CFG.ar.embed_dim)).astype(np.float32))
    with torch.no_grad():
        fast = to_np(tm.decode_window(audio_cond, style_cond, prev_attn_feat))
        slow = to_np(naive_decode(tm, audio_cond, style_cond, prev_attn_feat))
    assert fast.shape == slow.shape == (b, tm.total_tokens, CFG.vae.code_dim)
    np.testing.assert_array_equal(fast, slow)
