"""Top-k/top-p sampled decode of artalk_tpu_torch against JAX.

The port draws from a ``torch.Generator`` where JAX splits PRNG keys, so the
drawn bits differ by design; what is held to JAX is the filter and the greedy
limit. ``topk_topp_mask`` equals JAX's bit for bit (the -inf pattern and the
kept logits), at two logits per bit (v = 2, the decode's case) and at v = 8,
on random logits and on logits with planted ties. ``top_k=1, top_p=0``
sampling equals the greedy decode exactly, and JAX's greedy ``generate`` to
1e-5 (``test_torch_ar_model.py``'s tolerance). Every sampled bit lies inside
JAX's mask of the same logits, a seed reproduces its draws, and two seeds
differ."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artalk_tpu.models.ar_model import topk_topp_mask as jax_mask

from artalk_tpu_torch.models.ar_model import sample_with_top_k_top_p, topk_topp_mask

from test_ar_model import CFG
from test_torch_params import jax_model_and_flat, port_model, to_np
from test_torch_params import torch_threads  # noqa: F401 (autouse)

# the (top_k, top_p) pairs of tests/test_ar_model.py's filter test, and the
# decode's default
PAIRS = ((2, 0.95), (0, 0.9), (4, 0.0), (3, 0.5))


def _logits(rng, v: int, ties: bool) -> np.ndarray:
    x = rng.standard_normal((3, 5, 7, v)).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2          # many equal entries per row
        x[0, 0, :] = 0.25                # whole rows tied
        x[1, 1, :, : v // 2] = x[1, 1, :, v // 2:]
    return x


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("v", [2, 8])
@pytest.mark.parametrize("top_k,top_p", PAIRS)
def test_mask_equals_jax(rng, v, ties, top_k, top_p):
    logits = _logits(rng, v, ties)
    want = np.asarray(jax_mask(jnp.asarray(logits), top_k, top_p))
    got = to_np(topk_topp_mask(torch.from_numpy(logits), top_k, top_p))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).any(axis=-1).all()    # the largest logit is kept


@pytest.mark.parametrize("v,top_k,top_p", [(2, 2, 0.95), (2, 1, 0.0), (8, 3, 0.5), (8, 0, 0.9)])
def test_sampled_bits_lie_in_jax_mask(rng, v, top_k, top_p):
    logits = _logits(rng, v, ties=False) * 3.0
    mask = np.isfinite(np.asarray(jax_mask(jnp.asarray(logits), top_k, top_p)))
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        drawn = to_np(sample_with_top_k_top_p(torch.from_numpy(logits), gen, top_k, top_p))
        assert np.take_along_axis(mask, drawn[..., None], axis=-1).all()
    if (mask.sum(-1) > 1).any():     # a row with a choice draws both ways
        assert len(np.unique(drawn)) > 1


@pytest.fixture(scope="module")
def models():
    jm, jp, _ = jax_model_and_flat(CFG)
    return jm, jp, port_model(CFG)


def _chunks(rng, jm, n=2, b=1):
    return (rng.standard_normal((n, b, jm.window_samples)) * 0.1).astype(np.float32)


def test_topk1_equals_greedy_and_jax(models, rng):
    jm, jp, tm = models
    chunks = _chunks(rng, jm)
    style = tm.encode_style(None)
    greedy = to_np(tm.generate(torch.from_numpy(chunks), style))
    sampled = to_np(tm.generate(torch.from_numpy(chunks), style,
                                sample_generator=torch.Generator().manual_seed(7),
                                top_k=1, top_p=0.0))
    np.testing.assert_array_equal(sampled, greedy)
    want = np.asarray(jm.generate(jp, jnp.asarray(chunks), jm.encode_style(jp, None)))
    np.testing.assert_allclose(sampled, want, atol=1e-5)


def test_decode_samples_inside_the_mask(models, rng):
    """Each level's sampled bits in ``decode_window`` lie inside JAX's mask of
    that level's head logits; the same seed gives the same bits, another seed
    other bits. The random-init head's two logits per bit are close, so
    top_p = 0.55 (drop the other bit at p <= 0.45) leaves some bits a choice
    and decides others."""
    jm, _, tm = models
    top_p = 0.55
    cond = torch.from_numpy(
        rng.standard_normal((2, jm.total_tokens, CFG.ar.audio_feature_dim)).astype(np.float32))
    style = tm.encode_style(None)
    prev = tm.initial_state(style, batch_size=2).prev_attn_feat
    head_logits, levels = tm._head_logits, []

    def recorded(feats, cond_ss):
        logits = head_logits(feats, cond_ss)
        levels.append(to_np(logits))
        return logits

    def decode(seed):
        levels.clear()
        tm._head_logits = recorded
        try:
            bits = tm.decode_window(cond, style, prev, (torch.Generator().manual_seed(seed),
                                                        2, top_p))
        finally:
            del tm._head_logits
        return to_np(bits), np.concatenate(levels, axis=1)

    bits, logits = decode(0)
    mask = np.isfinite(np.asarray(jax_mask(jnp.asarray(logits), 2, top_p)))
    assert bits.shape == logits.shape[:-1] == (2, jm.total_tokens, CFG.vae.code_dim)
    assert np.take_along_axis(mask, bits[..., None].astype(np.int64), axis=-1).all()
    choice = mask.all(axis=-1)
    assert choice.any() and not choice.all(), choice.mean()
    np.testing.assert_array_equal(decode(0)[0], bits)
    assert not np.array_equal(decode(1)[0], bits)


def test_generate_seeds(models, rng):
    jm, _, tm = models
    chunks = torch.from_numpy(_chunks(rng, jm))
    style = tm.encode_style(None)

    def run(seed):
        return to_np(tm.generate(chunks, style,
                                 sample_generator=torch.Generator().manual_seed(seed)))

    a = run(0)
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(run(0), a)
    assert not np.array_equal(run(1), a)
