"""Motion tokenizer (BSQ pyramid, BITWISE_VAE) and style encoder of
artalk_tpu_torch against JAX on the same parameters and inputs.

Code bits must be equal; motions and features agree to atol 1e-5 (float32
towers whose matmuls sum in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artalk_tpu.config import VAEConfig
from artalk_tpu.models.bitwise_vae import BitwiseVAE as JaxVAE
from artalk_tpu.models.bsq import MultiScaleBSQ as JaxBSQ
from artalk_tpu.models.style_encoder import StyleEncoder as JaxStyle

from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch.models.bitwise_vae import BitwiseVAE
from artalk_tpu_torch.models.bsq import MultiScaleBSQ
from artalk_tpu_torch.models.style_encoder import StyleEncoder

from test_torch_params import to_np, with_jax_params
from test_torch_params import torch_threads  # noqa: F401 (autouse)

SMALL_VAE = VAEConfig(motion_dim=12, code_dim=8, depth=2, num_heads=4, hidden_dim=32,
                      patch_nums=(1, 2, 4))
PROD_VAE = VAEConfig()   # 106-d motion, code 32, 512/8/8, scales 1+5+25+50+100


def test_bsq_pyramid_bits_equal(rng):
    f = rng.standard_normal((2, 100, 32)).astype(np.float32)
    jq, jbits = JaxBSQ(32).encode(jnp.asarray(f))
    tq, tbits = MultiScaleBSQ(32).encode(torch.from_numpy(f))
    np.testing.assert_array_equal(to_np(tbits), np.asarray(jbits))
    np.testing.assert_allclose(to_np(tq), np.asarray(jq), atol=1e-5)
    bits = np.array(jbits)
    np.testing.assert_allclose(to_np(MultiScaleBSQ(32).bits_to_feat(torch.from_numpy(bits))),
                               np.asarray(JaxBSQ(32).bits_to_feat(jnp.asarray(bits))), atol=1e-6)
    np.testing.assert_allclose(
        to_np(MultiScaleBSQ(32).bits_to_ms_feat(torch.from_numpy(bits))),
        np.asarray(JaxBSQ(32).bits_to_ms_feat(jnp.asarray(bits))), atol=1e-6)


@pytest.mark.parametrize("cfg", [SMALL_VAE, PROD_VAE], ids=["small", "prod"])
def test_vae_encode_decode(rng, cfg):
    jvae = JaxVAE(cfg)
    params = jvae.init(jax.random.PRNGKey(3))
    tvae = with_jax_params(BitwiseVAE(tcfg.VAEConfig(**vars(cfg))), params)
    w = cfg.window
    prev = rng.standard_normal((2, w, cfg.motion_dim)).astype(np.float32)
    this = rng.standard_normal((2, w, cfg.motion_dim)).astype(np.float32)

    jb, _ = jvae.encode_to_bits(params, jnp.asarray(prev))
    tb, _ = tvae.encode_to_bits(torch.from_numpy(prev))
    np.testing.assert_array_equal(to_np(tb), np.asarray(jb))
    jpb, jtb = jvae.encode_to_bits(params, jnp.asarray(prev), jnp.asarray(this))
    tpb, ttb = tvae.encode_to_bits(torch.from_numpy(prev), torch.from_numpy(this))
    np.testing.assert_array_equal(to_np(tpb), np.asarray(jpb))
    np.testing.assert_array_equal(to_np(ttb), np.asarray(jtb))

    jm = jvae.decode_from_bits(params, jpb, jtb)
    tm = tvae.decode_from_bits(torch.from_numpy(np.array(jpb)),
                               torch.from_numpy(np.array(jtb)))
    for t, j in zip(tm, jm):
        np.testing.assert_allclose(to_np(t), np.asarray(j), atol=1e-5)


@pytest.mark.parametrize("motion_dim,feature_dim", [(12, 16), (106, 128)])
def test_style_encoder(rng, motion_dim, feature_dim):
    jenc = JaxStyle(motion_dim=motion_dim, feature_dim=feature_dim)
    params = jenc.init(jax.random.PRNGKey(5))
    tenc = with_jax_params(StyleEncoder(motion_dim=motion_dim, feature_dim=feature_dim), params)
    motion = rng.standard_normal((2, 50, motion_dim)).astype(np.float32)
    np.testing.assert_allclose(to_np(tenc(torch.from_numpy(motion))),
                               np.asarray(jenc(params, jnp.asarray(motion))), atol=1e-5)
