"""wav2vec2 encoder (stable-LN xls-r layout) of artalk_tpu_torch against the
JAX XLA path on the same parameters and audio, atol 1e-5 (float32 convs and
matmuls that sum in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artalk_tpu.config import Wav2VecConfig
from artalk_tpu.models.wav2vec import Wav2VecEncoder as JaxW2V
from artalk_tpu.models.wav2vec import normalize_audio as jax_normalize

from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch.models.wav2vec import Wav2VecEncoder, normalize_audio

from test_ar_model import SMALL_W2V
from test_torch_params import to_np, with_jax_params
from test_torch_params import torch_threads  # noqa: F401 (autouse)

# production widths where they are cheap: 1024-d, 16 heads, FFN 4096, the
# 128-tap 16-group pos-conv; a thin 2-layer conv stack and one encoder layer
WIDE_W2V = Wav2VecConfig(conv_dim=(64, 64), conv_stride=(5, 2), conv_kernel=(10, 3),
                         num_hidden_layers=1)


def test_normalize_audio(rng):
    a = (rng.standard_normal((2, 3000)) * 0.3 + 0.1).astype(np.float32)
    np.testing.assert_allclose(to_np(normalize_audio(torch.from_numpy(a))),
                               np.asarray(jax_normalize(jnp.asarray(a))), atol=1e-6)


@pytest.mark.parametrize("cfg,samples", [(SMALL_W2V, 2560), (WIDE_W2V, 3200)],
                         ids=["small", "wide"])
def test_encoder_matches_jax(rng, cfg, samples):
    jenc = JaxW2V(cfg)
    params = jenc.init(jax.random.PRNGKey(1))
    tenc = with_jax_params(Wav2VecEncoder(tcfg.Wav2VecConfig(**dataclasses.asdict(cfg))),
                           params)
    audio = (rng.standard_normal((2, samples)) * 0.1).astype(np.float32)
    feats_j = jenc.extract_features(params, jax_normalize(jnp.asarray(audio)))
    feats_t = tenc.extract_features(normalize_audio(torch.from_numpy(audio)))
    np.testing.assert_allclose(to_np(feats_t), np.asarray(feats_j), atol=1e-5)
    want = np.asarray(jenc(params, jnp.asarray(audio)))
    got = to_np(tenc(torch.from_numpy(audio)))
    assert got.shape == want.shape == (2, cfg.num_output_frames(samples), cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=1e-5)
