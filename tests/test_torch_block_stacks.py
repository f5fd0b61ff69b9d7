"""The block-stack modules of artalk_tpu_torch (ops/ar_block_stack.py,
ops/encoder_block_stack.py) against the JAX package's Pallas kernels, run in
interpret mode on the CPU, on the same seed-0 weights (carried over by the
parameter bridge) and the same numpy inputs.

- the port's int8 packs equal JAX's int8 values and scales exactly;
- AR stack per level, B in {1, 5}: float32 feats to 2e-5 and k/v to 2e-6
  (tests/test_ar_fused.py's own bounds); bf16/int8 packs round the same
  operands to bf16 as the Pallas kernel, so feats agree to 1e-3 and k/v to
  within 2 bf16 ulps (rtol 2**-7), a float32-summation-order difference
  flipping at most a rounding;
- encoder stack: float32 3e-5, bf16 0.08, int8 0.15 (tests/test_encoder_fused.py's
  bounds), and each window of a batch equals its single-window result
  exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artalk_tpu.models.wav2vec import Wav2VecEncoder as JaxWav2Vec
from artalk_tpu.ops.ar_block_stack import ar_block_stack as jax_ar_stack
from artalk_tpu.ops.ar_block_stack import pack_block_weights as jax_ar_pack
from artalk_tpu.ops.encoder_block_stack import encoder_block_stack as jax_enc_stack
from artalk_tpu.ops.encoder_block_stack import pack_encoder_weights as jax_enc_pack

from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch.models.wav2vec import Wav2VecEncoder
from artalk_tpu_torch.ops import ar_block_stack as tar
from artalk_tpu_torch.ops import encoder_block_stack as tenc

from test_ar_fused import CFG as AR_CFG
from test_encoder_fused import SMALL as ENC_CFG
from test_torch_params import jax_model_and_flat, port_model, to_np, with_jax_params
from test_torch_params import torch_threads  # noqa: F401 (autouse)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def ar_models():
    jm, jp, _ = jax_model_and_flat(AR_CFG)
    return jm, jp, port_model(AR_CFG)


@pytest.fixture(scope="module")
def encoders():
    jenc = JaxWav2Vec(ENC_CFG)
    jparams = jenc.init(jax.random.PRNGKey(0))
    tenc_mod = with_jax_params(Wav2VecEncoder(tcfg.Wav2VecConfig(**dataclasses.asdict(ENC_CFG))),
                               jparams)
    return jenc, jparams, tenc_mod


def _jax_tiles_as_port(pack, kinds):
    """A JAX int8 pack (square (d, d) tiles: the first four kinds, then fc1 and
    transposed fc2 chunks in turn) rearranged into the port's matrices and
    scales."""
    t = np.asarray(pack["wtiles"])
    s = np.asarray(pack["scales"])
    f = (t.shape[1] - 4) // 2
    qkv, proj = kinds
    return {
        qkv: np.concatenate([t[:, 0], t[:, 1], t[:, 2]], axis=-1),
        proj: t[:, 3],
        "wfc1": np.concatenate([t[:, 4 + 2 * c] for c in range(f)], axis=-1),
        "wfc2": np.concatenate([t[:, 5 + 2 * c].transpose(0, 2, 1) for c in range(f)], axis=1),
        "s" + qkv[1:]: np.concatenate([s[:, 0], s[:, 1], s[:, 2]], axis=-1)[:, None],
        "s" + proj[1:]: s[:, 3][:, None],
        "sfc1": np.concatenate([s[:, 4 + 2 * c] for c in range(f)], axis=-1)[:, None],
        "sfc2": np.stack([s[:, 5 + 2 * c] for c in range(f)], axis=1),
    }


def test_ar_int8_pack_equals_jax(ar_models):
    jm, jp, tm = ar_models
    want = _jax_tiles_as_port(jax_ar_pack(jp["blocks"], jm.num_heads, dtype=jnp.int8),
                              ("wqkv", "wproj"))
    got = tar.pack_block_weights(tm.blocks, tm.num_heads, dtype=torch.int8)
    for name, arr in want.items():
        assert got[name].dtype == (torch.int8 if name[0] == "w" else torch.float32), name
        np.testing.assert_array_equal(to_np(got[name]), arr, err_msg=name)


def test_encoder_int8_pack_equals_jax(encoders):
    _, jparams, tmod = encoders
    want = _jax_tiles_as_port(jax_enc_pack(jparams["encoder"]["layers"], dtype=jnp.int8),
                              ("wqkv", "wout"))
    got = tenc.pack_encoder_weights(tmod.encoder.layers, dtype=torch.int8)
    for name, arr in want.items():
        np.testing.assert_array_equal(to_np(got[name]), arr, err_msg=name)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("batch", [1, 5])
def test_ar_stack_matches_pallas(ar_models, mode, batch):
    jm, jp, tm = ar_models
    jdt, tdt = DTYPES[mode]
    jpack = jax_ar_pack(jp["blocks"], jm.num_heads, dtype=jdt)
    tpack = tar.pack_block_weights(tm.blocks, tm.num_heads, dtype=tdt)
    cache_dt = torch.float32 if mode == "f32" else torch.bfloat16
    rng = np.random.default_rng(3 + batch)
    d = jm.embed_dim
    for level, pn in enumerate(jm.patch_nums):
        start = jm.prev_len + jm.offsets[level]
        x = (rng.standard_normal((batch, pn, d)) * 0.3).astype(np.float32)
        ada = (rng.standard_normal((jm.depth, batch, pn, 6 * d)) * 0.1).astype(np.float32)
        kc = torch.from_numpy((rng.standard_normal((jm.depth, batch, jm.cache_len, d)) * 0.2
                               ).astype(np.float32)).to(cache_dt)
        vc = torch.from_numpy((rng.standard_normal((jm.depth, batch, jm.cache_len, d)) * 0.2
                               ).astype(np.float32)).to(cache_dt)
        jcache = [jnp.asarray(to_np(c.float())).astype(jnp.float32 if mode == "f32"
                                                          else jnp.bfloat16) for c in (kc, vc)]
        want = jax_ar_stack(jnp.asarray(x), jnp.asarray(ada), jpack["wtiles"], jpack["biases"],
                            *jcache, jpack.get("scales"), start=start,
                            num_heads=jm.num_heads, interpret=True)
        before, by_pack = tar.LAUNCHES, dict(tar.LAUNCHES_BY_PACK)
        by_engine, folded = dict(tar.LAUNCHES_BY_ENGINE), tar.FOLDED
        got = tar.ar_block_stack(torch.from_numpy(x), torch.from_numpy(ada), tpack, kc, vc,
                                 start=start, num_heads=tm.num_heads)
        assert tar.LAUNCHES == before  # CPU tensors take the plain version
        assert tar.LAUNCHES_BY_PACK == by_pack
        assert tar.LAUNCHES_BY_ENGINE == by_engine and tar.FOLDED == folded
        assert got[1].dtype == got[2].dtype == cache_dt
        feats, k_new, v_new = (to_np(t.float()) for t in got)
        want = [np.asarray(w).astype(np.float32) for w in want]
        msg = f"{mode} B={batch} level {level}"
        if mode == "f32":
            np.testing.assert_allclose(feats, want[0], atol=2e-5, rtol=2e-5, err_msg=msg)
            np.testing.assert_allclose(k_new, want[1], atol=2e-6, rtol=2e-6, err_msg=msg)
            np.testing.assert_allclose(v_new, want[2], atol=2e-6, rtol=2e-6, err_msg=msg)
        else:
            np.testing.assert_allclose(feats, want[0], atol=1e-3, rtol=2 ** -7, err_msg=msg)
            np.testing.assert_allclose(k_new, want[1], atol=1e-6, rtol=2 ** -7, err_msg=msg)
            np.testing.assert_allclose(v_new, want[2], atol=1e-6, rtol=2 ** -7, err_msg=msg)


@pytest.mark.parametrize("mode,tol", [("f32", 3e-5), ("bf16", 0.08), ("int8", 0.15)])
def test_encoder_stack_matches_pallas(encoders, mode, tol):
    jenc, jparams, tmod = encoders
    jdt, tdt = DTYPES[mode]
    jpack = jax_enc_pack(jparams["encoder"]["layers"], dtype=jdt)
    tpack = tenc.pack_encoder_weights(tmod.encoder.layers, dtype=tdt)
    x = (np.random.default_rng(11).standard_normal((1, 9, ENC_CFG.hidden_size)) * 0.5
         ).astype(np.float32)
    want = np.asarray(jax_enc_stack(jnp.asarray(x), jpack["wtiles"], jpack["biases"],
                                    jpack.get("scales"), num_heads=ENC_CFG.num_attention_heads,
                                    eps=ENC_CFG.layer_norm_eps, interpret=True))
    before, by_pack = tenc.LAUNCHES, dict(tenc.LAUNCHES_BY_PACK)
    by_engine, folded = dict(tenc.LAUNCHES_BY_ENGINE), tenc.FOLDED
    got = to_np(tenc.encoder_block_stack(torch.from_numpy(x), tpack,
                                         num_heads=ENC_CFG.num_attention_heads,
                                         eps=ENC_CFG.layer_norm_eps))
    assert tenc.LAUNCHES == before
    assert tenc.LAUNCHES_BY_PACK == by_pack
    assert tenc.LAUNCHES_BY_ENGINE == by_engine and tenc.FOLDED == folded
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_encoder_stack_windows_independent(encoders, mode):
    """Three windows in one call give each window's single-window result
    exactly."""
    _, _, tmod = encoders
    tpack = tenc.pack_encoder_weights(tmod.encoder.layers, dtype=DTYPES[mode][1])
    assert tenc.pack_batched_ok(tpack)
    x = torch.from_numpy((np.random.default_rng(12).standard_normal(
        (3, 9, ENC_CFG.hidden_size)) * 0.5).astype(np.float32))
    heads = ENC_CFG.num_attention_heads
    y = tenc.encoder_block_stack(x, tpack, num_heads=heads)
    for i in range(3):
        assert torch.equal(y[i:i + 1], tenc.encoder_block_stack(x[i:i + 1], tpack,
                                                                num_heads=heads))


def test_other_devices_raise(ar_models):
    """CPU tensors take the plain version, CUDA tensors the kernel; nothing
    else silently falls back."""
    _, _, tm = ar_models
    pack = tar.pack_block_weights(tm.blocks, tm.num_heads)
    x = torch.zeros((1, 1, tm.embed_dim), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tar.ar_block_stack(x, x, pack, x, x, start=0, num_heads=tm.num_heads)
    with pytest.raises(ValueError, match="unsupported device"):
        tenc.encoder_block_stack(x, pack, num_heads=tm.num_heads)
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        tar.pack_block_weights(tm.blocks, tm.num_heads, dtype=torch.float16)
