"""The alternate audio encoders of artalk_tpu_torch against the JAX package on
the same parameters (carried over by the parameter bridge) and numpy inputs:
the wav2vec2 encoder with flash attention, HuBERT, Mimi piece by piece, and
the AR slices they condition.

The JAX flash path reaches its Pallas kernel, which runs on the CPU only in
interpret mode, so the ``jax_flash_interpret`` fixture points the JAX
wav2vec2 layer loop's ``flash_attention`` at the interpret-mode kernel. The
JAX side is jitted: eagerly, its Mimi and layer scans take ~10x longer.

Tolerances: float32 encoders to 1e-5 (convolutions and matmuls that sum in
another order; the conv stacks' own test uses the same), the RVQ codes equal,
greedy code bits equal (a bit that differs must be a near tie: its logit
margin under 1e-4 in the port, and it is printed), motions to 1e-5; bf16
(``fast``) conditions to 0.02, as tests/test_torch_precision.py holds the
bf16 encoder.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import artalk_tpu.ops.attention as jax_attention
from artalk_tpu.config import ARConfig, ModelConfig, VAEConfig
from artalk_tpu.config import hubert_base_config as jax_hubert_base_config
from artalk_tpu.models.ar_model import BitwiseARModel as JaxARModel
from artalk_tpu.models.hubert import HubertEncoder as JaxHubert
from artalk_tpu.models.mimi import MimiEncoder as JaxMimi
from artalk_tpu.models.mimi import resample_16k_to_24k as jax_resample
from artalk_tpu.models.wav2vec import Wav2VecEncoder as JaxW2V
from artalk_tpu.utils.assets import save_flame_npz, synthetic_flame

from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.models import nn as tnn
from artalk_tpu_torch.models.ar_model import BitwiseARModel
from artalk_tpu_torch.models.hubert import HubertEncoder
from artalk_tpu_torch.models.mimi import MimiEncoder, resample_16k_to_24k
from artalk_tpu_torch.models.wav2vec import Wav2VecEncoder
from artalk_tpu_torch.ops import attention as tatt
from artalk_tpu_torch.utils.params import SEP, params_from_flat

from test_ar_model import CFG as AR_CFG
from test_ar_model import SMALL_W2V
from test_hubert import SMALL as SMALL_HUBERT
from test_mimi import SMALL as SMALL_MIMI
from test_torch_params import jax_model_and_flat, to_np, torch_config, with_jax_params
from test_torch_params import torch_threads  # noqa: F401 (autouse)

# the Mimi-conditioned small model of tests/test_mimi.py
MIMI_CFG = ModelConfig(
    ar=ARConfig(depth=2, num_heads=4, embed_dim=64, style_dim=16, audio_encoder="mimi",
                audio_dim=32),
    vae=VAEConfig(motion_dim=12, code_dim=8, depth=2, num_heads=4, hidden_dim=32,
                  patch_nums=(1, 2, 4)),
    mimi=SMALL_MIMI)
# tests/test_ar_model.py's small model with the flash wav2vec2 encoder
FLASH_CFG = dataclasses.replace(
    AR_CFG, wav2vec=dataclasses.replace(SMALL_W2V, use_flash_attention=True))
# a flash encoder at the production head dim (64; SMALL_W2V's is 16)
FLASH_W2V_HD64 = dataclasses.replace(
    SMALL_W2V, hidden_size=128, num_attention_heads=2, intermediate_size=256,
    use_flash_attention=True)


@pytest.fixture
def jax_flash_interpret(monkeypatch):
    monkeypatch.setattr(jax_attention, "flash_attention",
                        functools.partial(jax_attention.flash_attention, interpret=True))


def _port_cfg(cls, jax_cfg):
    return cls(**dataclasses.asdict(jax_cfg))


def _flat_key(path) -> str:
    return SEP.join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)


def _assert_same_tree(module, jax_tree):
    """The port module's parameters are the JAX tree (arrays, or the shapes
    jax.eval_shape gives): the same keys, each at the same shape. The bridge
    itself ignores keys a module does not use, so this checks the rest."""
    want = {_flat_key(path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    assert {k.replace(".", SEP): tuple(v.shape) for k, v in module.state_dict().items()} == want


@functools.lru_cache(maxsize=None)
def _mimi_models():
    """(JAX model, JAX params, flat params) of MIMI_CFG. The values are the
    port's seed-0 init put into the JAX init's tree (its structure from
    jax.eval_shape): JAX's eager init of the Mimi tree takes ~10 s here."""
    jm = JaxARModel(MIMI_CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    state = BitwiseARModel(torch_config(MIMI_CFG)).init(torch.Generator().manual_seed(0)
                                                        ).state_dict()
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    flat = {_flat_key(path): state[_flat_key(path).replace(SEP, ".")].numpy()
            for path, _ in paths}
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[_flat_key(p)])
                                                    for p, _ in paths])
    return jm, params, flat


# --------------------------------------------------------------- wav2vec2 + flash


@pytest.mark.parametrize("cfg", [dataclasses.replace(SMALL_W2V, use_flash_attention=True),
                                 FLASH_W2V_HD64], ids=["hd16", "hd64"])
def test_flash_wav2vec_matches_jax(jax_flash_interpret, rng, cfg):
    jenc = JaxW2V(cfg)
    params = jenc.init(jax.random.PRNGKey(1))
    tenc = with_jax_params(Wav2VecEncoder(_port_cfg(tcfg.Wav2VecConfig, cfg)), params)
    audio = (rng.standard_normal((2, 2560)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jenc.__call__)(params, jnp.asarray(audio)))
    before = tatt.LAUNCHES
    got = to_np(tenc(torch.from_numpy(audio)))
    assert tatt.LAUNCHES == before
    assert got.shape == want.shape == (2, cfg.num_output_frames(2560), cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_flash_fast_condition_matches_jax(jax_flash_interpret):
    """``fast`` + flash: q/k/v reach the kernel in bf16; held to JAX's
    ``fast`` + flash path (the flash function differs from sdpa in bf16)."""
    jm, jp, flat = jax_model_and_flat(FLASH_CFG)
    jm = JaxARModel(dataclasses.replace(FLASH_CFG, bf16_audio=True, bf16_ar=True))
    tm = params_from_flat(flat, dataclasses.replace(torch_config(FLASH_CFG), bf16_audio=True,
                                                    bf16_ar=True))
    audio = (np.random.default_rng(5).standard_normal((1, jm.window_samples)) * 0.1
             ).astype(np.float32)
    want = np.asarray(jax.jit(jm.audio_condition)(jp, jnp.asarray(audio)))
    got = to_np(tm.audio_condition(torch.from_numpy(audio)))
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0.02)


# ------------------------------------------------------------------------- HuBERT


@pytest.mark.parametrize("frame_num", [None, 40], ids=["frames", "frame_num"])
@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
def test_hubert_matches_jax(jax_flash_interpret, rng, flash, frame_num):
    cfg = dataclasses.replace(SMALL_HUBERT, use_flash_attention=flash)
    jenc = JaxHubert(cfg)
    params = jenc.init(jax.random.PRNGKey(0))
    tenc = with_jax_params(HubertEncoder(_port_cfg(tcfg.Wav2VecConfig, cfg)), params)
    _assert_same_tree(tenc, params)
    assert tenc.feature_extractor[1].norm is None   # group norm on conv0 only
    audio = (rng.standard_normal((2, 1600)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jenc.__call__, static_argnames="frame_num")(
        params, jnp.asarray(audio), frame_num=frame_num))
    got = to_np(tenc(torch.from_numpy(audio), frame_num=frame_num))
    assert got.shape == want.shape
    if frame_num is not None:
        assert got.shape[1] == frame_num
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_hubert_base_config_matches_jax():
    assert dataclasses.asdict(tcfg.hubert_base_config()) == dataclasses.asdict(
        jax_hubert_base_config())
    assert HubertEncoder().cfg == tcfg.hubert_base_config()


# --------------------------------------------------------------------------- Mimi


@pytest.fixture(scope="module")
def mimi():
    """JAX's Mimi SMALL, its parameters (those of MIMI_CFG's seed-0 init, which
    the slice tests share) and the port's encoder holding them."""
    jenc = JaxMimi(SMALL_MIMI)
    params = _mimi_models()[1]["audio_encoder"]
    tenc = with_jax_params(MimiEncoder(_port_cfg(tcfg.MimiEncoderConfig, SMALL_MIMI)), params)
    return jenc, params, tenc


def test_mimi_tree_and_resampler(mimi, rng):
    jenc, params, tenc = mimi
    _assert_same_tree(tenc, params)
    audio = (rng.standard_normal((2, 6401)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jax_resample)(jnp.asarray(audio)))
    got = to_np(resample_16k_to_24k(torch.from_numpy(audio)))
    assert got.shape == want.shape == (2, 9601)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_mimi_seanet_and_transformer(mimi, rng):
    jenc, params, tenc = mimi
    audio = (rng.standard_normal((1, 4800)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jenc.seanet_encode)(params, jnp.asarray(audio)))
    got = to_np(tenc.seanet_encode(torch.from_numpy(audio)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    x = np.ascontiguousarray(want.transpose(0, 2, 1))
    np.testing.assert_allclose(to_np(tenc.transform(torch.from_numpy(x))),
                               np.asarray(jax.jit(jenc.transform)(params, jnp.asarray(x))),
                               atol=1e-5)


def test_mimi_codes_equal(mimi, rng):
    jenc, params, tenc = mimi
    audio = (rng.standard_normal((2, 4800)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jenc.encode_codes)(params, jnp.asarray(audio)))
    got = to_np(tenc.encode_codes(torch.from_numpy(audio)))
    assert got.shape == want.shape == (2, SMALL_MIMI.num_quantizers, 3)
    np.testing.assert_array_equal(got, want)


def test_mimi_decode_and_full_call(mimi, rng):
    jenc, params, tenc = mimi
    codes = rng.integers(0, SMALL_MIMI.codebook_size, (1, SMALL_MIMI.num_quantizers, 7))
    np.testing.assert_allclose(to_np(tenc.decode_codes(torch.from_numpy(codes))),
                               np.asarray(jax.jit(jenc.decode_codes)(params, jnp.asarray(codes))),
                               atol=1e-5)
    audio = (rng.standard_normal((2, 6400)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jenc.__call__)(params, jnp.asarray(audio)))
    got = to_np(tenc(torch.from_numpy(audio)))
    assert got.shape == want.shape == (2, tenc.num_output_frames(6400), SMALL_MIMI.hidden_size)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------------ full-width parameter trees


@pytest.mark.parametrize("which", ["hubert", "mimi", "mimi_ar"])
def test_full_width_trees_match(which):
    """The JAX init trees at full width (HuBERT base, the default Mimi, the
    production AR model on Mimi) against the port's modules, key for key and
    shape for shape: shapes by jax.eval_shape, the modules on the meta
    device, so nothing is allocated."""
    key = jax.random.PRNGKey(0)
    cfg = ModelConfig(ar=ARConfig(audio_encoder="mimi"))
    with torch.device("meta"):
        if which == "hubert":
            tree, module = jax.eval_shape(JaxHubert().init, key), HubertEncoder()
        elif which == "mimi":
            tree, module = jax.eval_shape(JaxMimi().init, key), MimiEncoder()
        else:
            tree = jax.eval_shape(JaxARModel(cfg).init, key)
            module = BitwiseARModel(torch_config(cfg))
            assert isinstance(module.audio_encoder, MimiEncoder)
            assert module.blocks.ada_lin.w.shape[1] == 512   # the Mimi conditioning width
    _assert_same_tree(module, tree)


def test_mimi_ar_tree_loads_through_the_bridge():
    """params_from_flat of a Mimi-configured BitwiseARModel tree (the JAX
    init's keys and shapes)."""
    tm = params_from_flat(_mimi_models()[2], torch_config(MIMI_CFG))
    _assert_same_tree(tm, _mimi_models()[1])
    flat = dict(_mimi_models()[2])
    del flat["audio_encoder//acoustic_rvq//embed_sum"]
    with pytest.raises(KeyError, match="acoustic_rvq"):
        params_from_flat(flat, torch_config(MIMI_CFG))


# --------------------------------------------------------------- the AR slices


def _bits_and_margins(tm, cond, style, prev):
    """The port's greedy code bits of one window and, per bit, the margin
    |logit(1) - logit(0)| of its decision."""
    margins = []
    head_bits = tm._head_bits

    def recorded(feats, head_cond, sample=None):
        bits = head_bits(feats, head_cond, sample)
        scale, shift = head_cond
        logits = tm.head.out(tnn.layer_norm(feats, eps=1e-6) * (scale + 1.0) + shift)
        logits = logits.float().reshape(*bits.shape, 2)
        margins.append((logits[..., 1] - logits[..., 0]).abs())
        return bits

    tm._head_bits = recorded
    try:
        bits = tm.decode_window(cond, style, prev)
    finally:
        del tm._head_bits
    return to_np(bits), to_np(torch.cat(margins, dim=1))


@pytest.mark.parametrize("cfg", [MIMI_CFG, FLASH_CFG], ids=["mimi", "flash_wav2vec"])
def test_slice_bits_and_generate_match_jax(jax_flash_interpret, cfg):
    """Two windows through audio_condition -> decode_window -> window_step on
    both packages: equal code bits (or near ties, printed), motions to 1e-5,
    and generate over the same windows to 1e-5."""
    jm, jp, flat = _mimi_models() if cfg is MIMI_CFG else jax_model_and_flat(cfg)
    tm = params_from_flat(flat, torch_config(cfg))
    rng = np.random.default_rng(11)
    chunks = (rng.standard_normal((2, 1, jm.window_samples)) * 0.1).astype(np.float32)
    jstyle = jm.encode_style(jp, None)
    jstate = jm.initial_state(jp, jstyle)
    j_cond, j_decode, j_step = (jax.jit(f) for f in (jm.audio_condition, jm.decode_window,
                                                       jm.window_step_cond))
    style = tm.encode_style(None)
    state = tm.initial_state(style)
    for i, chunk in enumerate(chunks):
        jcond = j_cond(jp, jnp.asarray(chunk))
        want_bits = np.asarray(j_decode(jp, jcond, jstyle, jstate.prev_attn_feat))
        jstate, want_motion = j_step(jp, jstate, jcond, jstyle)
        cond = tm.audio_condition(torch.from_numpy(chunk))
        np.testing.assert_allclose(to_np(cond), np.asarray(jcond), atol=1e-5)
        bits, margins = _bits_and_margins(tm, cond, style, state.prev_attn_feat)
        state, motion = tm.window_step_cond(state, cond, style)
        flips = bits != want_bits
        if flips.any():
            print(f"window {i}: {int(flips.sum())} of {flips.size} code bits differ, "
                  f"logit margins {margins[flips]}")
        assert (margins[flips] < 1e-4).all(), f"window {i}: a code bit flipped off a near tie"
        if not flips.any():
            np.testing.assert_allclose(to_np(motion), np.asarray(want_motion), atol=1e-5)
    want = np.asarray(jax.jit(jm.generate)(jp, jnp.asarray(chunks), jstyle))
    got = to_np(tm.generate(torch.from_numpy(chunks), style))
    assert got.shape == want.shape == (1, 2 * cfg.vae.window, cfg.vae.motion_dim)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("precision", ["exact", "int8"])
def test_engine_from_config_json_with_mimi(tmp_path, monkeypatch, precision):
    """A reference-format config.json with "AUDIO_ENCODER": "mimi" gives the
    Mimi-conditioned engine on the CPU (the full-width default Mimi; the AR
    model and the VAE cut down through the JSON's own fields). In int8 the AR
    pack is built and the audio pack stays None: Mimi has no fused path."""
    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(tmp_path / "flame_synthetic.npz"))
    (tmp_path / "config.json").write_text(json.dumps({
        "AR_CONFIG": {"T_DEPTH": 1, "T_NUM_HEADS": 12, "AUDIO_ENCODER": "mimi"},
        "VAE_CONFIG": {"T_DEPTH": 1, "T_HIDDEN_DIM": 32, "V_CODE_DIM": 8,
                       "V_PATCH_NUMS": [1, 2, 4]}}))
    monkeypatch.setenv("ARTALK_AR_PRECISION", precision)
    monkeypatch.delenv("ARTALK_AR_FUSED", raising=False)
    eng = ARTAvatarInferEngine(assets_dir=str(tmp_path), output_dir=str(tmp_path / "out"),
                               image_size=64, device="cpu")
    assert eng.cfg.ar.audio_encoder == "mimi" and eng.cfg.mimi == tcfg.MimiEncoderConfig()
    assert isinstance(eng.model.audio_encoder, MimiEncoder)
    assert eng.model.fused_audio_pack is None
    assert (eng.model.fused_pack is not None) == (precision == "int8")
    audio = (np.random.default_rng(6).standard_normal(4000) * 0.1).astype(np.float32)
    motions = eng.inference(audio)
    assert motions.shape == (7, 106) and np.isfinite(motions).all()
    streamed = np.concatenate(list(eng.stream([audio[:2560], audio[2560:]])))
    assert streamed.shape == (7, 106) and np.isfinite(streamed).all()


def test_package_exports():
    """The encoders and flash attention under the JAX package's names."""
    from artalk_tpu_torch import models, ops

    assert models.HubertEncoder is HubertEncoder and models.MimiEncoder is MimiEncoder
    assert models.Wav2VecEncoder is Wav2VecEncoder and models.BitwiseARModel is BitwiseARModel
    assert ops.flash_attention is tatt.flash_attention
    with pytest.raises(AttributeError):
        models.NoSuchModel  # noqa: B018
