"""The precision modes of artalk_tpu_torch (ARTALK_AR_PRECISION=fast|int8,
ARTALK_AR_FUSED=1) and its StreamPool against the JAX package, on the CPU,
with the same seed-0 weights (parameter bridge) and numpy inputs. The JAX
side runs its Pallas kernels in interpret mode.

Tolerances, per mode (the JAX package's own for its fused paths,
tests/test_ar_fused.py and tests/test_encoder_fused.py):
- greedy code bits of decode_window agree with the JAX model in the same
  mode on >= 99.9 % of bits for float32 fused, >= 97 % for bf16 (fused or
  not) and int8;
- the float32 fused audio condition to 3e-5; the bf16 one to 0.02, under
  3 bf16 ulps of its largest values (two bf16 rounding schedules through
  the conv stack and the encoder);
- StreamPool motions equal each session streamed alone to 1e-5, and the
  float32 pool equals the JAX pool to 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artalk_tpu.engine import _resolve_ar_precision as jax_resolve
from artalk_tpu.models.ar_model import BitwiseARModel as JaxARModel
from artalk_tpu.serving import StreamPool as JaxStreamPool

from artalk_tpu_torch.config import precision_from_env, precision_mode
from artalk_tpu_torch.models.ar_model import BitwiseARModel
from artalk_tpu_torch.ops._nvcc import launches
from artalk_tpu_torch.serving import StreamPool
from artalk_tpu_torch.utils.params import params_from_flat

from conftest import no_persistent_compile_cache_fixture
from test_ar_fused import CFG
from test_torch_params import jax_model_and_flat, to_np, torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)

_no_persistent_compile_cache = no_persistent_compile_cache_fixture()

MODES = {
    "exact": {},
    "fused": {"fused_ar": True},
    "fast": {"bf16_audio": True, "bf16_ar": True},
    "fast_fused": {"bf16_audio": True, "bf16_ar": True, "fused_ar": True},
    "int8": {"bf16_audio": True, "bf16_ar": True, "fused_ar": True, "int8_ar": True},
}
MIN_AGREE = {"exact": 1.0, "fused": 0.999, "fast": 0.97, "fast_fused": 0.97, "int8": 0.97}


def _models(mode):
    """(JAX model, JAX params, the port's model) of CFG in ``mode``."""
    _, jp, flat = jax_model_and_flat(CFG)
    jm = JaxARModel(dataclasses.replace(CFG, **MODES[mode]))
    tm = params_from_flat(flat, dataclasses.replace(torch_config(CFG), **MODES[mode]))
    return jm, jp, tm


# the weight type of both block stacks' packs per precision mode, as the
# README's precision table gives it (None: the mode runs no block-stack kernel)
PACK_TYPES = {"exact": None, "fused": torch.float32, "fast": None,
              "fast+fused": torch.bfloat16, "int8": torch.int8}


@pytest.mark.parametrize("mode,env", [
    ("exact", {}), ("fused", {"ARTALK_AR_FUSED": "1"}), ("fast", {"ARTALK_AR_PRECISION": "fast"}),
    ("fast+fused", {"ARTALK_AR_PRECISION": "fast", "ARTALK_AR_FUSED": "1"}),
    ("int8", {"ARTALK_AR_PRECISION": "int8"})], ids=list(PACK_TYPES))
def test_env_resolution_matches_jax(monkeypatch, mode, env):
    """The environment's mode resolves as JAX resolves it, and
    ``set_precision`` builds both packs in the README's weight type, or
    none; back in the exact mode, it drops them."""
    for k in ("ARTALK_AR_PRECISION", "ARTALK_AR_FUSED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = jax_resolve(CFG)
    got = precision_from_env(torch_config(CFG))
    fields = ("bf16_audio", "bf16_ar", "fused_ar", "int8_ar")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert precision_mode(got) == mode
    model = BitwiseARModel(torch_config(CFG)).init(torch.Generator().manual_seed(0))
    model.set_precision(got)
    assert model.cfg == got
    assert [None if p is None else p["wqkv"].dtype
            for p in (model.fused_pack, model.fused_audio_pack)] == [PACK_TYPES[mode]] * 2
    model.set_precision(torch_config(CFG))
    assert model.fused_pack is None and model.fused_audio_pack is None


@pytest.mark.parametrize("batch", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_routing_matches_jax(mode, batch):
    """Which batches each block stack's kernel runs, and with which pack
    type, as the JAX package routes them: the AR kernel with ``fused_ar``
    at batch <= 2 for a float32 pack and at any batch else (JAX's
    ``decode_window``), the encoder kernel with ``fused_ar`` on a
    stable-LN wav2vec2 at batch 1, or at any batch where JAX's own
    ``pack_batched_ok`` takes its pack."""
    from artalk_tpu.ops.encoder_block_stack import pack_batched_ok as jax_batched_ok

    jm, jp, tm = _models(mode)
    jax_ar = jm.pack_fused_decode(jp)
    jax_audio = jm.pack_fused_audio(jp)
    want = {"ar": jm.cfg.fused_ar and (batch <= 2 or jax_ar["wtiles"].dtype != jnp.float32),
            "encoder": (jm.cfg.fused_ar and jax_audio is not None
                        and (batch == 1 or jax_batched_ok(jax_audio)))}
    jax_dtype = {"ar": jax_ar["wtiles"].dtype,
                 "encoder": None if jax_audio is None else jax_audio["wtiles"].dtype}
    for stack in ("ar", "encoder"):
        pack = tm._kernel_pack(stack, batch)
        assert (pack is not None) == want[stack], (stack, mode, batch)
        if pack is not None:
            assert str(pack["wqkv"].dtype) == f"torch.{jax_dtype[stack]}", stack


@pytest.mark.parametrize("mode,batch", [
    ("fused", 1), ("fused", 5), ("fast", 1), ("fast_fused", 1), ("fast_fused", 5),
    ("int8", 1), ("int8", 5)])
def test_decode_window_bits_agree_with_jax(mode, batch):
    jm, jp, tm = _models(mode)
    rng = np.random.default_rng(20 + batch)
    cond = (rng.standard_normal((batch, jm.total_tokens, CFG.ar.audio_feature_dim)) * 0.3
            ).astype(np.float32)
    prev = (rng.standard_normal((batch, jm.prev_len, jm.embed_dim)) * 0.2).astype(np.float32)
    style = jm.encode_style(jp, None)
    want = np.asarray(jm.decode_window(jp, jnp.asarray(cond), style, jnp.asarray(prev)))
    before = launches()
    got = to_np(tm.decode_window(torch.from_numpy(cond), tm.encode_style(None),
                                 torch.from_numpy(prev)))
    assert launches() == before
    assert got.shape == want.shape
    agree = float((got == want).mean())
    assert agree >= MIN_AGREE[mode], f"{mode} B={batch}: bit agreement {agree}"


@pytest.mark.parametrize("mode,tol", [("fused", 3e-5), ("fast", 0.02), ("int8", 0.02)])
def test_audio_condition_matches_jax(mode, tol):
    jm, jp, tm = _models(mode)
    audio = (np.random.default_rng(5).standard_normal((1, jm.window_samples)) * 0.1
             ).astype(np.float32)
    want = np.asarray(jm.audio_condition(jp, jnp.asarray(audio)))
    before = launches()
    got = to_np(tm.audio_condition(torch.from_numpy(audio)))
    assert launches() == before
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_fused_packs_built_once_by_the_engine(tmp_path, monkeypatch):
    """The engine packs the fused paths' weights at construction, in the
    mode's dtypes, and a pool on its model keeps them."""
    from artalk_tpu_torch.engine import ARTAvatarInferEngine

    from artalk_tpu.utils.assets import save_flame_npz, synthetic_flame

    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(tmp_path / "flame_synthetic.npz"))
    monkeypatch.setenv("ARTALK_AR_PRECISION", "int8")
    eng = ARTAvatarInferEngine(assets_dir=str(tmp_path), output_dir=str(tmp_path / "out"),
                               config=torch_config(CFG), params=jax_model_and_flat(CFG)[2],
                               image_size=64, device="cpu")
    assert eng.cfg.int8_ar and eng.cfg.fused_ar
    assert eng.model.fused_pack["wqkv"].dtype == torch.int8
    assert eng.model.fused_audio_pack["wqkv"].dtype == torch.int8
    packs = eng.model.fused_pack, eng.model.fused_audio_pack
    StreamPool(eng.model, max_sessions=2)
    assert (eng.model.fused_pack, eng.model.fused_audio_pack) == packs
    motions = eng.inference((np.random.default_rng(6).standard_normal(2560) * 0.1
                             ).astype(np.float32))
    assert motions.shape == (4, CFG.vae.motion_dim) and np.isfinite(motions).all()


def _single_stream(model, style_motion, chunks):
    """One session decoded alone at batch 1 through window_step."""
    style = (model.encode_style(None) if style_motion is None
             else model.encode_style(torch.from_numpy(style_motion)[None]))
    state = model.initial_state(style, batch_size=1)
    outs = []
    for chunk in chunks:
        buf = np.zeros(model.window_samples, np.float32)
        buf[:len(chunk)] = chunk
        state, motion = model.window_step(state, torch.from_numpy(buf[None]), style)
        outs.append(to_np(motion[0]))
    return outs


def _pool_scenario(pool, a_chunks, b_chunks, style_b):
    """tests/isolated/test_serving.py's scenario: a joins, b joins late with
    a style, then each idles one tick."""
    sa = pool.open_session()
    got_a, got_b = [pool.step({sa: a_chunks[0]})[sa]], []
    sb = pool.open_session(style_motion=style_b)
    out = pool.step({sa: a_chunks[1], sb: b_chunks[0]})
    got_a.append(out[sa])
    got_b.append(out[sb])
    got_a.append(pool.step({sa: a_chunks[2]})[sa])
    got_b.append(pool.step({sb: b_chunks[1]})[sb])
    return got_a, got_b


@pytest.mark.parametrize("mode,capacity", [("exact", 3), ("int8", 4)])
def test_stream_pool_matches_single_streams(mode, capacity):
    jm, jp, tm = _models(mode)
    rng = np.random.default_rng(0)
    ws = tm.window_samples
    a_chunks = [rng.standard_normal(ws).astype(np.float32) * 0.1 for _ in range(3)]
    b_chunks = [rng.standard_normal(ws).astype(np.float32) * 0.1 for _ in range(2)]
    style_b = rng.standard_normal((50, CFG.vae.motion_dim)).astype(np.float32)

    pool = StreamPool(tm, max_sessions=capacity)
    assert pool.free_slots == capacity
    got_a, got_b = _pool_scenario(pool, a_chunks, b_chunks, style_b)
    assert pool.active_sessions == [0, 1] and pool.free_slots == capacity - 2
    for got, want in zip(got_a, _single_stream(tm, None, a_chunks)):
        np.testing.assert_allclose(got, want, atol=1e-5)
    for got, want in zip(got_b, _single_stream(tm, style_b, b_chunks)):
        np.testing.assert_allclose(got, want, atol=1e-5)
    if mode == "exact":
        jax_a, jax_b = _pool_scenario(JaxStreamPool(jm, jp, max_sessions=capacity),
                                      a_chunks, b_chunks, style_b)
        for got, want in zip(got_a + got_b, jax_a + jax_b):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_stream_pool_lifecycle():
    """Slot reuse starts from a fresh carry, grow keeps live sessions, and
    bad input raises before the tick."""
    _, _, tm = _models("exact")
    rng = np.random.default_rng(7)
    ws = tm.window_samples
    clip = [rng.standard_normal(ws).astype(np.float32) * 0.1 for _ in range(2)]
    want = _single_stream(tm, None, clip)
    pool = StreamPool(tm, max_sessions=1)
    s0 = pool.open_session()
    np.testing.assert_allclose(pool.step({s0: clip[0]})[s0], want[0], atol=1e-5)
    with pytest.raises(RuntimeError, match="full"):
        pool.open_session()
    with pytest.raises(ValueError):
        pool.grow(1)
    pool.grow(3)
    assert pool.capacity == 3 and pool.free_slots == 2
    np.testing.assert_allclose(pool.step({s0: clip[1]})[s0], want[1], atol=1e-5)
    pool.close_session(s0)
    s1 = pool.open_session()
    half = clip[0][: ws // 2]
    got = pool.step({s1: half})[s1]
    assert got.shape == (CFG.vae.window // 2, CFG.vae.motion_dim)
    np.testing.assert_allclose(got, _single_stream(tm, None, [half])[0][: len(got)], atol=1e-5)
    with pytest.raises(KeyError):
        pool.step({7: clip[0]})
    with pytest.raises(ValueError, match="exceeds"):
        pool.step({s1: np.zeros(ws + 1, np.float32)})


def test_serving_demo_runs(tmp_path, monkeypatch, capsys):
    """``python -m artalk_tpu_torch.serving`` on the CPU at the small config,
    int8: ticks for every session, then the steady-state line."""
    import artalk_tpu_torch.config as port_config
    from artalk_tpu_torch import serving

    from test_engine import _write_wav

    small = torch_config(CFG)
    monkeypatch.setattr(port_config, "ModelConfig", lambda: small)
    monkeypatch.setenv("ARTALK_AR_PRECISION", "int8")
    wav = _write_wav(tmp_path / "clip.wav", seconds=0.4)
    serving._demo(["-a", wav, "--sessions", "2", "--assets", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "tick 0: 2 sessions" in out and "tick 2: 2 sessions" in out
    assert "steady state" in out
