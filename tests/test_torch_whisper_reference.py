"""The port's Whisper encoder, and the Whisper-conditioned stream pool, against
the benchmark's plain reference (``benchmark/reference/whisper.py`` and
``motion_whisper.py``) on seeded weights from its parameter spec
(``benchmark/reference/params_whisper.py``), at a small size on the CPU: 16
mel bins, d 64, 2 layers, and a context of 0.48 s (48 mel frames, 24
positions) with windows of 0.16 s (8 positions), so that the third window of
a session is the first whose context is all audio.

Tolerances, each over the reference's largest value: the encoder's output
1e-5 (float32 rounding through the convolutions and two layers summed in
another order; TF32's 10-bit mantissa would read about 1e-3); the log-mel
1e-5 (the port's FFT against the reference's DFT as a matrix product, in
float32, then a logarithm of powers that stay far above the floor 8 decades
below each row's peak).
"""

import copy
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from artalk_tpu_torch.config import (ARConfig, ModelConfig, VAEConfig, WhisperEncoderConfig,
                                     load_config)
from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.export_model import export_window_step
from artalk_tpu_torch.models.ar_model import BitwiseARModel
from artalk_tpu_torch.models.whisper import WhisperEncoder, mel_filter_bank
from artalk_tpu_torch.serving import StreamPool
from artalk_tpu_torch.utils.metrics import GLOBAL_METRICS
from artalk_tpu_torch.utils.params import params_from_flat
from benchmark import judge, traffic
from benchmark.drivers.stream_whisper_http import model_config
from benchmark.reference import whisper as ref_whisper
from benchmark.reference.motion_whisper import WhisperMotionReference
from benchmark.reference.params import make_params
from benchmark.reference.params_whisper import whisper_motion_spec, whisper_spec
from benchmark.reference.whisper import WhisperReference

CPU = torch.device("cpu")
TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "benchmark" / "cells" / "stream-whisper-int8-http.json").read_text())[
    "limits"]
SMALL = {"num_mel_bins": 16, "n_fft": 400, "hop_length": 160, "sampling_rate": 16000,
         "chunk_length": 0.48, "d_model": 64, "encoder_layers": 2, "encoder_attention_heads": 4,
         "encoder_ffn_dim": 128, "max_source_positions": 24, "layer_norm_eps": 1e-5}
WINDOW = 2560


def _audio(seed: int, rows: int, n: int) -> torch.Tensor:
    return torch.from_numpy(np.stack([traffic.speech_like(seed, 300 + i, n) for i in range(rows)]))


def _encoder(params: dict) -> WhisperEncoder:
    enc = WhisperEncoder(WhisperEncoderConfig(**SMALL))
    enc.load_state_dict({k[len("audio_encoder//"):].replace("//", "."): v
                         for k, v in params.items() if k.startswith("audio_encoder//")})
    return enc


def test_encoder_against_the_reference():
    params = make_params(whisper_spec(SMALL), 2**31 + 17, CPU)
    enc, ref = _encoder(params), WhisperReference(SMALL, params)
    audio = _audio(4, 3, 7680)
    audio[1, :5000] = 0.0                      # a right-aligned context: silence, then speech
    with torch.no_grad():
        got, want = enc(audio), ref.encode(audio)
        mel = enc.log_mel(audio)
    assert got.shape == want["emb"].shape == (3, 24, 64)
    assert mel.shape == want["mel"].shape == (3, 16, 48)
    assert judge.motion_err(got.numpy(), want["emb"].numpy()) <= TOL
    assert judge.motion_err(mel.numpy(), want["mel"].numpy()) <= TOL
    # each row's floor is its own: the part-silent row sits 8 decades below its own peak
    peaks = want["mel"].flatten(1).amax(-1)
    assert torch.allclose(mel.flatten(1).amin(-1)[1], peaks[1] - 2.0, atol=1e-6)


def test_the_filter_bank_is_slaneys():
    """The filters against the Slaney formula worked by hand at FFT bins of
    known frequency (bin k lies at 40 k Hz), and against the reference's."""
    log_step = math.log(6.4) / 27.0

    def mel(f):
        return 3.0 * f / 200.0 if f < 1000.0 else 15.0 + math.log(f / 1000.0) / log_step

    def hz(m):
        return 200.0 * m / 3.0 if m < 15.0 else 1000.0 * math.exp(log_step * (m - 15.0))

    assert mel(1000.0) == 15.0 and mel(200.0) == 3.0 and mel(6400.0) == pytest.approx(42.0)
    bank = mel_filter_bank(128, 400, 16000, 0.0, 8000.0)
    assert bank.shape == (128, 201)
    edges = [hz(mel(8000.0) * i / 129) for i in range(130)]
    for k in (1, 5, 25, 26, 60, 120, 199):
        f = 40.0 * k
        for m in range(128):
            lo, c, hi = edges[m], edges[m + 1], edges[m + 2]
            want = max(0.0, min((f - lo) / (c - lo), (hi - f) / (hi - c))) * 2.0 / (hi - lo)
            assert bank[m, k] == pytest.approx(want, rel=1e-6, abs=1e-9), (k, m)
    assert bank[:, 0].max() == 0.0 and (bank.max(1) > 0).all()
    # 1 kHz (bin 25) lies on exactly two filters, the rising one and the falling one
    assert (bank[:, 25] > 0).sum() == 2
    # unit area: the wide filters' sums over 40-Hz bins come to 1 / 40 Hz
    assert np.allclose(bank[100:].sum(1) * 40.0, 1.0, atol=0.02)
    np.testing.assert_allclose(bank, ref_whisper.slaney_filters(128, 400, 16000, 0.0, 8000.0),
                               rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------ the stream pool

SMALL_MODEL = {
    "sample_rate": 16000, "fps": 25, "window_samples": WINDOW, "clip_length": 750,
    "whisper": SMALL,
    "ar": {"embed_dim": 32, "depth": 2, "num_heads": 4, "mlp_ratio": 4.0, "style_dim": 16,
           "prev_ratio": 1, "audio_dim": 64},
    "vae": {"motion_dim": 106, "code_dim": 8, "depth": 2, "num_heads": 2, "hidden_dim": 32,
            "patch_nums": [1, 2, 4]},
    "style_encoder": {"feature_dim": 16, "num_layers": 4, "num_heads": 4, "ffn_dim": 512,
                      "max_len": 600},
}
# session -> its slot's ticks: "a" idles in none and closes after tick 2,
# "b" idles in tick 2, "c" opens in "a"'s slot for tick 3
SENDS = {"a": (0, 1), "b": (0, 2), "c": (2,)}


def _net(model, params):
    return params_from_flat({k: v.numpy() for k, v in params.items()}, model_config(model))


def _stream(fault=None, seed=2**31 + 3):
    """Three ticks of a small Whisper pool of capacity 3: sessions "a" and
    "b" both in tick 1, "a" alone in tick 2, then "a" closed and "c" opened in
    its slot, and "b" and "c" in tick 3. What the pool served and what the
    encoder computed are read on the instance; the reference follows each
    session from the windows it sent. Returns the check's numbers."""
    model = copy.deepcopy(SMALL_MODEL)
    params = make_params(whisper_motion_spec(model), seed, CPU)
    net = _net(model, params)
    enc = net.audio_encoder
    if fault == "k_bias":        # v's bias moved onto k, where softmax ignores it
        with torch.no_grad():
            enc.layers.k.b = torch.nn.Parameter(enc.layers.v.b.clone(), requires_grad=False)
            enc.layers.v.b.zero_()
    got = {}
    log_mel, forward, dec_window = enc.log_mel, enc.forward, net.decode_window
    enc_bits = net.vae.encode_to_bits

    def tap_log_mel(audio):
        got["mel"] = log_mel(audio)
        return got["mel"]

    def tap_forward(audio):
        got["emb"] = forward(audio)[:, -8:]
        return got["emb"]

    def tap_window(*a, **k):
        got["bits"] = dec_window(*a, **k)
        return got["bits"]

    def tap_bits(*a, **k):
        out = enc_bits(*a, **k)
        got["carry"] = out[0]
        return out

    enc.log_mel, enc.forward, net.decode_window = tap_log_mel, tap_forward, tap_window
    net.vae.encode_to_bits = tap_bits
    pool = StreamPool(net, max_sessions=3)
    if fault == "idle_history":      # every row's context rolls, stepped or not
        step = pool.device_step

        def device_step(audio, stepped):
            old = pool._state.audio_ctx
            out = step(audio, stepped)
            pool._state = pool._state._replace(audio_ctx=net.roll_audio_ctx(old, audio))
            return pool._state, out[1]

        pool.device_step = device_step
    if fault == "reopened_slot":     # a reused slot keeps its last session's audio
        opener = pool.open_session

        def open_session(*a, **k):
            kept = pool._state.audio_ctx.clone()
            sid = opener(*a, **k)
            pool._state.audio_ctx.copy_(kept)
            return sid

        pool.open_session = open_session
    slots = {"a": pool.open_session(), "b": pool.open_session()}
    carry0 = {s: pool._state.prev_bits[slots[s]].clone() for s in slots}
    steps = {s: [] for s in SENDS}
    received = {s: [] for s in SENDS}
    with torch.no_grad():
        for t in range(3):
            if t == 2:
                pool.close_session(slots["a"])
                slots["c"] = pool.open_session()
                assert slots["c"] == slots["a"]
                carry0["c"] = pool._state.prev_bits[slots["c"]].clone()
            senders = [s for s in SENDS if t in SENDS[s]]
            chunks = {slots[s]: traffic.speech_like(seed, 10 * t + i, WINDOW)
                      for i, s in enumerate(senders)}
            out = pool.step(chunks)
            for s in senders:
                r = slots[s]
                steps[s].append((chunks[r], got["bits"][r].clone(), got["carry"][r].clone(),
                                 got["mel"][r].clone(), got["emb"][r].clone()))
                received[s].append(out[r])
    ref = WhisperMotionReference(model, params)
    followed, latents0, motions, refs, served, embs, mels = [], [], [], [], [], [], []
    for s in SENDS:
        audio = torch.from_numpy(np.stack([a for a, *_ in steps[s]]))
        pairs = [(b, c) for _, b, c, _, _ in steps[s]]
        f = ref.follow(audio, pairs, carry0[s])
        followed.append(f)
        served.append(pairs)
        latents0.append(ref.initial_latent(carry0[s], CPU))
        motions.append(np.concatenate(received[s]))
        refs.append(f["motion"].numpy())
        for i, (*_, mel, emb) in enumerate(steps[s]):
            mels.append(judge.motion_err(mel.numpy(), f["whisper"]["mel"][i].numpy()))
            embs.append(judge.motion_err(emb.numpy(), f["whisper"]["emb"][i].numpy()))
    nums = judge.stream_numbers(followed, served, list(carry0.values()), latents0, motions, refs)
    nums.update(whisper_emb_err=max(embs), mel_err=max(mels))
    return nums


def test_pool_follows_the_reference():
    nums = _stream()
    ok, rows = judge.verdict(nums, LIMITS)
    assert ok, rows
    assert nums["whisper_emb_err"] <= TOL and nums["mel_err"] <= TOL, nums
    assert nums["ar_bit_gap"] == 0.0 and nums["motion_err"] <= 1e-5, nums


@pytest.mark.parametrize("fault", ["idle_history", "reopened_slot", "k_bias"])
def test_faults_fail_the_verdict(fault):
    nums = _stream(fault)
    ok, rows = judge.verdict(nums, LIMITS)
    assert not ok, rows
    failed = {n for n, v, lim in rows if not v <= lim}
    # a wrong context shows first in its log-mel, a wrong layer in the output
    assert ("whisper_emb_err" if fault == "k_bias" else "mel_err") in failed, rows


def test_a_bias_on_k_alone_changes_nothing():
    """Why Whisper's k has no bias, and why the planted fault moves v's: a
    bias on k adds q . b to every logit of a query, which softmax takes
    away."""
    params = make_params(whisper_spec(SMALL), 5, CPU)
    enc = _encoder(params)
    audio = _audio(6, 2, 7680)
    with torch.no_grad():
        want = enc(audio)
        enc.layers.k.b = torch.nn.Parameter(torch.full_like(enc.layers.v.b, 0.3),
                                            requires_grad=False)
        got = enc(audio)
    assert judge.motion_err(got.numpy(), want.numpy()) <= TOL


def test_stage_spans_once_a_window():
    model = copy.deepcopy(SMALL_MODEL)
    net = _net(model, make_params(whisper_motion_spec(model), 1, CPU))
    pool = StreamPool(net, max_sessions=3)
    sids = [pool.open_session() for _ in range(2)]
    GLOBAL_METRICS.reset()
    with torch.no_grad():
        for t in range(2):
            pool.step({s: traffic.speech_like(1, t, WINDOW) for s in sids})
    spans = GLOBAL_METRICS.spans()
    encode = [sp for sp in spans if sp.name == "window.encode"]
    stages = [sp for sp in spans if sp.name.startswith("whisper.")]
    assert len(encode) == 2
    assert [sp.name for sp in stages] == ["whisper.logmel", "whisper.stem",
                                          "whisper.layers"] * 2
    assert {sp.parent for sp in stages} == {sp.id for sp in encode}
    assert [sp.attrs["frames"] for sp in stages[:3]] == [48, 24, 24]
    for sp in stages:
        assert sp.attrs["rows"] == 3 and "device_us" not in sp.attrs


# ------------------------------------------------ the carry, the engine, the pool


def _small_cfg(**kw) -> ModelConfig:
    return ModelConfig(
        ar=ARConfig(depth=2, num_heads=4, audio_encoder="whisper", embed_dim=32, style_dim=16,
                    audio_dim=64),
        vae=VAEConfig(code_dim=8, depth=2, num_heads=2, hidden_dim=32, patch_nums=(1, 2, 4)),
        whisper=WhisperEncoderConfig(**SMALL), **kw)


def test_carry_rolls_and_generate_equals_the_stream():
    """The context after each window is the last 5120 samples of the audio
    so far (zeros before it); offline ``generate`` conditions each window on
    the clip's earlier chunks exactly as window steps do."""
    model = BitwiseARModel(_small_cfg()).init(torch.Generator().manual_seed(0))
    style = model.encode_style(None)
    chunks = _audio(9, 3, WINDOW)[:, None]
    state = model.initial_state(style)
    assert state.audio_ctx.shape == (1, 5120) and not state.audio_ctx.any()
    with torch.no_grad():
        motions = []
        for i in range(3):
            state, motion = model.window_step(state, chunks[i], style)
            motions.append(motion)
            stream = torch.cat([torch.zeros(5120), chunks[:i + 1, 0].reshape(-1)])
            assert torch.equal(state.audio_ctx[0], stream[-5120:])
        offline = model.generate(chunks, style)
    assert torch.equal(offline, torch.cat(motions, dim=1))


def test_grow_keeps_live_contexts_and_adds_silent_rows():
    model = BitwiseARModel(_small_cfg()).init(torch.Generator().manual_seed(1))
    pool = StreamPool(model, max_sessions=2)
    sids = [pool.open_session() for _ in range(2)]
    with torch.no_grad():
        pool.step({s: traffic.speech_like(2, s, WINDOW) for s in sids})
    before = pool._state.audio_ctx.clone()
    pool.grow(4)
    assert torch.equal(pool._state.audio_ctx[:2], before)
    assert pool._state.audio_ctx.shape == (4, 5120) and not pool._state.audio_ctx[2:].any()
    assert before.any()


def test_engine_from_config_json_with_whisper(tmp_path, monkeypatch):
    """A config.json with "AUDIO_ENCODER": "whisper" and a small
    WHISPER_CONFIG gives the Whisper-conditioned engine on the CPU: the AdaLN
    input follows the encoder's width, no fused audio pack, ``inference``
    equals ``stream`` over the same windows (the stream's carry holds the
    context), and a stream resumed from its carry goes on hearing it."""
    from artalk_tpu_torch.utils.assets import save_flame_npz, synthetic_flame

    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(tmp_path / "flame_synthetic.npz"))
    cfg = {"AR_CONFIG": {"T_DEPTH": 1, "T_NUM_HEADS": 12, "AUDIO_ENCODER": "whisper"},
           "VAE_CONFIG": {"T_DEPTH": 1, "T_HIDDEN_DIM": 32, "V_CODE_DIM": 8,
                          "V_PATCH_NUMS": [1, 2, 4]},
           "WHISPER_CONFIG": SMALL}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    loaded = load_config(str(tmp_path / "config.json"))
    assert loaded.ar.audio_feature_dim == 64
    assert json.loads(json.dumps(loaded.to_json_dict())) == dict(
        cfg, AR_CONFIG=dict(cfg["AR_CONFIG"], PREV_RATIO=1),
        VAE_CONFIG=loaded.vae.to_json_dict())
    monkeypatch.setenv("ARTALK_AR_PRECISION", "int8")
    monkeypatch.delenv("ARTALK_AR_FUSED", raising=False)
    eng = ARTAvatarInferEngine(assets_dir=str(tmp_path), output_dir=str(tmp_path / "out"),
                               image_size=64, device="cpu")
    assert isinstance(eng.model.audio_encoder, WhisperEncoder)
    assert eng.model.fused_audio_pack is None and eng.model.fused_pack is not None
    weights = eng.model.audio_weights()
    assert weights is eng.model.audio_weights() and weights["layers.q.w"].dtype == torch.bfloat16
    audio = (np.random.default_rng(6).standard_normal(3 * WINDOW) * 0.1).astype(np.float32)
    eng.fix_pose = False
    raw = np.concatenate(list(eng.stream([audio[:WINDOW], audio[WINDOW:2 * WINDOW]])))
    resumed = next(eng.stream([audio[2 * WINDOW:]], state=eng.last_stream_state))
    fresh = next(eng.stream([audio[2 * WINDOW:]]))
    whole = np.concatenate(list(eng.stream([audio[i:i + WINDOW]
                                            for i in range(0, 3 * WINDOW, WINDOW)])))
    np.testing.assert_array_equal(np.concatenate([raw, resumed]), whole)
    assert not np.array_equal(resumed, fresh)
    motions = eng.inference(audio)
    assert motions.shape == (12, 106) and np.isfinite(motions).all()


def test_export_refuses_whisper():
    model = BitwiseARModel(_small_cfg()).init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="whisper"):
        export_window_step(model)


@pytest.mark.parametrize("encoder", ["wav2vec", "mimi"])
def test_other_encoders_carry_no_context(encoder):
    """XLS-R and Mimi keep a two-tensor carry: ``audio_ctx`` is None from the
    bootstrap through a window step and a pool step."""
    from artalk_tpu_torch.config import MimiEncoderConfig, Wav2VecConfig

    w2v = Wav2VecConfig(conv_dim=(16,) * 7, hidden_size=32, num_hidden_layers=1,
                        num_attention_heads=4, intermediate_size=64, num_conv_pos_embeddings=8,
                        num_conv_pos_embedding_groups=4)
    mimi = MimiEncoderConfig(num_filters=8, hidden_size=32, num_hidden_layers=1, num_heads=2,
                             head_dim=16, intermediate_size=64, codebook_size=16,
                             codebook_dim=8, num_quantizers=2, sliding_window=16)
    cfg = dataclasses.replace(_small_cfg(), wav2vec=w2v, mimi=mimi,
                              ar=ARConfig(depth=1, num_heads=4, audio_encoder=encoder,
                                          embed_dim=32, style_dim=16, audio_dim=32))
    model = BitwiseARModel(cfg).init(torch.Generator().manual_seed(0))
    style = model.encode_style(None)
    state = model.initial_state(style)
    assert state.audio_ctx is None
    with torch.no_grad():
        state, _ = model.window_step(state, _audio(1, 1, WINDOW), style)
        assert state.audio_ctx is None
        pool = StreamPool(model, max_sessions=2)
        sid = pool.open_session()
        pool.step({sid: traffic.speech_like(1, 1, WINDOW)})
        pool.grow(3)
    assert pool._state.audio_ctx is None and len(pool._state) == 3
