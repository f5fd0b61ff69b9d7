"""The port's Mimi encoder, and the Mimi-conditioned stream pool, against the
benchmark's plain reference (``benchmark/reference/mimi.py`` and
``motion_mimi.py``) on seeded weights from its parameter spec
(``benchmark/reference/params_mimi.py``), at small sizes on the CPU.

The codes are held to the teacher-forced reference by ``rvq_code_gap`` (the
served code's squared distance above the stage's nearest, relative) and the
transformer's output by ``mimi_emb_err`` (the largest difference over the
reference's largest value). The tolerance of both, 1e-5, is float32 rounding
through the SEANet's convolutions and the transformer summed in another
order (the reference resamples by a transposed convolution and takes the
RVQ distances as sums of squared differences); TF32's 10-bit mantissa would
read about 1e-3.
"""

import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from artalk_tpu_torch.config import MimiEncoderConfig
from artalk_tpu_torch.models.mimi import MimiEncoder, resample_16k_to_24k
from artalk_tpu_torch.serving import StreamPool
from artalk_tpu_torch.utils.metrics import GLOBAL_METRICS
from artalk_tpu_torch.utils.params import params_from_flat
from benchmark import judge, traffic
from benchmark.drivers.stream_mimi_http import model_config
from benchmark.reference.mimi import MimiReference
from benchmark.reference.mimi import resample_16k_to_24k as ref_resample
from benchmark.reference.motion_mimi import MimiMotionReference
from benchmark.reference.params import make_params
from benchmark.reference.params_mimi import mimi_motion_spec, mimi_spec
from test_mimi import SMALL

CPU = torch.device("cpu")
TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "benchmark" / "cells" / "stream-mimi-int8-http.json").read_text())[
    "limits"]

# tests/test_mimi.py's SMALL, and a window shorter than its frames
CONFIGS = {"small": (dataclasses.asdict(SMALL), 7680),
           "short_window": (dict(dataclasses.asdict(SMALL), sliding_window=5), 19200)}


def _group(cfg: dict) -> dict:
    return dict(cfg, ratios=list(cfg["ratios"]))


def _codebook_std(cfg: dict, seed: int) -> float:
    """The RVQ residual's std at these seeded weights on speech-like audio,
    as the configuration sets its ``mimi_codebook_std``."""
    ref = MimiReference(cfg, make_params(mimi_spec(cfg, 1.0), seed, CPU))
    with torch.no_grad():
        return float(ref.rvq_inputs(ref.encode(_audio(seed, 4, 16000))["down"])[0].std())


def _audio(seed: int, rows: int, n: int) -> torch.Tensor:
    return torch.from_numpy(np.stack([traffic.speech_like(seed, 300 + i, n) for i in range(rows)]))


def _encoder(cfg: dict, params: dict) -> MimiEncoder:
    enc = MimiEncoder(MimiEncoderConfig(**dict(cfg, ratios=tuple(cfg["ratios"]))))
    enc.load_state_dict({k[len("audio_encoder//"):].replace("//", "."): v
                         for k, v in params.items() if k.startswith("audio_encoder//")})
    return enc


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_against_the_teacher_forced_reference(name):
    cfg, samples = CONFIGS[name]
    cfg = _group(cfg)
    seed = 2**31 + 11
    params = make_params(mimi_spec(cfg, _codebook_std(cfg, seed)), seed, CPU)
    enc, ref = _encoder(cfg, params), MimiReference(cfg, params)
    audio = _audio(seed + 1, 3, samples)
    with torch.no_grad():
        emb = enc.transform(enc.seanet_encode(resample_16k_to_24k(audio)).transpose(1, 2))
        codes = enc.quantize(emb.transpose(1, 2))
        cond = enc(audio)
        out = ref.encode(audio, codes)
        own = ref.encode(audio)["codes"]
    frames = emb.shape[1]
    assert frames > cfg["sliding_window"] if name == "short_window" else frames <= 16
    assert ref.code_gap(out["down"], codes) <= TOL
    assert judge.motion_err(emb.numpy(), out["emb"].numpy()) <= TOL
    assert judge.motion_err(cond.numpy(), out["cond"].numpy()) <= TOL
    assert (own == codes).float().mean() >= 0.99      # the control's own choice: the nearest
    assert len(set(codes[:, 0].flatten().tolist())) > 1
    if name == "short_window":       # the mask matters: without the window the reference drifts
        wide = MimiReference(dict(cfg, sliding_window=frames), params)
        with torch.no_grad():
            wide_emb = wide.encode(audio, codes)["emb"]
        assert judge.motion_err(emb.numpy(), wide_emb.numpy()) > 100 * TOL


def test_resamplers_agree_in_length_and_value():
    audio = _audio(5, 2, 6401)
    got, want = resample_16k_to_24k(audio), ref_resample(audio)
    assert got.shape == want.shape == (2, (3 * 6401 - 3) // 2 + 1)
    assert float((got - want).abs().max()) <= 1e-6


# ------------------------------------------------------------ the stream pool

SMALL_MODEL = {
    "sample_rate": 16000, "fps": 25, "window_samples": 2560, "clip_length": 750,
    "mimi": _group(dataclasses.asdict(SMALL)),
    "ar": {"embed_dim": 32, "depth": 2, "num_heads": 4, "mlp_ratio": 4.0, "style_dim": 16,
           "prev_ratio": 1, "audio_dim": 32},
    "vae": {"motion_dim": 106, "code_dim": 8, "depth": 2, "num_heads": 2, "hidden_dim": 32,
            "patch_nums": [1, 2, 4]},
    "style_encoder": {"feature_dim": 16, "num_layers": 4, "num_heads": 4, "ffn_dim": 512,
                      "max_len": 600},
}
TICKS = 3


def _stream(fault=None, seed=2**31 + 3):
    """Two sessions of a small Mimi-conditioned pool for three ticks, what
    the pool served read on the instance, and the reference following each
    session teacher-forced: the check's numbers."""
    model = copy.deepcopy(SMALL_MODEL)
    model["mimi_codebook_std"] = _codebook_std(model["mimi"], seed)
    params = make_params(mimi_motion_spec(model), seed, CPU)
    net = params_from_flat({k: v.numpy() for k, v in params.items()}, model_config(model))
    enc = net.audio_encoder
    if fault == "seanet":
        with torch.no_grad():
            enc.seanet.blocks[0].down.w.mul_(1.01)
    got = {}
    transform, decode, dec_window = enc.transform, enc.decode_codes, net.decode_window
    enc_bits = net.vae.encode_to_bits

    def tap_transform(x):
        got["emb"] = transform(x)
        return got["emb"]

    def tap_decode(codes):
        if fault == "code":
            codes = codes.clone()
            codes[:, 1, 0] = (codes[:, 1, 0] + 1) % model["mimi"]["codebook_size"]
        got["codes"] = codes
        return decode(codes)

    def tap_window(*a, **k):
        got["bits"] = dec_window(*a, **k)
        return got["bits"]

    def tap_bits(*a, **k):
        out = enc_bits(*a, **k)
        got["carry"] = out[0]
        return out

    enc.transform, enc.decode_codes, net.decode_window = tap_transform, tap_decode, tap_window
    net.vae.encode_to_bits = tap_bits
    pool = StreamPool(net, max_sessions=2)
    sids = [pool.open_session() for _ in range(2)]
    carry0 = {s: pool._state.prev_bits[s].clone() for s in sids}
    steps = {s: [] for s in sids}
    received = {s: [] for s in sids}
    with torch.no_grad():
        for t in range(TICKS):
            chunks = {s: traffic.speech_like(seed, 10 * t + s, 2560) for s in sids}
            out = pool.step(chunks)
            for s in sids:
                steps[s].append((chunks[s], got["bits"][s].clone(), got["carry"][s].clone(),
                                 got["emb"][s].clone(), got["codes"][s].clone()))
                received[s].append(out[s])
    ref = MimiMotionReference(model, params)
    followed, latents0, motions, refs, served, gaps, errs = [], [], [], [], [], [], []
    for s in sids:
        audio = torch.from_numpy(np.stack([a for a, *_ in steps[s]]))
        pairs = [(b, c) for _, b, c, _, _ in steps[s]]
        f = ref.follow(audio, pairs, carry0[s], [k for *_, k in steps[s]])
        followed.append(f)
        served.append(pairs)
        latents0.append(ref.initial_latent(carry0[s], CPU))
        motions.append(np.concatenate(received[s]))
        refs.append(f["motion"].numpy())
        for w, (*_, emb, codes) in zip(f["mimi"], steps[s]):
            gaps.append(ref.code_gap(w["down"], codes[None]))
            errs.append(judge.motion_err(emb.numpy(), w["emb"][0].numpy()))
    nums = judge.stream_numbers(followed, served, [carry0[s] for s in sids], latents0, motions,
                                refs)
    nums.update(rvq_code_gap=max(gaps), mimi_emb_err=max(errs))
    return nums


def test_pool_follows_the_reference():
    nums = _stream()
    ok, rows = judge.verdict(nums, LIMITS)
    assert ok, rows
    assert nums["rvq_code_gap"] <= TOL and nums["mimi_emb_err"] <= TOL, nums
    assert nums["ar_bit_gap"] == 0.0 and nums["motion_err"] <= 1e-5, nums


@pytest.mark.parametrize("fault", ["code", "seanet"])
def test_faults_fail_the_verdict(fault):
    nums = _stream(fault)
    ok, rows = judge.verdict(nums, LIMITS)
    assert not ok, rows
    failed = {n for n, v, lim in rows if not v <= lim}
    assert failed & {"rvq_code_gap", "mimi_emb_err"}, rows


def test_stage_spans_once_a_window():
    model = copy.deepcopy(SMALL_MODEL)
    model["mimi_codebook_std"] = 1e-3
    params = make_params(mimi_motion_spec(model), 1, CPU)
    net = params_from_flat({k: v.numpy() for k, v in params.items()}, model_config(model))
    pool = StreamPool(net, max_sessions=3)
    sids = [pool.open_session() for _ in range(2)]
    GLOBAL_METRICS.reset()
    with torch.no_grad():
        for t in range(2):
            pool.step({s: traffic.speech_like(1, t, 2560) for s in sids})
    spans = GLOBAL_METRICS.spans()
    encode = [sp for sp in spans if sp.name == "window.encode"]
    stages = [sp for sp in spans if sp.name.startswith("mimi.")]
    assert len(encode) == 2
    assert [sp.name for sp in stages] == ["mimi.resample", "mimi.seanet", "mimi.transformer",
                                          "mimi.rvq"] * 2
    assert {sp.parent for sp in stages} == {sp.id for sp in encode}
    frames = [sp.attrs["frames"] for sp in stages[:4]]
    assert frames == [(3 * 2560 - 3) // 2 + 1, 4, 4, 2]
    for sp in stages:
        assert sp.attrs["rows"] == 3 and "device_us" not in sp.attrs
