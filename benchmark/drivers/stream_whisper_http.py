"""Real-time streaming over HTTP on the Whisper-conditioned engine:
``stream_http.py``'s server, clients, window, release and layer data on
``ARTAvatarInferEngine(config=ModelConfig(ar=ARConfig(audio_encoder="whisper"),
whisper=WhisperEncoderConfig(...)))``, built from the configuration's widths
and the seeded weights of ``reference/params_whisper``.

Beside the decisions ``stream_http.py`` reads, the check reads what Whisper
computed, on the encoder instance: ``log_mel``'s output (the 30-s log-mel
of each row's context) and the encoder's output at the window's positions,
for the sampled sessions' rows of every step that carried their audio. The
reference (``reference/motion_whisper.py``) rebuilds each sampled session's
context from the windows it sent and encodes it in float32. Two numbers join
the stream's:

- ``whisper_emb_err``: the largest difference between the program's and the
  reference's encoder output at the window's 200 positions, over the
  reference's largest value, over every window checked;
- ``mel_err``: the same for the log-mel front, over the whole 30 s.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from benchmark import harness, judge, program, program_spans, work_whisper
from benchmark.drivers import stream_http
from benchmark.reference.motion import FP32, Precision
from benchmark.reference.motion_whisper import WhisperMotionReference
from benchmark.reference.params import make_params
from benchmark.reference.params_mimi import NO_WAV2VEC
from benchmark.reference.params_whisper import whisper_motion_spec

window, window_ticks = stream_http.window, stream_http.window_ticks

STAGES = ("whisper.logmel", "whisper.stem", "whisper.layers")


def model_config(model: dict):
    """The port's ``ModelConfig`` of the Whisper configuration's widths."""
    from artalk_tpu_torch.config import ARConfig, ModelConfig, VAEConfig, WhisperEncoderConfig

    ar, vae = model["ar"], model["vae"]
    return ModelConfig(
        ar=ARConfig(depth=ar["depth"], num_heads=ar["num_heads"], prev_ratio=ar["prev_ratio"],
                    audio_encoder="whisper", embed_dim=ar["embed_dim"], style_dim=ar["style_dim"],
                    mlp_ratio=ar["mlp_ratio"], audio_dim=ar["audio_dim"]),
        vae=VAEConfig(motion_dim=vae["motion_dim"], code_dim=vae["code_dim"],
                      depth=vae["depth"], num_heads=vae["num_heads"],
                      hidden_dim=vae["hidden_dim"], patch_nums=tuple(vae["patch_nums"])),
        whisper=WhisperEncoderConfig(**model["whisper"]), fps=float(model["fps"]),
        sample_rate=int(model["sample_rate"]))


def build_engine(model: dict, cell: dict, seed: int, device: torch.device):
    """The port's engine on the Whisper configuration and its seeded weights."""
    from artalk_tpu_torch.engine import ARTAvatarInferEngine

    program.set_precision(cell)
    return ARTAvatarInferEngine(
        load_gaga=False, clip_length=int(model["clip_length"]),
        assets_dir=str(program.assets_dir(model)), output_dir=str(harness.BENCH / "_cache" / "out"),
        config=model_config(model),
        params=program._host(make_params(whisper_motion_spec(model), seed, device)),
        image_size=int(model["renderer"]["image_size"]), seed=int(seed) % 2**31, device=device)


def keep_positions(model: dict) -> int:
    """Encoder positions of a window: 200 for 4 s at 50 Hz."""
    return model["window_samples"] // (2 * model["whisper"]["hop_length"])


class Taps:
    """What the Whisper encoder computed, read on the instance: each call's
    log-mel and its output at the window's positions; after set-up, only the
    sampled sessions' rows of the steps that carried their audio."""

    def __init__(self, encoder, keep: int):
        self.encoder = encoder
        self.calls = []                     # (mel, emb) of each step, until ``follow``
        self.last = {}
        self.kept = {}                      # sid -> [(mel (n_mels, T), emb (keep, d))]
        log_mel, forward = encoder.log_mel, encoder.forward

        def tap_log_mel(audio):
            self.last["mel"] = log_mel(audio)
            return self.last["mel"]

        def tap_forward(audio):
            out = forward(audio)
            self.last["emb"] = out[:, -keep:]
            if self.calls is not None:
                self.calls.append((self.last["mel"], self.last["emb"]))
            return out

        encoder.log_mel, encoder.forward = tap_log_mel, tap_forward

    def follow(self, state) -> None:
        """Keep the sampled rows of set-up's warm-up steps (which carry every
        session), then of each later step that carries a sampled session."""
        rec, pool = state["rec"], state["server"].pool
        warm = self.calls[-stream_http.WARM_TICKS:]
        if len(warm) != stream_http.WARM_TICKS:
            raise harness.BenchmarkError("the Whisper encoder was not called in the warm-up")
        self.calls = None
        self.kept = {sid: [(m[sid].clone(), e[sid].clone()) for m, e in warm]
                     for sid in rec.sampled}
        step = pool.step

        def tapped_step(chunks):
            out = step(chunks)
            for sid in rec.sampled & set(chunks):
                self.kept[sid].append((self.last["mel"][sid].clone(),
                                       self.last["emb"][sid].clone()))
            return out

        pool.step = tapped_step

    def release(self) -> None:
        for name in ("log_mel", "forward"):
            self.encoder.__dict__.pop(name, None)
        self.last = {}


def setup(ctx, engine=None):
    if engine is None:
        engine = build_engine(ctx.model, ctx.cell, ctx.seed, ctx.device)
    taps = Taps(engine.model.audio_encoder, keep_positions(ctx.model))
    state = stream_http.setup(ctx, engine=engine)
    taps.follow(state)
    state["taps"] = taps
    return state


def release(state) -> None:
    state["taps"].release()
    stream_http.release(state)


# ----------------------------------------------------------------- the check


def _follow(ctx, state, prec: Precision) -> dict:
    """``stream_http._follow`` on the Whisper reference: each sampled
    session's windows, in the order it sent them, at ``prec``."""
    model, device = ctx.model, ctx.device
    ref = WhisperMotionReference(model, make_params(whisper_motion_spec(model), ctx.seed, device),
                                 prec)
    rec, taps = state["rec"], state["taps"]
    out = {}
    for sid, steps in sorted(rec.steps.items()):
        if len(taps.kept[sid]) != len(steps):
            raise harness.BenchmarkError(f"session {sid}: {len(steps)} steps, "
                                         f"{len(taps.kept[sid])} Whisper encodes")
        audio = torch.from_numpy(np.stack([_window(a, model) for a, _, _ in steps])).to(device)
        served = [(b, c) for _, b, c in steps]
        out[sid] = {"followed": ref.follow(audio, served, rec.carry0[sid]),
                    "latent0": ref.initial_latent(rec.carry0[sid], device),
                    "served": served}
    return out


def _window(chunk: np.ndarray, model: dict) -> np.ndarray:
    """A chunk as the pool steps it: zero-padded to the window."""
    out = np.zeros(model["window_samples"], np.float32)
    out[:len(chunk)] = chunk
    return out


def whisper_numbers(state, ref: dict, candidate: dict | None = None) -> dict:
    """``whisper_emb_err`` and ``mel_err`` of the program (``candidate``
    None: what its encoder computed) or of a lower-precision reference in
    its place, against the float32 reference."""
    embs, mels = [0.0], [0.0]
    for sid in sorted(ref):
        want = ref[sid]["followed"]["whisper"]
        if candidate is None:
            got = state["taps"].kept[sid]
        else:
            enc = candidate[sid]["followed"]["whisper"]
            got = list(zip(enc["mel"], enc["emb"]))
        for i, (mel, emb) in enumerate(got):
            mels.append(judge.motion_err(mel.float().cpu().numpy(), want["mel"][i].cpu().numpy()))
            embs.append(judge.motion_err(emb.float().cpu().numpy(), want["emb"][i].cpu().numpy()))
    return {"whisper_emb_err": max(embs), "mel_err": max(mels)}


def _fp32_reference(ctx, state) -> dict:
    if "ref" not in state:
        state["ref"] = _follow(ctx, state, FP32)
    return state["ref"]


def program_numbers(ctx, state) -> dict:
    ref = _fp32_reference(ctx, state)
    return {**stream_http.numbers_of(ctx, state, ref), **whisper_numbers(state, ref)}


def check(ctx, state) -> tuple:
    nums = program_numbers(ctx, state)
    ok, rows = judge.verdict(nums, ctx.cell["limits"])
    ok = ok and nums["chunks_checked"] > 0
    return ok, rows + [("chunks_checked", nums["chunks_checked"], None)]


def control(ctx, state, prec: Precision) -> dict:
    ref, cand = _fp32_reference(ctx, state), _follow(ctx, state, prec)
    return {**stream_http.numbers_of(ctx, state, ref, cand),
            **whisper_numbers(state, ref, cand)}


# ----------------------------------------------------------- layer readings


def whisper_tick_ms(data: dict) -> list:
    """Per tick after the traced stretch (``pool.tick``), the summed
    ``device_us`` of the Whisper stage spans inside it, in ms; a tick without
    all three stages timed on the device is left out (empty where the
    program records none)."""
    ticks = program_spans.stream_ticks(data) or []
    stages = program_spans.kept(STAGES) or []
    out = []
    for t in ticks:
        inside = [s for s in stages if s.thread == t.thread and t.start_ns <= s.start_ns
                  and s.end_ns <= t.end_ns]
        if sorted(s.name for s in inside) == sorted(STAGES) and \
                all("device_us" in s.attrs for s in inside):
            out.append(sum(s.attrs["device_us"] for s in inside) / 1e3)
    return out


def layer_data(ctx, state) -> dict:
    """``stream_http.layer_data``, with the Whisper step's FLOPs, the model's
    configuration and the Whisper stages' device time per tick
    (``whisper_ms``)."""
    base = copy.copy(ctx)
    base.model = dict(ctx.model, wav2vec=NO_WAV2VEC)
    data = stream_http.layer_data(base, state)
    data.update(model=ctx.model,
                step_flops=work_whisper.window_step_flops(ctx.model, ctx.model["window_samples"]))
    data["whisper_ms"] = whisper_tick_ms(data)
    return data
