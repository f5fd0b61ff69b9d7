"""Real-time streaming over HTTP on the Mimi-conditioned engine:
``stream_http.py``'s server, clients, window, release and layer data on
``ARTAvatarInferEngine(config=ModelConfig(ar=ARConfig(audio_encoder="mimi"),
mimi=MimiEncoderConfig(...)))``, built from the configuration's widths and
the seeded weights of ``reference/params_mimi``.

Beside the decisions ``stream_http.py`` reads, the check reads what Mimi
served, on the encoder instance: ``transform``'s output (the transformer's
25 Hz embedding) and the codes ``decode_codes`` turns into the condition,
for the sampled sessions' rows of every step that carried their audio. The
reference (``reference/motion_mimi.py``) follows each sampled session
teacher-forced on those codes. Two numbers join the stream's:

- ``rvq_code_gap``: the widest relative gap (d2[served] - d2[nearest]) /
  |d2[nearest]| of the served codes, over every RVQ stage, frame and window
  checked, each stage's residual built from the served codes;
- ``mimi_emb_err``: the largest difference between the program's and the
  reference's transformer output over the reference's largest value.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from benchmark import harness, judge, program, program_spans, work_mimi
from benchmark.drivers import stream_http
from benchmark.reference.motion import FP32, Precision
from benchmark.reference.motion_mimi import MimiMotionReference
from benchmark.reference.params import make_params
from benchmark.reference.params_mimi import mimi_motion_spec

window, window_ticks = stream_http.window, stream_http.window_ticks


def model_config(model: dict):
    """The port's ``ModelConfig`` of the Mimi configuration's widths."""
    from artalk_tpu_torch.config import ARConfig, MimiEncoderConfig, ModelConfig, VAEConfig

    ar, vae, mimi = model["ar"], model["vae"], dict(model["mimi"])
    mimi["ratios"] = tuple(mimi["ratios"])
    return ModelConfig(
        ar=ARConfig(depth=ar["depth"], num_heads=ar["num_heads"], prev_ratio=ar["prev_ratio"],
                    audio_encoder="mimi", embed_dim=ar["embed_dim"], style_dim=ar["style_dim"],
                    mlp_ratio=ar["mlp_ratio"], audio_dim=ar["audio_dim"]),
        vae=VAEConfig(motion_dim=vae["motion_dim"], code_dim=vae["code_dim"],
                      depth=vae["depth"], num_heads=vae["num_heads"],
                      hidden_dim=vae["hidden_dim"], patch_nums=tuple(vae["patch_nums"])),
        mimi=MimiEncoderConfig(**mimi), fps=float(model["fps"]),
        sample_rate=int(model["sample_rate"]))


def build_engine(model: dict, cell: dict, seed: int, device: torch.device):
    """The port's engine on the Mimi configuration and its seeded weights."""
    from artalk_tpu_torch.engine import ARTAvatarInferEngine

    program.set_precision(cell)
    return ARTAvatarInferEngine(
        load_gaga=False, clip_length=int(model["clip_length"]),
        assets_dir=str(program.assets_dir(model)), output_dir=str(harness.BENCH / "_cache" / "out"),
        config=model_config(model),
        params=program._host(make_params(mimi_motion_spec(model), seed, device)),
        image_size=int(model["renderer"]["image_size"]), seed=int(seed) % 2**31, device=device)


class Taps:
    """What the Mimi encoder served, read on the instance: each call's
    transformer output and decoded codes; after set-up, only the sampled
    sessions' rows of the steps that carried their audio."""

    def __init__(self, encoder):
        self.encoder = encoder
        self.calls = []                     # (emb, codes) of each step, until ``follow``
        self.last = {}
        self.kept = {}                      # sid -> [(emb (T, d), codes (n_q, T'))]
        transform, decode = encoder.transform, encoder.decode_codes

        def tap_transform(x):
            self.last["emb"] = transform(x)
            return self.last["emb"]

        def tap_decode(codes):
            self.last["codes"] = codes
            if self.calls is not None:
                self.calls.append((self.last["emb"], codes))
            return decode(codes)

        encoder.transform, encoder.decode_codes = tap_transform, tap_decode

    def follow(self, state) -> None:
        """Keep the sampled rows of set-up's warm-up steps (which carry every
        session), then of each later step that carries a sampled session."""
        rec, pool = state["rec"], state["server"].pool
        warm = self.calls[-stream_http.WARM_TICKS:]
        if len(warm) != stream_http.WARM_TICKS:
            raise harness.BenchmarkError("the Mimi encoder was not called in the warm-up")
        self.calls = None
        self.kept = {sid: [(e[sid].clone(), c[sid].clone()) for e, c in warm]
                     for sid in rec.sampled}
        step = pool.step

        def tapped_step(chunks):
            out = step(chunks)
            for sid in rec.sampled & set(chunks):
                self.kept[sid].append((self.last["emb"][sid].clone(),
                                       self.last["codes"][sid].clone()))
            return out

        pool.step = tapped_step

    def release(self) -> None:
        for name in ("transform", "decode_codes"):
            self.encoder.__dict__.pop(name, None)
        self.last = {}


def setup(ctx, engine=None):
    if engine is None:
        engine = build_engine(ctx.model, ctx.cell, ctx.seed, ctx.device)
    taps = Taps(engine.model.audio_encoder)
    state = stream_http.setup(ctx, engine=engine)
    taps.follow(state)
    state["taps"] = taps
    return state


def release(state) -> None:
    state["taps"].release()
    stream_http.release(state)


# ----------------------------------------------------------------- the check


def _follow(ctx, state, prec: Precision) -> dict:
    """``stream_http._follow`` on the Mimi reference: FP32 teacher-forced on
    the served codes, a control (lower precision) on its own."""
    model, device = ctx.model, ctx.device
    ref = MimiMotionReference(model, make_params(mimi_motion_spec(model), ctx.seed, device), prec)
    rec, taps = state["rec"], state["taps"]
    out = {}
    for sid, steps in sorted(rec.steps.items()):
        if len(taps.kept[sid]) != len(steps):
            raise harness.BenchmarkError(f"session {sid}: {len(steps)} steps, "
                                         f"{len(taps.kept[sid])} Mimi encodes")
        audio = torch.from_numpy(np.stack([a for a, _, _ in steps])).to(device)
        served = [(b, c) for _, b, c in steps]
        codes = [c for _, c in taps.kept[sid]] if prec == FP32 else None
        out[sid] = {"followed": ref.follow(audio, served, rec.carry0[sid], codes),
                    "latent0": ref.initial_latent(rec.carry0[sid], device),
                    "served": served}
    state.setdefault("mimi_refs", {})[prec] = ref
    return out


def mimi_numbers(state, ref: dict, candidate: dict | None = None) -> dict:
    """``rvq_code_gap`` and ``mimi_emb_err`` of the program (``candidate``
    None: the codes and embeddings it served) or of a lower-precision
    reference in its place, against the float32 reference."""
    fp32 = state["mimi_refs"][FP32]
    gaps, errs = [0.0], [0.0]
    for sid in sorted(ref):
        windows = ref[sid]["followed"]["mimi"]
        if candidate is None:
            served = state["taps"].kept[sid]
        else:
            served = [(w["emb"][0], w["codes"][0]) for w in candidate[sid]["followed"]["mimi"]]
        for w, (emb, codes) in zip(windows, served):
            gaps.append(fp32.code_gap(w["down"], codes[None]))
            errs.append(judge.motion_err(emb.float().cpu().numpy(), w["emb"][0].cpu().numpy()))
    return {"rvq_code_gap": max(gaps), "mimi_emb_err": max(errs)}


def _fp32_reference(ctx, state) -> dict:
    if "ref" not in state:
        state["ref"] = _follow(ctx, state, FP32)
    return state["ref"]


def program_numbers(ctx, state) -> dict:
    ref = _fp32_reference(ctx, state)
    return {**stream_http.numbers_of(ctx, state, ref), **mimi_numbers(state, ref)}


def check(ctx, state) -> tuple:
    nums = program_numbers(ctx, state)
    ok, rows = judge.verdict(nums, ctx.cell["limits"])
    ok = ok and nums["chunks_checked"] > 0
    return ok, rows + [("chunks_checked", nums["chunks_checked"], None)]


def control(ctx, state, prec: Precision) -> dict:
    ref, cand = _fp32_reference(ctx, state), _follow(ctx, state, prec)
    return {**stream_http.numbers_of(ctx, state, ref, cand), **mimi_numbers(state, ref, cand)}


# ----------------------------------------------------------- layer readings


STAGES = ("mimi.resample", "mimi.seanet", "mimi.transformer", "mimi.rvq")


def mimi_tick_ms(data: dict) -> list:
    """Per tick after the traced stretch (``pool.tick``), the summed
    ``device_us`` of the Mimi stage spans inside it, in ms; a tick without
    all four stages timed on the device is left out (empty where the
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
    """``stream_http.layer_data``, with the Mimi step's FLOPs, the model's
    configuration and the Mimi stages' device time per tick
    (``mimi_ms``)."""
    base = copy.copy(ctx)
    base.model = dict(ctx.model, wav2vec=work_mimi.NO_WAV2VEC)
    data = stream_http.layer_data(base, state)
    data.update(model=ctx.model,
                step_flops=work_mimi.window_step_flops(ctx.model, ctx.model["window_samples"]))
    data["mimi_ms"] = mimi_tick_ms(data)
    return data

