"""Offline clips: one client in a closed loop, each clip from audio to the
yuv420 frames on the host, as ``cli -a <wav>`` renders it (without writing
the video: the frames stay in host memory).

Per clip: ``engine.inference`` (wav2vec2, the AR decode, the VAE, savgol),
then the configuration's renderer: FLAME and the mesh render, or, where the
configuration has a ``gagavatar`` group, ``GAGAvatar.render_motion_sequence``
on its avatar. The clips cycle through the traffic's list of lengths, the
same list on every seed. When the window's seconds are up no new clip
starts; the clip in flight finishes and counts.

``frames_per_s`` = the frames of every completed clip over the wall time
from the window's start to the end of the last clip.
"""

from __future__ import annotations

import math
import numpy as np
import torch

from benchmark import harness, judge, program, traffic, work
from benchmark.reference.gaga import GagaReference, Lowp, gaga_spec
from benchmark.reference.mesh import Flame, MeshRender
from benchmark.reference.motion import (FP32, MotionReference, Precision, precision_flags,
                                        smooth_motion)
from benchmark.reference.params import make_params, motion_spec


GAGA_FRAMES = 4   # frames of each checked clip that the GAGAvatar reference renders


class Capture:
    """The decisions the program served for one clip: each window's code
    bits and the carry bits after it, and the bootstrap carry."""

    def __init__(self):
        self.bits, self.carries = [], []

    def reset(self):
        self.bits, self.carries = [], []


def _attach_capture(engine, cap: Capture) -> None:
    model = engine.model
    dec, enc = model.decode_window, model.vae.encode_to_bits

    def decode_window(*a, **k):
        bits = dec(*a, **k)
        cap.bits.append(bits)
        return bits

    def encode_to_bits(*a, **k):
        out = enc(*a, **k)
        cap.carries.append(out[0])
        return out

    model.decode_window = decode_window
    model.vae.encode_to_bits = encode_to_bits


def setup(ctx):
    model, cell = ctx.model, ctx.cell
    gaga = "gagavatar" in model
    engine = program.build_engine(model, cell, ctx.seed, ctx.device)
    sp = ctx.spans
    sp.wrap(engine, "inference", "engine.inference")
    if gaga:
        sp.wrap(engine.gagavatar, "render_motion_sequence", "gagavatar.render_motion_sequence")
    else:
        sp.wrap(engine.flame, "motion_to_verts", "flame.motion_to_verts")
        sp.wrap(engine.mesh_renderer, "render_frames", "mesh_renderer.render_frames")
    cap = Capture()
    _attach_capture(engine, cap)
    clips = traffic.clip_audio(cell["traffic"], ctx.seed)
    state = {"engine": engine, "cap": cap, "clips": clips, "gaga": gaga}
    # warm-up: the shortest clip of two windows or more, through the whole
    # path: the window step, the carry's re-encode, whole and partial render
    # batches (no shape of the path compiles or tunes, so longer clips add
    # nothing)
    render_clip(ctx, state, warm_clip(ctx.model, clips))
    cap.reset()
    return state


def clip_windows(model: dict, samples: int) -> int:
    """The motion windows of a clip of ``samples`` audio samples."""
    frames = math.ceil(samples / (model["sample_rate"] / model["fps"]))
    return max(1, math.ceil(frames / model["vae"]["patch_nums"][-1]))


def warm_clip(model: dict, clips: list) -> np.ndarray:
    """The shortest clip of two windows or more (the longest, where none
    has two)."""
    two = [c for c in clips if clip_windows(model, len(c)) >= 2]
    return min(two, key=len) if two else max(clips, key=len)


@torch.no_grad()
def render_clip(ctx, state, audio: np.ndarray) -> tuple:
    """(motion, frames) of one clip, as the timed path produces them."""
    engine = state["engine"]
    motion = engine.inference(audio)
    if state["gaga"]:
        frames = engine.gagavatar.render_motion_sequence(
            ctx.model["gagavatar"]["avatar"], motion, engine.gagavatar_flame,
            colorspace="yuv420")
    else:
        m = torch.from_numpy(motion).to(engine.device)
        verts = engine.flame.motion_to_verts(m.new_zeros((m.shape[0], 300)), m)
        frames = engine.mesh_renderer.render_frames(verts)
    return motion, frames


def window(ctx, state) -> dict:
    clips, cap = state["clips"], state["cap"]
    n_set = len(clips)
    done, kept = [], {}
    # a traced run profiles one whole clip: the first of the window no
    # shorter than the set's median (the same clip on every seed)
    median = float(np.median([len(c) for c in clips]))
    traced_clip = next(i for i, c in enumerate(clips) if len(c) >= median)
    t_start = harness.clock()
    i = 0
    while harness.clock() - t_start < ctx.seconds:
        audio = clips[i % n_set]
        if i == traced_clip:
            ctx.tracer.start()
        t0 = harness.clock()
        cap.reset()
        motion, frames = render_clip(ctx, state, audio)
        t1 = harness.clock()
        windows = clip_windows(ctx.model, len(audio))
        done.append({"clip": i % n_set, "t0": t0, "t1": t1, "frames": int(frames.shape[0]),
                     "windows": windows, "traced": ctx.tracer.prof is not None})
        if i < n_set:
            kept[i] = {"motion": motion, "frames": frames, "bits": list(cap.bits),
                       "carries": list(cap.carries)}
        ctx.tracer.stop()
        i += 1
    ctx.tracer.stop()
    t_end = done[-1]["t1"]
    frames = sum(c["frames"] for c in done)
    state.update(done=done, kept=sample(ctx, kept, clips), t_start=t_start, t_end=t_end)
    return {"attempted": len(done), "failed": 0,
            "metrics": {"frames_per_s": frames / (t_end - t_start)}}


def sample(ctx, finished: dict, clips: list) -> dict:
    """The clips the check compares: the longest clip the window finished
    and two more drawn from the seed (of the first pass through the set)."""
    order = sorted(finished, key=lambda i: -len(clips[i]))
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed % 2**64, 11]))
    rest = order[1:]
    picks = order[:1] + [rest[j] for j in rng.choice(len(rest), size=min(2, len(rest)),
                                                      replace=False)]
    out = {i: finished[i] for i in picks}
    for k in out.values():   # the frames a GAGAvatar check renders again
        n = k["frames"].shape[0]
        k["picks"] = sorted(rng.choice(n, size=min(GAGA_FRAMES, n), replace=False).tolist())
    return out


def release(state) -> None:
    state.pop("engine", None)


# ----------------------------------------------------------------- the check


def reference_outputs(ctx, state, prec: Precision) -> dict:
    """The reference's numbers on every clip the check samples: its logits,
    carry latents and motion decoded from the program's served decisions,
    and its frames of the program's motion."""
    model, device = ctx.model, ctx.device
    params = make_params(motion_spec(model), ctx.seed, device)
    ref = MotionReference(model, params, prec)
    ws = model["window_samples"]
    out = {}
    assets = program.assets_dir(model)
    flame_data = dict(np.load(assets / "flame.npz"))
    fl = model["flame"]
    if state["gaga"]:
        g = model["gagavatar"]
        avatar = dict(np.load(assets / "avatars" / f"{g['avatar']}.npz"))
        gaga = GagaReference(make_params(gaga_spec(), ctx.seed, device, tag=2), avatar,
                             Flame(flame_data, fl["n_shape"], fl["n_exp"], device,
                                   scale=g["world_scale"]), device)
    else:
        flame = Flame(flame_data, fl["n_shape"], fl["n_exp"], device)
        render = MeshRender(flame_data["faces"], flame_data["v_template"],
                            model["renderer"]["image_size"], device)
    for i, k in sorted(state["kept"].items()):
        audio = state["clips"][i]
        n = len(k["bits"])
        padded = np.zeros(n * ws, np.float32)
        padded[:len(audio)] = audio[:n * ws]
        audio_t = torch.from_numpy(padded.reshape(n, ws)).to(device)
        served = [(b[0], c[0]) for b, c in zip(k["bits"], k["carries"][1:])]
        followed = ref.follow(audio_t, served, k["carries"][0][0])
        latent0 = ref.initial_latent(k["carries"][0][0], device)
        seq = math.ceil(len(audio) / model["sample_rate"] * model["fps"])
        pm = torch.from_numpy(k["motion"]).to(device)
        with precision_flags(prec):
            motion = smooth_motion(followed["motion"][:seq])[:model["clip_length"]].cpu().numpy()
            if state["gaga"]:
                Lowp.on = prec.fp8
                try:
                    frames = gaga.frames(pm, k["picks"]).cpu().numpy()
                finally:
                    Lowp.on = False
            else:
                frames = np.concatenate([
                    render.frames(flame.verts(pm[s:s + 25])).cpu().numpy()
                    for s in range(0, pm.shape[0], 25)])
        out[i] = {"followed": followed, "served": served, "latent0": latent0,
                  "carry0": k["carries"][0][0], "motion": motion, "frames": frames}
    return out


def numbers_of(ctx, state, ref: dict, candidate: dict | None = None) -> dict:
    """The compared numbers of the program (``candidate`` None) or of a
    lower-precision reference put in its place, against the reference."""
    keys = sorted(ref)
    if candidate is None:
        served = [ref[i]["served"] for i in keys]
        carry0 = [ref[i]["carry0"] for i in keys]
        motions = [state["kept"][i]["motion"] for i in keys]
        frames = [state["kept"][i]["frames"] for i in keys]
    else:
        served = [judge.control_decisions(candidate[i]["followed"]) for i in keys]
        carry0 = [(candidate[i]["latent0"] > 0).to(torch.int32) for i in keys]
        motions = [candidate[i]["motion"] for i in keys]
        frames = [candidate[i]["frames"] for i in keys]
    nums = judge.stream_numbers([ref[i]["followed"] for i in keys], served, carry0,
                                [ref[i]["latent0"] for i in keys], motions,
                                [ref[i]["motion"] for i in keys])
    if candidate is None and state["gaga"]:
        frames = [f[state["kept"][i]["picks"]] for f, i in zip(frames, keys)]
    nums["frame_mad"] = max(judge.frame_mad(p, ref[i]["frames"]) for p, i in zip(frames, keys))
    return nums


def _fp32_reference(ctx, state) -> dict:
    if "ref" not in state:
        state["ref"] = reference_outputs(ctx, state, FP32)
    return state["ref"]


def program_numbers(ctx, state) -> dict:
    return numbers_of(ctx, state, _fp32_reference(ctx, state))


def check(ctx, state) -> tuple:
    if not state["kept"]:
        return False, [("clips_checked", 0, 1)]
    ok, rows = judge.verdict(program_numbers(ctx, state), ctx.cell["limits"])
    return ok, rows + [("clips_checked", len(state["kept"]), None)]


def control(ctx, state, prec: Precision) -> dict:
    """The control's numbers: the reference at ``prec`` in the program's
    place, judged against the float32 reference on the same clips."""
    return numbers_of(ctx, state, _fp32_reference(ctx, state),
                      reference_outputs(ctx, state, prec))


# ----------------------------------------------------------- layer readings


def layer_data(ctx, state) -> dict:
    """What the per-layer readers take from this run, beside the spans and
    the trace: the clips after the traced stretch (or all of them), their
    frames and windows, and the FLOPs of their work from shapes."""
    done = state["done"]
    after = [c for c in done if not c["traced"]] or done
    model = ctx.model
    flops = 0.0
    for c in after:
        flops += work.clip_motion_flops(model, c["windows"], c["frames"])
        flops += c["frames"] * (work.gaga_frame_flops(model) if state["gaga"]
                                else work.mesh_frame_flops(model))
    return {"clips": after, "since": after[0]["t0"], "until": after[-1]["t1"],
            "frames": sum(c["frames"] for c in after),
            "windows": sum(c["windows"] for c in after), "flops": flops,
            "peak": work.PEAKS[ctx.cell["peak"]]}
