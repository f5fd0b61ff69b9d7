#!/usr/bin/env python3
"""GPU smoke run of artalk_tpu_torch: builds the CUDA rasterizer, checks it
against its plain version, replays the seed-0 goldens, and drives the
speech -> mesh-video path once at the production width.

    python3 chip_smoke.py        # from the repository root, on a machine with one NVIDIA GPU

Phases (any failure raises and exits non-zero; no phase catches its own):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the rasterizer from artalk_tpu_torch/csrc/ and print the seconds;
  3. kernel vs plain version on the synthetic FLAME head at 512x512, 4 frames:
     face ids agree on >= 99.9 % of pixels, background exactly, zbuf to
     rtol 1e-4 where both hit; ms per frame of both;
  4. golden replay: the small config's seed-0 params
     (tests/fixtures/torch_golden_small_params.npz) on the card, 3 windows,
     against tests/fixtures/golden_small.npz: at most 1 of the 168 code bits
     may differ (the card sums in another order than XLA on the CPU);
  5. full width: ARTAvatarInferEngine(device="cuda") with the production
     ModelConfig and random seed-0 weights on 10 s of seeded noise:
     inference -> (250, 106) finite; stream over 4 s chunks equals the raw
     offline decode to atol 1e-4; rendering(shape_id="mesh") at 512x512 gives
     250 frames; the rasterizer kernel launched at least 250 times on the way.

It imports nothing of JAX. The line before the last is a JSON object with the
kernels' numbers; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.models.flame import FlameModel
from artalk_tpu_torch.models.renderer import MeshRenderer
from artalk_tpu_torch.ops import rasterizer
from artalk_tpu_torch.utils.assets import load_or_synthesize_flame
from artalk_tpu_torch.utils.params import load_params_npz, params_from_flat

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
IMAGE = 512

# tests/test_ar_model.py's CFG, the config behind tests/fixtures/golden_small.npz
GOLDEN_SMALL_CFG = tcfg.ModelConfig(
    ar=tcfg.ARConfig(depth=3, num_heads=4, prev_ratio=1, embed_dim=64, style_dim=16,
                     audio_dim=32),
    vae=tcfg.VAEConfig(motion_dim=12, code_dim=8, depth=2, num_heads=4, hidden_dim=32,
                       patch_nums=(1, 2, 4)),
    wav2vec=tcfg.Wav2VecConfig(
        conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3),
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4),
)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the card, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    seconds = rasterizer.build()
    print(f"[build] rasterizer from {os.path.relpath(rasterizer.SOURCE, ROOT)}: {seconds:.2f} s")


def phase_kernel(flame_data: dict, dev: torch.device) -> dict:
    """The kernel and the plain version on the same 4 frames of the head."""
    flame = FlameModel(flame_data).to(dev)
    renderer = MeshRenderer(IMAGE, flame_data["faces"], template_verts=flame_data["v_template"],
                            device=dev)
    rng = np.random.default_rng(7)
    motion = (rng.standard_normal((4, 106)) * 0.5).astype(np.float32)
    motion[:, 100:] *= 0.2   # head and jaw rotations of a few degrees
    verts = flame.motion_to_verts(torch.zeros(4, 300, device=dev),
                                  torch.from_numpy(motion).to(dev))
    screens = [renderer.camera_transform(v).contiguous() for v in verts]
    faces = renderer.faces
    agree, max_err, covered = [], 0.0, []
    for vs in screens:
        zk, fk = rasterizer.rasterize(vs, faces, height=IMAGE, width=IMAGE)
        zp, fp = rasterizer.rasterize_plain(vs, faces, height=IMAGE, width=IMAGE)
        torch.cuda.synchronize()
        if not torch.equal(fk == -1, fp == -1):
            raise AssertionError("kernel and plain version disagree on background pixels")
        both = (fk >= 0) & (fp >= 0)
        rel = ((zk[both] - zp[both]).abs() / zp[both].abs()).max().item()
        if rel > 1e-4:
            raise AssertionError(f"zbuf differs by rtol {rel:.3g} > 1e-4")
        max_err = max(max_err, (zk[both] - zp[both]).abs().max().item())
        agree.append((fk == fp).float().mean().item())
        covered.append(both.float().mean().item())
    if min(agree) < 0.999:
        raise AssertionError(f"face ids agree on only {min(agree):.5f} of pixels")
    identical = all(a == 1.0 for a in agree)
    ms = cuda_ms(lambda: [rasterizer.rasterize(vs, faces, height=IMAGE, width=IMAGE)
                          for vs in screens], 10) / len(screens)
    plain_ms = cuda_ms(lambda: [rasterizer.rasterize_plain(vs, faces, height=IMAGE, width=IMAGE)
                                for vs in screens], 2) / len(screens)
    planes, bbox, num_chunks = rasterizer._kernel_inputs(screens[0], faces)
    zbuf = torch.empty((IMAGE, IMAGE), device=dev)
    fid = torch.empty((IMAGE, IMAGE), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    kernel_only_ms = cuda_ms(lambda: rasterizer._LIB.artalk_rasterize(
        planes.data_ptr(), bbox.data_ptr(), num_chunks, IMAGE, IMAGE,
        zbuf.data_ptr(), fid.data_ptr(), stream), 50)
    print(f"[kernel] {len(faces)} faces, {num_chunks} chunks, {IMAGE}x{IMAGE}: face ids agree "
          f"on {min(agree):.6f} (bit-identical: {identical}), covered {np.mean(covered):.3f}, "
          f"zbuf max abs err {max_err:.3g}")
    print(f"[kernel] ms/frame: rasterize (setup + kernel) {ms:.4f}, kernel alone "
          f"{kernel_only_ms:.4f}, rasterize_plain {plain_ms:.4f}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def phase_golden(dev: torch.device) -> None:
    """Replay tests/test_golden_regression.py's 3 windows on ``dev``."""
    model = params_from_flat(
        load_params_npz(os.path.join(FIXTURES, "torch_golden_small_params.npz")),
        GOLDEN_SMALL_CFG).to(dev)
    with np.load(os.path.join(FIXTURES, "golden_small.npz")) as z:
        want_bits, want_motions = z["bits"], z["motions"]
    rng = np.random.default_rng(1234)
    chunks = (rng.standard_normal((3, 1, model.window_samples)) * 0.1).astype(np.float32)
    style = model.encode_style(None)
    state = model.initial_state(style)
    flipped, motion_err = 0, 0.0
    for i in range(chunks.shape[0]):
        chunk = torch.from_numpy(chunks[i]).to(dev)
        bits = model.decode_window(model.audio_condition(chunk), style, state.prev_attn_feat)
        state, motion = model.window_step(state, chunk, style)
        flipped += int((bits.cpu().numpy().astype(np.int8) != want_bits[i]).sum())
        motion_err = max(motion_err, float(np.abs(motion.cpu().numpy() - want_motions[i]).max()))
    print(f"[golden] {flipped} of {want_bits.size} code bits differ from golden_small.npz; "
          f"motion max abs err {motion_err:.3g}")
    if flipped > 1:
        raise AssertionError(f"{flipped} golden code bits flipped (> 1)")
    if flipped == 0 and motion_err > 1e-4:
        raise AssertionError(f"golden motions off by {motion_err:.3g} with equal bits")


def phase_full(dev: torch.device, image: int = IMAGE) -> int:
    """The production-width path through the engine's entry points. Returns
    the rasterizer launches counted during it."""
    out_dir = os.path.join(ROOT, "render_results", "chip_smoke")
    engine = ARTAvatarInferEngine(device=dev, config=tcfg.ModelConfig(),
                                  assets_dir=os.path.join(ROOT, "assets"),
                                  output_dir=out_dir, image_size=image, seed=0)
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    audio = (np.random.default_rng(10).standard_normal(10 * cfg.sample_rate) * 0.1
             ).astype(np.float32)
    ws = engine.model.window_samples
    n_windows = math.ceil(len(audio) / ws)
    engine.inference(audio[:ws])  # warm-up: cuBLAS/cuDNN handles and autotuning

    rasterizer.LAUNCHES = 0
    t0 = time.perf_counter()
    motions = engine.inference(audio)
    t_inf = time.perf_counter() - t0
    streamed = np.concatenate(list(engine.stream(
        audio[i : i + ws] for i in range(0, len(audio), ws))), axis=0)
    t0 = time.perf_counter()
    out_path = engine.rendering(audio, motions, shape_id="mesh", save_name="chip_smoke")
    t_render = time.perf_counter() - t0
    launches = rasterizer.LAUNCHES

    if motions.shape != (250, 106) or not np.isfinite(motions).all():
        raise AssertionError(f"inference gave {motions.shape}, finite={np.isfinite(motions).all()}")
    padded = np.zeros(n_windows * ws, np.float32)
    padded[: len(audio)] = audio
    offline = engine.model.generate(
        torch.from_numpy(padded.reshape(n_windows, 1, ws)).to(dev),
        engine.model.encode_style(None))[0, :250].cpu().numpy()
    stream_err = float(np.abs(streamed - offline).max())
    if streamed.shape != offline.shape or stream_err > 1e-4:
        raise AssertionError(f"stream vs offline: {streamed.shape} vs {offline.shape}, "
                             f"max abs err {stream_err:.3g}")
    if out_path.endswith(".npz"):
        with np.load(out_path) as z:
            n_frames = z["frames"].shape[0]
    else:
        n_frames = None  # an encoded video; its frame count needs a decoder
        if os.path.getsize(out_path) == 0:
            raise AssertionError(f"{out_path} is empty")
    if n_frames not in (None, 250):
        raise AssertionError(f"rendered {n_frames} frames, want 250")
    if launches < 250:
        raise AssertionError(f"rasterizer kernel launched {launches} times, want >= 250")

    verts = engine.flame.motion_to_verts(torch.zeros(250, 300, device=dev),
                                         torch.from_numpy(motions).to(dev))
    t0 = time.perf_counter()
    engine.mesh_renderer.render_frames(verts)  # returns on the host
    t_frames = time.perf_counter() - t0
    print(f"[full] production config, {n_params / 1e6:.1f} M params (random, seed 0), "
          f"{len(audio) / cfg.sample_rate:.0f} s audio, {n_windows} windows")
    print(f"[full] inference {t_inf * 1e3 / n_windows:.1f} ms/window; stream vs offline "
          f"max abs err {stream_err:.3g}; rendering (flame + frames + video write) "
          f"{t_render * 1e3 / 250:.2f} ms/frame; render_frames alone "
          f"{t_frames * 1e3 / 250:.2f} ms/frame; {launches} kernel launches")
    print(f"[full] wrote {out_path} ({n_frames if n_frames is not None else 'encoded'} frames)")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    phase_device()
    phase_build()
    flame_data = load_or_synthesize_flame(os.path.join(ROOT, "assets"))
    dev = torch.device("cuda")
    kernel = phase_kernel(flame_data, dev)
    phase_golden(dev)
    launches = phase_full(dev)
    print(json.dumps({"kernels": [{
        "name": "rasterize", "route": "cuda",
        "source": "artalk_tpu_torch/csrc/rasterizer.cu",
        "replaces": "artalk_tpu/ops/rasterizer.py:196",
        "launches": launches, **kernel}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
