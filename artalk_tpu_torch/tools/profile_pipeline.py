"""Per-stage device timing of the speech -> motion -> render pipeline.

Counterpart of the repository's ``tools/profile_pipeline.py``: times each
stage of the main path alone, in the JAX tool's order, and prints one line
each (``utils/timing.timed``: CUDA events around ``--iters`` chained calls
after a warm-up; every stage's output summed to a scalar on the device):

- ``audio_condition`` (the wav2vec2 encoder and the area resizes) for one
  window, and batched over 8;
- ``decode_window`` (the AR decode) with the condition precomputed;
- the VAE's ``decode_from_bits`` (the 200-frame pair) and ``encode_to_bits``;
- the whole ``window_step``;
- Savitzky-Golay smoothing of 8 windows;
- FLAME ``motion_to_verts`` of one window's frames;
- the mesh render of 25 frames at 512x512 (the rasterizer kernel).

    python -m artalk_tpu_torch.tools.profile_pipeline [--iters 10]
        [--precision exact|fast|fused|fusedx|int8]

``--precision`` maps onto the config's fields as in the JAX tool: fast =
bf16 audio encoder and AR blocks; fused = fast with the block-stack kernels
(bf16 packs); fusedx = the kernels with float32 packs (the batched encode
over 8 windows then runs plain torch: float32 packs take the encoder kernel
at batch 1 only); int8 = fused with int8 packs. The weights are random from
seed 0; FLAME comes from the repository's ``assets/``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..bench import ASSETS
from ..config import ModelConfig
from ..engine import resolve_device
from ..models.flame import FlameModel
from ..models.renderer import MeshRenderer
from ..ops.savgol import smooth_motion_savgol
from ..utils.assets import load_or_synthesize_flame
from ..utils.params import load_model
from ..utils.timing import timed
from . import device_line

PRECISIONS = {
    "exact": {},
    "fast": {"bf16_audio": True, "bf16_ar": True},
    "fused": {"bf16_audio": True, "bf16_ar": True, "fused_ar": True},
    "fusedx": {"fused_ar": True},
    "int8": {"bf16_audio": True, "bf16_ar": True, "fused_ar": True, "int8_ar": True},
}
N_WINDOWS = 8
IMAGE_SIZE = 512
RENDER_FRAMES = 25


@torch.no_grad()
def main(argv: Optional[list] = None, device: Union[str, torch.device] = "cuda",
         config: Optional[ModelConfig] = None) -> None:
    """Profile the stages on ``device`` with ``config`` (default the
    production ``ModelConfig()``), its precision fields set by
    ``--precision``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--precision", choices=tuple(PRECISIONS), default="exact")
    args = ap.parse_args(argv)
    it = args.iters
    dev = resolve_device(device)
    print(f"{device_line(dev)}   iters: {it}\n", flush=True)

    cfg = dataclasses.replace(config or ModelConfig(), **PRECISIONS[args.precision])
    model = load_model(cfg, device=dev)
    rng = np.random.default_rng(0)
    ws = model.window_samples
    chunks = torch.from_numpy(rng.standard_normal(
        (N_WINDOWS, 1, ws)).astype(np.float32) * 0.1).to(dev)
    chunk1 = chunks[0]
    style_cond = model.encode_style(None)
    state = model.initial_state(style_cond)
    window = cfg.vae.window

    def stage(name, fn, *args, label_width=44):
        return timed(name, fn, *args, iters=it, label_width=label_width, device=dev)

    print("--- speech -> motion (per 4 s window unless noted) ---")
    stage("audio_condition (wav2vec, 1 window)",
          lambda c: model.audio_condition(c).sum(), chunk1)
    enc_n = stage(f"audio_condition (batched {N_WINDOWS} windows)",
                  lambda c: model.audio_condition(c.reshape(-1, ws)).sum(), chunks)
    print(f"{'  -> batched encode per window':<44s} {enc_n / N_WINDOWS:9.2f} ms")

    audio_cond = model.audio_condition(chunk1)
    stage("decode_window (AR only, cond precomputed)",
          lambda ac: model.decode_window(ac, style_cond, state.prev_attn_feat).sum(),
          audio_cond)
    bits = model.decode_window(audio_cond, style_cond, state.prev_attn_feat)
    stage("VAE decode_from_bits (200-frame pair)",
          lambda b: model.vae.decode_from_bits(state.prev_bits, b)[1].sum(), bits)
    motion = model.vae.decode_from_bits(state.prev_bits, bits)[1]
    stage("VAE re-encode (encode_to_bits)",
          lambda m: model.vae.encode_to_bits(m)[0].sum(), motion)
    stage("full window_step (stream step)",
          lambda s, c: model.window_step(s, c, style_cond)[1].sum(), state, chunk1)
    stage(f"savgol postprocess ({N_WINDOWS * window} frames)",
          lambda m: smooth_motion_savgol(m).sum(), motion[:, :window].repeat(1, N_WINDOWS, 1))

    print("\n--- motion -> pixels (per frame unless noted) ---")
    flame_data = load_or_synthesize_flame(str(ASSETS))
    flame = FlameModel(flame_data, n_shape=300, n_exp=100, scale=1.0).to(dev)
    motions_t = torch.from_numpy(rng.normal(0, 0.3, (window, 106)).astype(np.float32)).to(dev)
    shape = torch.zeros((window, 300), device=dev)
    fl = stage(f"FLAME motion_to_verts ({window} frames)",
               lambda s, m: flame.motion_to_verts(s, m, with_global=True).sum(),
               shape, motions_t)
    print(f"{'  -> per frame':<44s} {fl / window:9.3f} ms")
    renderer = MeshRenderer(image_size=IMAGE_SIZE, faces=flame_data["faces"], scale=1.0,
                            template_verts=flame_data["v_template"], device=dev)
    verts = flame.motion_to_verts(shape, motions_t, with_global=True)[:RENDER_FRAMES]
    mr = stage(f"mesh render ({RENDER_FRAMES} frames, {IMAGE_SIZE}^2 Phong)",
               lambda v: renderer(v).sum(), verts)
    print(f"{'  -> per frame':<44s} {mr / RENDER_FRAMES:9.3f} ms")


if __name__ == "__main__":
    main()
