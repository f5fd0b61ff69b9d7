"""Decompose the GAGAvatar frame (the bench's ``gaga_ms_per_frame``).

Counterpart of the repository's ``tools/profile_gaga.py``. Times a k-frame
chunk of the first avatar (``synthetic_0`` without a checkpoint): FLAME, the
forehead EMA and the cameras (``prep_frame_chunk``), then per frame one of
four bodies, each built here from the avatar's parts as the JAX tool builds
its own:

  full        the splat, the StyleUNet (float32), the clip and yuv420
  no-SR       the splat only (its first three channels as uint8)
  SR-only     the StyleUNet over a constant 32-channel render, clip, yuv420
  full-bf16   the full body with the StyleUNet computing in bf16

    python -m artalk_tpu_torch.tools.profile_gaga [--k 8]

Each chunk ends in a sum on the device of every 64th pixel of its frames;
``utils/timing.pipelined_ms`` times ``ITERS`` chunks after a warm-up (CUDA
events). The splat takes float32 colors in every body, as in the JAX tool;
no watermark. The JAX tool prints its static instance budget; the port
counts instances per frame, so this prints the instances per gaussian of
the chunk's first frame in its place.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..bench import ASSETS, with_env
from ..engine import resolve_device
from ..models.flame import FlameModel
from ..models.gagavatar import avatar as A
from ..ops.colorspace import rgb_to_yuv420p
from ..ops.gsplat import prepass, rasterize_gaussians
from ..utils.assets import load_or_synthesize_flame
from ..utils.timing import pipelined_ms
from . import device_line

ITERS = 6


@torch.no_grad()
def main(argv: Optional[list] = None, device: Union[str, torch.device] = "cuda",
         config: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, float]:
    """Profile the chunk on ``device``; ``config`` is a flat ``//``-keyed
    GAGAvatar parameter dict (``GAGAvatar(params=...)``), default the assets'
    checkpoint or random weights from seed 0. Returns ms per chunk by
    variant."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--k", type=int, default=8)
    args = p.parse_args(argv)
    k = args.k
    dev = resolve_device(device)
    print(f"{device_line(dev)}  k={k}", flush=True)

    flame = FlameModel(load_or_synthesize_flame(str(ASSETS)), n_shape=300, n_exp=100,
                       scale=5.0).to(dev)
    # built in fast mode: nets.upsampler is the float32 StyleUNet and
    # _upsampler its bf16 copy
    gaga = with_env({"ARTALK_GAGA_PRECISION": "fast"}, lambda: A.GAGAvatar(
        assets_dir=str(ASSETS), params=config, device=dev))
    gaga.set_avatar_id(sorted(gaga.all_gagavatar_id)[0])
    gaga._build_gs_params()
    gs = gaga._gs_params
    cam_params = A.CAM_PARAMS

    rng = np.random.default_rng(5)
    motions = torch.from_numpy(rng.normal(0, 0.3, (k, 106)).astype(np.float32)).to(dev)
    carry = torch.zeros((len(A.FOREHEAD_INDICES), 3), device=dev)
    shapecode = gaga._feature_cache["shapecode"]
    base = gaga._feature_cache["transform"]

    def frame_args(tp, cam):
        xyz = torch.cat([tp, gs["xyz"][0, A.NUM_FLAME_VERTS:]])
        return (xyz, gs["colors"][0], gs["opacities"][0], gs["scales"][0],
                gs["rotations"][0], cam)

    def splat(tp, cam):
        return rasterize_gaussians(*frame_args(tp, cam), focal=cam_params["focal"],
                                   size=cam_params["size"])

    def full_body(upsampler, dtype):
        def body(tp, cam):
            sr = upsampler(splat(tp, cam)[None], compute_dtype=dtype)
            return rgb_to_yuv420p(torch.clamp(sr, 0, 1), channel_axis=1)[0]
        return body

    def nosr_body(tp, cam):
        return (splat(tp, cam)[:3] * 255).to(torch.uint8)

    size = cam_params["size"]
    const_render = torch.from_numpy(
        rng.random((32, size, size)).astype(np.float32)).to(dev)

    def sronly_body(tp, cam):
        sr = gaga.nets.upsampler(const_render[None] + tp[0, 0] * 1e-12, compute_dtype=None)
        return rgb_to_yuv420p(torch.clamp(sr, 0, 1), channel_axis=1)[0]

    def chunk(frame_body):
        t_points, cams, _ = A.prep_frame_chunk(flame, shapecode, base, motions, carry,
                                               False, k)
        frames = torch.stack([frame_body(tp, cam) for tp, cam in zip(t_points, cams)])
        return frames[:, ::64, ::64].to(torch.int32).sum()

    t_points, cams, _ = A.prep_frame_chunk(flame, shapecode, base, motions, carry, False, k)
    n = t_points.shape[1] + gs["xyz"].shape[1] - A.NUM_FLAME_VERTS
    inst = prepass(*frame_args(t_points[0], cams[0]), focal=cam_params["focal"],
                   size=size)[2]
    print(f"instances/gaussian={inst.numel() / n:.2f} (frame 0 of the chunk)", flush=True)

    out = {}
    for name, body in [
        ("full      ", full_body(gaga.nets.upsampler, None)),
        ("no-SR     ", nosr_body),
        ("SR-only   ", sronly_body),
        ("full-bf16 ", full_body(gaga._upsampler, torch.bfloat16)),
    ]:
        ms = pipelined_ms(lambda i, prev: chunk(body), ITERS, repeats=1, device=dev)[0]
        out[name.strip()] = ms
        print(f"{name} {ms:8.2f} ms/chunk  ({ms / k:6.2f} ms/frame)", flush=True)
    return out


if __name__ == "__main__":
    main()
