"""CLI entry point, the mesh path of ``artalk_tpu/cli.py``'s flags.

    python -m artalk_tpu_torch.cli -a demo/eng1.wav [-l 750] [-s style_id]
                                   [--assets assets]

It runs on the CUDA device.

``--load_gaga`` and ``--run_app`` are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import os

from .engine import ARTAvatarInferEngine
from .utils.audio import load_audio_16k_mono


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ARTalk on PyTorch/CUDA: speech-driven 3D head animation")
    parser.add_argument("--audio_path", "-a", default=None, type=str)
    parser.add_argument("--clip_length", "-l", default=750, type=int)
    parser.add_argument("--shape_id", "-i", default="mesh", type=str)
    parser.add_argument("--style_id", "-s", default="default", type=str)
    parser.add_argument("--assets", default="assets", type=str)
    parser.add_argument("--image_size", default=512, type=int)
    parser.add_argument("--load_gaga", action="store_true")
    parser.add_argument("--fix_pose", action="store_true")
    parser.add_argument("--run_app", action="store_true")
    return parser


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    if args.load_gaga:
        raise NotImplementedError(
            "--load_gaga: the GAGAvatar renderer is not ported yet (ROADMAP.md Queue 1 item 10)")
    if args.run_app:
        raise NotImplementedError(
            "--run_app: the web UI is not ported yet (ROADMAP.md Queue 1 item 13)")
    if not args.audio_path:
        raise SystemExit("--audio_path / -a required")
    engine = ARTAvatarInferEngine(
        fix_pose=args.fix_pose, clip_length=args.clip_length, assets_dir=args.assets,
        image_size=args.image_size)
    audio = load_audio_16k_mono(args.audio_path)
    base = os.path.splitext(os.path.basename(args.audio_path))[0]
    save_name = f"{base}_{args.style_id.replace('.', '_')}_{args.shape_id.replace('.', '_')}"
    if args.shape_id != "mesh":
        # as the reference CLI: an id outside the (absent) avatar bank renders the mesh
        print(f"[artalk_tpu_torch] shape_id {args.shape_id!r} not in the avatar bank "
              "(--load_gaga not set); rendering 'mesh' instead")
    if args.style_id != "default":
        engine.set_style_motion(args.style_id)
    print("Inferring motion...")
    motions = engine.inference(audio)
    print("Rendering...")
    out = engine.rendering(audio, motions, shape_id="mesh", save_name=save_name)
    print(f"Saved {out}")
    return out


if __name__ == "__main__":
    main()
