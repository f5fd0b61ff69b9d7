"""CLI entry point, ``artalk_tpu/cli.py``'s flags.

    python -m artalk_tpu_torch.cli -a demo/eng1.wav [-l 750] [-s style_id]
                                   [--load_gaga -i synthetic_0] [--assets assets]
    python -m artalk_tpu_torch.cli --run_app [--load_gaga]   # the web UI

It runs on the CUDA device. The precision switches are environment variables,
as in the JAX CLI, read by the engine: ``ARTALK_AR_PRECISION=exact|fast|int8``,
``ARTALK_AR_FUSED=1`` and, for the GAGAvatar renderer,
``ARTALK_GAGA_PRECISION=fast|exact``.

``--run_app`` serves the gradio web UI (``app_gradio.py``) instead; without
gradio installed it raises ``RuntimeError``.
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


def resolve_shape_id(engine, shape_id: str, load_gaga: bool) -> str:
    """As the reference CLI (inference.py:225-227): a shape_id that is not in
    the avatar bank (or no GAGA renderer loaded at all) renders 'mesh'."""
    if shape_id == "mesh":
        return "mesh"
    bank = engine.gagavatar.all_gagavatar_id if load_gaga else {}
    if shape_id not in bank:
        print(f"[artalk_tpu_torch] shape_id {shape_id!r} not in the avatar bank"
              f"{'' if load_gaga else ' (--load_gaga not set)'}; rendering 'mesh' instead")
        return "mesh"
    return shape_id


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    if not args.run_app and not args.audio_path:
        raise SystemExit("--audio_path / -a required")
    engine = ARTAvatarInferEngine(
        load_gaga=args.load_gaga, fix_pose=args.fix_pose, clip_length=args.clip_length,
        assets_dir=args.assets, image_size=args.image_size)
    if args.run_app:
        from .app_gradio import run_gradio_app

        run_gradio_app(engine)
        return ""
    audio = load_audio_16k_mono(args.audio_path)
    base = os.path.splitext(os.path.basename(args.audio_path))[0]
    save_name = f"{base}_{args.style_id.replace('.', '_')}_{args.shape_id.replace('.', '_')}"
    shape_id = resolve_shape_id(engine, args.shape_id, args.load_gaga)
    if args.style_id != "default":
        engine.set_style_motion(args.style_id)
    print("Inferring motion...")
    motions = engine.inference(audio)
    print("Rendering...")
    out = engine.rendering(audio, motions, shape_id=shape_id, save_name=save_name)
    print(f"Saved {out}")
    return out


if __name__ == "__main__":
    main()
