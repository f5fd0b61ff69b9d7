"""Training entry point for both stages (counterpart of
``artalk_tpu/training/train.py``).

    # stage 1: motion tokenizer
    python -m artalk_tpu_torch.training.train --stage vae --data clips/ --steps 10000

    # stage 2: audio-conditioned AR generator (frozen VAE inside the loss)
    python -m artalk_tpu_torch.training.train --stage ar --data clips/ --steps 10000 \\
        --init assets/artalk_params.npz

    # several cards: one process per card, tensor parallel over pairs of them
    torchrun --nproc_per_node 4 -m artalk_tpu_torch.training.train --stage ar \\
        --multihost --tp 2 --synthetic --steps 100

`--data` is a directory of .npz clips ({'audio': (S,), 'motion': (T, 106)});
`--synthetic` trains on generated clips (smoke test). The weights are saved
as a flat `//`-keyed .npz (uncompressed: random and trained float32 weights
barely compress, and deflating the production model's 2 GB takes minutes)
that the JAX package's `load_params` and the port's engine
(`ARTAvatarInferEngine(params=...)`) both load. `--eval` (AR stage) closes
the loop after training: clip 0 is decoded free-running with the trained
weights and scored with `evaluation.py` (LVE/FDD/beat-align at the 106-d
FLAME layout; motion-space L2 otherwise). `--device` picks the device
(default cuda).

`--multihost` joins a multi-process job (`parallel.distributed.
initialize_multihost`, from torchrun's environment; NCCL on the cards, gloo
with `--device cpu`). With a process group, or `--tp` > 1 (which needs one),
the ranks form a (dp, tp) mesh: the weights are placed by the tensor-parallel
rules (`parallel.shard_params`), every rank builds the same dataset and
batches from `--seed` and steps on its dp rows of each `--batch_size` batch,
and rank 0 writes the gathered weights and runs `--eval` on them.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig
from ..engine import resolve_device
from ..models.ar_model import BitwiseARModel
from ..models.bitwise_vae import BitwiseVAE
from ..parallel.mesh import make_mesh
from ..parallel.sharding import shard_params
from ..utils.params import (flat_from_module, load_flat_into, load_params_npz,
                            params_from_flat, save_params_npz)
from .data import MotionAudioDataset, prefetch_to_device, synthetic_clips
from .trainer import init_state, make_ar_train_step, make_optimizer, make_vae_train_step


def synthetic_dataset(cfg: ModelConfig) -> MotionAudioDataset:
    """``--synthetic``'s data: 8 generated 500-frame clips at ``cfg``'s
    motion width, window, frame rate and sample rate (the JAX CLI's
    defaults at the production config)."""
    clips = synthetic_clips(num_clips=8, frames=500, motion_dim=cfg.vae.motion_dim,
                            fps=cfg.fps, sample_rate=cfg.sample_rate)
    return MotionAudioDataset(clips, window=cfg.vae.window, fps=cfg.fps,
                              sample_rate=cfg.sample_rate)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stage", choices=["vae", "ar"], required=True)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--init", type=str, default=None, help="warm-start params (.npz)")
    p.add_argument("--out", type=str, default="checkpoints/trained.npz")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-process job (torch.distributed; topology from "
                        "torchrun's environment) before building the job-wide mesh")
    p.add_argument("--eval", action="store_true",
                   help="after AR training: free-running decode of clip 0 "
                        "scored with evaluation.py metrics (LVE/FDD/BA)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.multihost:
        from ..parallel.distributed import initialize_multihost

        info = initialize_multihost(backend="gloo" if device.type == "cpu" else None)
        print(f"[train] multihost: process {info['process_id']}/{info['num_processes']}, "
              f"{info['local_devices']} local / {info['global_devices']} global devices")
    mesh = None
    if args.tp != 1 or dist.is_initialized():
        mesh = make_mesh(tp=args.tp, device_type=device.type)

    cfg = ModelConfig()
    if args.synthetic or args.data is None:
        print("[train] using synthetic clips")
        ds = synthetic_dataset(cfg)
    else:
        ds = MotionAudioDataset.from_directory(args.data, window=cfg.vae.window, fps=cfg.fps,
                                               sample_rate=cfg.sample_rate)

    gen = torch.Generator().manual_seed(args.seed)
    model = (BitwiseARModel(cfg) if args.stage == "ar" else BitwiseVAE(cfg.vae)).init(gen)
    if args.init:
        load_flat_into(model, load_params_npz(args.init))
    model = model.to(device)
    if mesh is not None:
        shard_params(model, mesh)
    optimizer = make_optimizer(lr=args.lr, total_steps=args.steps)
    state = init_state(model, optimizer)
    if args.stage == "ar":
        step = make_ar_train_step(model, optimizer, mesh=mesh)
    else:
        step = make_vae_train_step(model, optimizer, mesh=mesh)

    batches = prefetch_to_device(
        ds.batches(args.batch_size, seed=args.seed, num_batches=args.steps), device=device,
        mesh=mesh)
    t0 = time.time()
    for i, batch in enumerate(batches):
        if args.stage == "ar":
            state, metrics = step(state, batch["audio"], batch["prev_motion"],
                                  batch["this_motion"], batch["style_motion"])
        else:
            state, metrics = step(state, batch["prev_motion"], batch["this_motion"])
        if (i + 1) % args.log_every == 0 or i == 0:
            m = {k: round(float(v), 4) for k, v in metrics.items()}
            rate = (i + 1) / (time.time() - t0)
            print(f"[train] step {i + 1}/{args.steps} {m} ({rate:.2f} steps/s)", flush=True)

    model.requires_grad_(False)
    flat = flat_from_module(model)  # a sharded model's weights gathered on every rank
    lead = not dist.is_initialized() or dist.get_rank() == 0
    if lead:
        save_params_npz(flat, args.out)
        print(f"[train] saved {args.out}")
    if args.multihost:
        dist.destroy_process_group()

    if args.eval and args.stage == "ar" and lead:
        if mesh is not None:
            model = params_from_flat(flat, cfg).to(device)
        return _eval_decode(model, ds, cfg)
    return None


@torch.no_grad()
def _eval_decode(model: BitwiseARModel, ds: MotionAudioDataset, cfg: ModelConfig) -> dict:
    """Free-running decode of clip 0 with the trained weights, scored with
    the evaluation metrics on the model's device: ties the teacher-forced
    loss to the inference path (a training-run health readout)."""
    from ..evaluation import beat_alignment, evaluate_motion
    from ..models.flame import FlameModel
    from ..utils.assets import load_or_synthesize_flame

    dev = model.pos_embed.device
    audio, gt = ds.clips[0]
    style = model.encode_style(torch.from_numpy(gt[:50])[None].to(dev))
    state = model.initial_state(style)
    ws = model.window_samples
    n_windows = max(1, math.ceil(len(gt) / cfg.vae.window))
    padded = np.zeros(n_windows * ws, np.float32)
    padded[: len(audio)] = audio[: n_windows * ws]
    chunks = torch.from_numpy(padded).to(dev)
    outs = []
    for k in range(n_windows):
        state, motion = model.window_step(state, chunks[k * ws:(k + 1) * ws][None], style)
        outs.append(motion[0].cpu().numpy())
    pred = np.concatenate(outs)[: len(gt)]
    if cfg.vae.motion_dim == 106:  # FLAME layout -> full geometry metrics
        flame = FlameModel(load_or_synthesize_flame("assets"),
                           n_shape=300, n_exp=100, scale=1.0).to(dev)
        metrics = evaluate_motion(pred, gt, flame, audio=audio, device=dev)
    else:  # non-FLAME motion dim (small test configs): motion-space readout
        metrics = {"frames": int(len(gt)),
                   "motion_l2": float(np.linalg.norm(pred - gt, axis=-1).mean()),
                   "beat_align": beat_alignment(pred, audio)}
    print(f"[train] eval (clip 0): {json.dumps(metrics)}", flush=True)
    return metrics


if __name__ == "__main__":
    main()
