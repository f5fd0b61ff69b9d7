"""Multi-process jobs of artalk_tpu_torch.parallel, run by
tests/test_torch_parallel.py (and the ``checkpoint`` job by
tests/test_torch_checkpoint.py) as real gloo processes on the CPU.

    python tests/torch_parallel_jobs.py <job> <rank> <world> <init file> <dir>

Each process joins the job's process group through a ``file://`` store (so
concurrent test workers never race for a port; the ``multihost`` job starts
it itself from torchrun's environment variables), runs ``JOBS[job]`` with the
inputs of ``<dir>/inputs.npz`` and writes what it computed to
``<dir>/<job>_rank<rank>.npz``. Nothing here imports jax: the JAX references
are computed in the test process, which imports this module for the
configuration and the one-process training runs it holds the jobs to.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from artalk_tpu_torch import config as tcfg  # noqa: E402
from artalk_tpu_torch.models.ar_model import BitwiseARModel  # noqa: E402
from artalk_tpu_torch.models.bitwise_vae import BitwiseVAE  # noqa: E402
from artalk_tpu_torch.models.renderer import MeshRenderer  # noqa: E402
from artalk_tpu_torch.parallel import make_mesh, shard_params  # noqa: E402
from artalk_tpu_torch.parallel.distributed import local_batch_to_global  # noqa: E402
from artalk_tpu_torch.parallel.render import render_frames_dp  # noqa: E402
from artalk_tpu_torch.parallel.sharding import whole  # noqa: E402
from artalk_tpu_torch.training import data as tdata  # noqa: E402
from artalk_tpu_torch.training import train as ttrain  # noqa: E402
from artalk_tpu_torch.training import trainer as ttrainer  # noqa: E402
from artalk_tpu_torch.utils.checkpoint import (load_params, load_params_sharded,  # noqa: E402
                                               save_params, save_params_sharded)
from artalk_tpu_torch.utils.params import flat_from_module, load_flat_into  # noqa: E402

# tests/test_training.py's CFG in the port's config classes
# (tests/test_torch_parallel.py checks that it is the same)
SMALL_CFG = tcfg.ModelConfig(
    ar=tcfg.ARConfig(depth=2, num_heads=4, embed_dim=64, style_dim=16, audio_dim=32),
    vae=tcfg.VAEConfig(motion_dim=12, code_dim=8, depth=2, num_heads=4, hidden_dim=32,
                       patch_nums=(1, 2, 4)),
    wav2vec=tcfg.Wav2VecConfig(
        conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3),
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4))

TRAIN_STEPS = 3
TRAIN_BATCH = 4     # the global batch: 2 rows a rank at dp=2
TRAIN_LR = 1e-3
# DropPath rates of the training runs, per block: the config's schedule
# (0 to 0.1 * depth / 24 = 0.008 at depth 2) drops no branch of a batch of 4
# in most steps, and a run that drops nothing cannot tell whose masks it drew
DROP_RATES = (0.3, 0.5)


def ar_model(flat: dict) -> BitwiseARModel:
    return load_flat_into(BitwiseARModel(SMALL_CFG), flat)


def vae_model(flat: dict) -> BitwiseVAE:
    """The VAE of the AR model's parameters (their ``vae//`` subtree)."""
    return load_flat_into(BitwiseVAE(SMALL_CFG.vae),
                          {k[len("vae//"):]: v for k, v in flat.items() if k.startswith("vae//")})


def train_batches() -> list:
    """The global batches of the training runs: the port's data pipeline on
    synthetic clips at the small config's widths."""
    window = SMALL_CFG.vae.window
    clips = tdata.synthetic_clips(num_clips=2, frames=6 * window, motion_dim=12, seed=3)
    ds = tdata.MotionAudioDataset(clips, window=window, style_frames=10)
    return list(ds.batches(TRAIN_BATCH, seed=5, num_batches=TRAIN_STEPS))


def train_run(stage: str, flat: dict, mesh=None) -> dict:
    """TRAIN_STEPS steps of ``stage`` ("vae" or "ar", DropPath on at
    DROP_RATES) from ``flat``'s weights on ``train_batches()``: on one
    process without ``mesh``; with it on the rank's rows (through
    ``prefetch_to_device(mesh=...)``), the parameters placed by
    ``shard_params``. Returns the losses, grad norms and gathered final
    parameters."""
    model = vae_model(flat) if stage == "vae" else ar_model(flat)
    if stage == "ar":
        model.drop_path_rates = lambda: torch.tensor(DROP_RATES)
    if mesh is not None:
        shard_params(model, mesh)
    opt = ttrainer.make_optimizer(lr=TRAIN_LR, warmup_steps=1)
    if stage == "vae":
        step = ttrainer.make_vae_train_step(model, opt, mesh=mesh)
    else:
        step = ttrainer.make_ar_train_step(model, opt, mesh=mesh)
    state = ttrainer.init_state(model, opt)
    losses, norms = [], []
    for b in tdata.prefetch_to_device(iter(train_batches()), device="cpu", mesh=mesh):
        if stage == "vae":
            state, m = step(state, b["prev_motion"], b["this_motion"])
        else:
            state, m = step(state, b["audio"], b["prev_motion"], b["this_motion"],
                            b["style_motion"])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    model.requires_grad_(False)
    return {"losses": np.array(losses), "norms": np.array(norms),
            "params": flat_from_module(model)}


# ------------------------------------------------------------------ faults


def _norm_of_local_shards(grads, sharded, tp_group):
    """Fault: the global norm of this rank's tp shards only."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads),
                                                                    dtype=torch.float64)))


def _no_dp_reduction(tensors, group):
    """Fault: the gradients (and metrics) not averaged over dp."""


def _masks_per_rank(rates, batch, generator, mesh=None):
    """Fault: DropPath masks drawn for the rank's rows alone."""
    return ttrainer.drop_path_masks(rates, batch, generator)


FAULTS = {"norm_one_shard": ("global_norm", _norm_of_local_shards, "tp"),
          "no_dp_reduction": ("dp_mean_", _no_dp_reduction, "dp"),
          "masks_per_rank": ("rank_drop_masks", _masks_per_rank, "dp")}


@contextlib.contextmanager
def fault(name: str):
    attr, fn, _ = FAULTS[name]
    saved = getattr(ttrainer, attr)
    setattr(ttrainer, attr, fn)
    try:
        yield
    finally:
        setattr(ttrainer, attr, saved)


# -------------------------------------------------------------------- jobs


def job_decode(inputs: dict) -> dict:
    """tp=2: the exact decode's bits, and the fused decode (plain versions of
    the kernels on the CPU) with float32 and int8 packs of the gathered
    weights, of a sharded model."""
    mesh = make_mesh(dp=1, tp=2, device_type="cpu")
    model = shard_params(ar_model(_flat(inputs)), mesh)
    audio = torch.from_numpy(inputs["audio"])
    out = {}
    with torch.no_grad(), implicit_replication():
        for tag, change in (("exact", {}), ("fused", {"fused_ar": True}),
                            ("int8", {"fused_ar": True, "int8_ar": True, "bf16_ar": True,
                                      "bf16_audio": True})):
            model.cfg = dataclasses.replace(SMALL_CFG, **change)
            model.fused_pack = model.fused_audio_pack = None
            style = model.encode_style(None)
            state = model.initial_state(style, batch_size=audio.shape[0])
            cond = model.audio_condition(audio)
            out[tag] = whole(model.decode_window(cond, style, state.prev_attn_feat)).numpy()
    out["q_local"] = model.blocks.q.w.to_local().numpy()
    return out


def job_generate(inputs: dict) -> dict:
    """dp=2: each rank generates its clips (batch rows) with a model placed
    on the mesh; the rows assembled by ``local_batch_to_global``."""
    mesh = make_mesh(tp=1, device_type="cpu")
    model = shard_params(ar_model(_flat(inputs)), mesh)
    chunks = torch.from_numpy(inputs["chunks"])          # (N, B, samples)
    rows = chunks.shape[1] // mesh.size(0)
    r = mesh.get_local_rank("dp")
    with torch.no_grad(), implicit_replication():
        style = model.encode_style(None)
        local = whole(model.generate(chunks[:, r * rows:(r + 1) * rows], style))
    return {"motions": local_batch_to_global(mesh, local).full_tensor().numpy()}


def job_render(inputs: dict) -> dict:
    mesh = make_mesh(tp=1, device_type="cpu")
    renderer = MeshRenderer(image_size=int(inputs["image_size"]), faces=inputs["faces"],
                            scale=1.0, template_verts=inputs["template"], device="cpu")
    return {"frames": render_frames_dp(renderer, torch.from_numpy(inputs["verts"]),
                                       mesh).numpy()}


def job_train(inputs: dict) -> dict:
    """The sound runs (dp=2 of each stage, tp=2 of the AR stage) and each
    seeded fault on the mesh it concerns."""
    flat = _flat(inputs)
    meshes = {"dp": make_mesh(dp=2, tp=1, device_type="cpu"),
              "tp": make_mesh(dp=1, tp=2, device_type="cpu")}
    runs = {"vae_dp": train_run("vae", flat, meshes["dp"]),
            "ar_dp": train_run("ar", flat, meshes["dp"]),
            "ar_tp": train_run("ar", flat, meshes["tp"])}
    for name, (_, _, axis) in FAULTS.items():
        with fault(name):
            runs[f"fault_{name}"] = train_run("ar", flat, meshes[axis])
    out = {}
    for name, run in runs.items():
        out[f"{name}/losses"], out[f"{name}/norms"] = run["losses"], run["norms"]
        out.update({f"{name}/params/{k}": v for k, v in run["params"].items()})
    return out


def job_pipeline(inputs: dict) -> dict:
    """tests/test_training.py's loop at dp=2: dataset -> prefetch(mesh) ->
    the AR step with style clips, 4 global batches of 4."""
    window = SMALL_CFG.vae.window
    ds = tdata.MotionAudioDataset(
        tdata.synthetic_clips(num_clips=2, frames=6 * window, motion_dim=12),
        window=window, style_frames=10)
    mesh = make_mesh(tp=1, device_type="cpu")
    model = shard_params(ar_model(_flat(inputs)), mesh)
    opt = ttrainer.make_optimizer(lr=1e-3, warmup_steps=1)
    step = ttrainer.make_ar_train_step(model, opt, mesh=mesh)
    state = ttrainer.init_state(model, opt)
    losses = []
    for b in tdata.prefetch_to_device(ds.batches(batch_size=4, num_batches=4), device="cpu",
                                      mesh=mesh):
        state, m = step(state, b["audio"], b["prev_motion"], b["this_motion"],
                        b["style_motion"])
        losses.append(float(m["loss"]))
    return {"losses": np.array(losses)}


def job_train_cli(inputs: dict) -> dict:
    """``train.main`` of the AR stage with --tp 2 on this job's process
    group (the small config in place of ModelConfig()); rank 0 writes the
    npz and returns the evaluation of clip 0."""
    return _train_main(["--tp", "2", "--out", str(inputs["tp_out"])])


def job_multihost(inputs: dict) -> dict:
    """``train.main`` of the AR stage with --multihost (dp over the job's
    ranks), which starts the process group itself from the environment."""
    return _train_main(["--multihost", "--out", str(inputs["multihost_out"])])


def _train_main(flags: list) -> dict:
    ttrain.ModelConfig = lambda: SMALL_CFG
    metrics = ttrain.main(["--stage", "ar", "--synthetic", "--steps", "2", "--batch_size", "2",
                           "--device", "cpu", "--log_every", "1", "--eval"] + flags)
    return {"eval_frames": np.array(-1 if metrics is None else metrics["frames"])}


def job_checkpoint(inputs: dict) -> dict:
    """tp=2: ``save_params_sharded`` of a sharded model (each rank writes its
    shards to ``<ckpt_dir>/sharded``), then ``load_params_sharded`` into
    fresh seed-1 models on a (1, 2) mesh, on a (2, 1) mesh and unsharded;
    and ``save_params`` of the sharded model (gathered) to
    ``<ckpt_dir>/rank<r>.npz`` loaded into a fresh (1, 2)-sharded model.
    Returns each restored model's gathered parameters and the rank's local
    shard of a column-split weight."""
    ckpt = str(inputs["ckpt_dir"])
    tp = make_mesh(dp=1, tp=2, device_type="cpu")
    saved = shard_params(ar_model(_flat(inputs)), tp)
    save_params_sharded(saved, os.path.join(ckpt, "sharded"))
    npz = os.path.join(ckpt, f"rank{dist.get_rank()}.npz")
    save_params(saved, npz)

    def fresh():
        return BitwiseARModel(SMALL_CFG).init(torch.Generator().manual_seed(1))

    restored = {"tp2": shard_params(fresh(), tp),
                "dp2": shard_params(fresh(), make_mesh(dp=2, tp=1, device_type="cpu")),
                "plain": fresh()}
    for model in restored.values():
        load_params_sharded(os.path.join(ckpt, "sharded"), model)
    restored["npz_tp2"] = load_params(npz, like=shard_params(fresh(), tp))
    out = {"q_local": restored["tp2"].blocks.q.w.to_local().numpy()}
    for name, model in restored.items():
        out.update({f"{name}/{k}": v for k, v in flat_from_module(model).items()})
    return out


def job_all(inputs: dict) -> dict:
    """Every job that runs on a process group started here, in one pair of
    processes (each job's keys under its name)."""
    out = {}
    for name in ("decode", "generate", "render", "train", "pipeline", "train_cli"):
        out.update({f"{name}/{k}": v for k, v in JOBS[name](inputs).items()})
    return out


def _flat(inputs: dict) -> dict:
    return {k[len("params/"):]: v for k, v in inputs.items() if k.startswith("params/")}


JOBS = {"decode": job_decode, "generate": job_generate, "render": job_render,
        "train": job_train, "pipeline": job_pipeline, "train_cli": job_train_cli,
        "checkpoint": job_checkpoint, "all": job_all,
        "multihost": job_multihost}
SELF_STARTED = {"multihost"}   # jobs that start the process group themselves


def main(argv) -> None:
    job, rank, world, init_file, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if job not in SELF_STARTED:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world)
    try:
        with np.load(os.path.join(out_dir, "inputs.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        out = JOBS[job](inputs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    jax_loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "artalk_tpu"))
    if jax_loaded:
        raise RuntimeError(f"a job process imported {jax_loaded}")
    np.savez(os.path.join(out_dir, f"{job}_rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1:])
