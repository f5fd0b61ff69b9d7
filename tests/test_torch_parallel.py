"""artalk_tpu_torch.parallel against the JAX package's parallel/ (counterpart
of tests/test_parallel.py, and of tests/test_training.py's dp training loop),
on tests/test_training.py's small CFG with JAX's seed-0 weights.

The mesh and placement tests need no collectives and run in this process on
torch's in-process ``fake`` process group (8 ranks, as the JAX tests' 8
virtual devices). The numeric tests run as two real gloo processes
(tests/torch_parallel_jobs.py; they import no jax) on the CPU, once for the
module, against references computed here:

- tp=2 decode bits equal JAX's unsharded ``decode_window``, and the fused
  decode (the kernels' plain versions) from the gathered float32 and int8
  packs equals the unsharded model's bit for bit;
- dp=2 ``generate`` equals JAX's within 1e-5, and ``render_frames_dp`` of 5
  frames (ragged against dp=2) equals ``renderer(verts)`` bit for bit;
- training under a mesh (3 steps of each stage at dp=2, 3 AR steps at tp=2,
  DropPath on) equals the one-process run on the same global batches within
  ``TRAIN_TOL``, and three seeded faults (the norm over one tp shard, no
  gradient reduction over dp, DropPath masks drawn per rank) each exceed it
  tenfold;
- ``train.main`` with ``--tp 2`` and with ``--multihost``: rank 0's npz
  loads through JAX's ``load_params(like=...)`` and equals the one-process
  run's within ``TRAIN_TOL``.
"""

import copy
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from artalk_tpu.models.ar_model import BitwiseARModel as JaxARModel
from artalk_tpu.parallel.mesh import make_mesh as jax_make_mesh
from artalk_tpu.parallel.sharding import _path_str, param_shardings as jax_param_shardings
from artalk_tpu.utils.checkpoint import _flatten, load_params

from artalk_tpu_torch.models.flame import FlameModel
from artalk_tpu_torch.models.renderer import MeshRenderer
from artalk_tpu_torch.ops.ar_block_stack import pack_block_weights
from artalk_tpu_torch.ops.encoder_block_stack import pack_encoder_weights
from artalk_tpu_torch.parallel import make_mesh, param_shardings, shard_params
from artalk_tpu_torch.parallel.sharding import batch_sharding, whole
from artalk_tpu_torch.training import train as ttrain
from artalk_tpu_torch.training import trainer as ttrainer
from artalk_tpu_torch.utils.assets import load_or_synthesize_flame
from artalk_tpu_torch.utils.params import load_params_npz

import torch_parallel_jobs as jobs
from test_torch_params import jax_model_and_flat, port_model, torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)
from test_training import CFG

JOBS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_jobs.py")
JOB_TIMEOUT = 120   # seconds each process of a job may take
RENDER_FRAMES, RENDER_SIZE = 5, 128
# training under a mesh against one process: relative loss and grad_norm,
# absolute parameters. The sound runs read 1.0e-7, 1.4e-7 and 5.6e-6 (Adam's
# first updates amplify rounding where a gradient sits near 0; lr 1e-3); the
# seeded faults exceed these tenfold or more
TRAIN_TOL = {"loss": 1e-6, "grad_norm": 1e-6, "params": 5e-5}


def test_jobs_config_is_the_training_tests_config():
    assert jobs.SMALL_CFG == torch_config(CFG)


# ----------------------------------------------------- mesh and placements


@pytest.fixture
def fake_world():
    """An in-process ``fake`` process group of 8 ranks (this one rank 0):
    meshes and placements, no data moved."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_shapes(fake_world):
    mesh = make_mesh(dp=4, tp=2, device_type="cpu")
    assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.shape) == (4, 2)
    assert tuple(make_mesh(device_type="cpu").shape) == (8, 1)
    assert tuple(make_mesh(tp=4, device_type="cpu").shape) == (2, 4)
    small = make_mesh(dp=2, tp=2, device_type="cpu")   # the first 4 ranks
    assert tuple(small.shape) == (2, 2) and small.mesh.flatten().tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("kwargs,error", [({"tp": 3}, ValueError),
                                          ({"dp": 4, "tp": 4}, ValueError)])
def test_make_mesh_refuses_bad_shapes(fake_world, kwargs, error):
    with pytest.raises(error):
        make_mesh(device_type="cpu", **kwargs)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device_type="cpu")


def test_cuda_requests_without_a_card_raise(fake_world, monkeypatch):
    """No fallback to the CPU or to gloo: a CUDA mesh, or a job on NCCL (the
    default backend), without a card raises before anything starts."""
    from artalk_tpu_torch.parallel.distributed import initialize_multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_multihost("127.0.0.1:1", num_processes=1, process_id=0)


def _jax_specs() -> dict:
    """JAX's ``param_shardings`` spec of every leaf of the small model, by
    flat name."""
    _, params, _ = jax_model_and_flat(CFG)
    shardings = jax_param_shardings(params, jax_make_mesh(dp=4, tp=2))
    return {_path_str(path): s.spec
            for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}


def _as_spec(placements, ndim: int) -> P:
    """(dp, tp) placements as the JAX PartitionSpec they stand for."""
    assert placements[0] == Replicate()
    tp = placements[1]
    if tp == Replicate():
        return P()
    spec = [None] * ndim
    spec[tp.dim] = "tp"
    return P(*spec)


def test_param_sharding_rules_equal_jax(fake_world):
    """Every placement of the whole small model is JAX's spec for the same
    flat name, and the rules shard what tests/test_parallel.py says they do."""
    model = port_model(CFG)
    shardings = param_shardings(model, make_mesh(dp=4, tp=2, device_type="cpu"))
    want = _jax_specs()
    assert set(shardings) == set(want)
    ndim = {n.replace(".", "//"): p.ndim for n, p in model.named_parameters()}
    for name, placements in shardings.items():
        assert _as_spec(placements, ndim[name]) == want[name], name
    assert shardings["blocks//q//w"] == (Replicate(), Shard(2))
    assert shardings["blocks//proj//w"] == (Replicate(), Shard(1))
    assert shardings["blocks//fc2//w"] == (Replicate(), Shard(1))
    assert shardings["blocks//k//w"] == (Replicate(), Shard(2))
    assert shardings["audio_encoder//encoder//layers//k//b"] == (Replicate(), Shard(1))
    assert shardings["audio_encoder//encoder//layers//out//w"] == (Replicate(), Shard(1))
    assert shardings["pos_embed"] == (Replicate(), Replicate())
    assert sum(p[1] != Replicate() for p in shardings.values()) == 19


def test_shard_params_places_every_parameter(fake_world):
    """Each parameter becomes a DTensor of the rules' placements whose local
    tensor is this rank's shard of the value (tp index 0: the first half of
    a sharded dim), requires_grad kept."""
    model = port_model(CFG)
    flat = jax_model_and_flat(CFG)[2]
    model.blocks.q.w.requires_grad_(True)
    mesh = make_mesh(dp=4, tp=2, device_type="cpu")
    shardings = param_shardings(model, mesh)
    assert shard_params(model, mesh) is model
    for name, p in model.named_parameters():
        key = name.replace(".", "//")
        assert p.placements == shardings[key], key
        local, full = p.to_local().detach().numpy(), flat[key]
        tp = shardings[key][1]
        if tp == Replicate():
            np.testing.assert_array_equal(local, full, err_msg=key)
        else:
            assert local.shape[tp.dim] * 2 == full.shape[tp.dim], key
            np.testing.assert_array_equal(
                local, np.take(full, np.arange(local.shape[tp.dim]), axis=tp.dim), err_msg=key)
        assert p.requires_grad == (key == "blocks//q//w"), key
    assert model.blocks.q.w.to_local().shape == (2, 64, 32)
    assert model.blocks.fc2.w.to_local().shape == (2, 128, 64)


@pytest.mark.parametrize("axis,ndim,want", [(0, 3, (Shard(0), Replicate())),
                                            (1, 3, (Shard(1), Replicate())),
                                            (-1, 2, (Shard(1), Replicate()))])
def test_batch_sharding(fake_world, axis, ndim, want):
    assert batch_sharding(make_mesh(dp=4, tp=2, device_type="cpu"), ndim, axis) == want


def _local_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` holding each DTensor parameter's local shard."""
    copied = copy.deepcopy(module)
    for name, p in list(copied.named_parameters()):
        owner, _, attr = name.rpartition(".")
        copied.get_submodule(owner)._parameters[attr] = torch.nn.Parameter(
            p.to_local().detach(), requires_grad=False)
    return copied


@pytest.mark.parametrize("stack", ["ar", "encoder"])
def test_packing_a_shard_is_caught(fake_world, stack):
    """The kernels never run on one shard: the whole weights pack, a pack of
    a tp=2 rank's local shards raises."""
    model = port_model(CFG)
    if stack == "ar":
        layers_of, pack = (lambda m: m.blocks), (
            lambda layers: pack_block_weights(layers, CFG.ar.num_heads))
    else:
        layers_of, pack = (lambda m: m.audio_encoder.encoder.layers), pack_encoder_weights
    pack(layers_of(model))
    shard_params(model, make_mesh(dp=4, tp=2, device_type="cpu"))
    with pytest.raises(ValueError, match="shard"):
        pack(_local_copy(layers_of(model)))


def test_whole_keeps_a_plain_tensor():
    t = torch.ones(3)
    assert whole(t) is t


@pytest.fixture
def world_of_one(tmp_path):
    """A real gloo process group of this process alone: a (1, 1) mesh, as
    one card holds in chip_smoke.py's phase 33."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        yield make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_world_of_one_mesh_equals_plain(world_of_one):
    """On a (1, 1) mesh the sharded model's exact and int8 decode bits, and
    an AR step through the mesh-aware trainer (DropPath on), equal the plain
    model's exactly (DTensor ops may leave sums pending on a mesh axis of
    one: attention reduces them first)."""
    mesh = world_of_one
    int8 = {"fused_ar": True, "int8_ar": True, "bf16_ar": True, "bf16_audio": True}
    batch = {k: torch.from_numpy(v) for k, v in jobs.train_batches()[0].items()}
    args = [batch[k] for k in ("audio", "prev_motion", "this_motion", "style_motion")]
    got = {}
    for sharded in (False, True):
        model = port_model(CFG)
        if sharded:
            shard_params(model, mesh)
        with torch.no_grad(), implicit_replication():
            for tag, change in (("exact", {}), ("int8", int8)):
                model.set_precision(dataclasses.replace(jobs.SMALL_CFG, **change))
                style = model.encode_style(None)
                state = model.initial_state(style, batch_size=4)
                got[sharded, tag] = whole(model.decode_window(
                    model.audio_condition(args[0]), style, state.prev_attn_feat))
        model.set_precision(jobs.SMALL_CFG)
        opt = ttrainer.make_optimizer(lr=1e-3, warmup_steps=1)
        step = ttrainer.make_ar_train_step(model, opt, mesh=mesh if sharded else None)
        _, got[sharded, "step"] = step(ttrainer.init_state(model, opt), *args)
    for tag in ("exact", "int8"):
        assert torch.equal(got[True, tag], got[False, tag]), tag
    assert {k: float(v) for k, v in got[True, "step"].items()} == \
        {k: float(v) for k, v in got[False, "step"].items()}


# ---------------------------------------------------- two gloo processes


def start_job(job: str, inputs: dict, out_dir, env: dict = None) -> tuple:
    """Start ``job`` of tests/torch_parallel_jobs.py as 2 gloo processes on
    ``inputs``; ``finish_job`` waits for them."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "inputs.npz"), **inputs)
    init = os.path.join(out_dir, "init")
    procs = []
    for rank in range(2):
        rank_env = {**env, "RANK": str(rank), "LOCAL_RANK": str(rank)} if env else {}
        procs.append(subprocess.Popen(
            [sys.executable, JOBS, job, str(rank), "2", init, str(out_dir)],
            env={**os.environ, **rank_env}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return job, procs, out_dir


def finish_job(started: tuple) -> list:
    """Wait (JOB_TIMEOUT each) for a started job's processes, which must
    succeed; returns each rank's outputs."""
    job, procs, out_dir = started
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=JOB_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{job} rank {rank} failed:\n{out}"
    results = []
    for rank in range(2):
        with np.load(os.path.join(out_dir, f"{job}_rank{rank}.npz")) as z:
            results.append({k: z[k] for k in z.files})
    return results


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module", autouse=True)
def jobs_started(tmp_path_factory):
    """Both two-process jobs, started as the module starts so that they run
    while this process computes the references: every job on a process
    group that the job runner starts ("all"), and ``train.main
    --multihost``, whose processes find each other through MASTER_ADDR /
    MASTER_PORT (a port bound, then freed). Yields the inputs and the
    started jobs; kills what is left at the end."""
    flat = jax_model_and_flat(CFG)[2]
    model = port_model(CFG)
    rng = np.random.default_rng(0)
    flame_data = load_or_synthesize_flame("assets")
    flame = FlameModel(flame_data, n_shape=300, n_exp=100, scale=1.0)
    motions = torch.from_numpy(rng.normal(0, 0.3, (RENDER_FRAMES, 106)).astype(np.float32))
    with torch.no_grad():
        verts = flame.motion_to_verts(torch.zeros(RENDER_FRAMES, 300), motions)
    out = tmp_path_factory.mktemp("parallel_jobs")
    inputs = {**{f"params/{k}": v for k, v in flat.items()},
              "audio": rng.standard_normal((2, model.window_samples)).astype(np.float32),
              "chunks": np.random.default_rng(1).standard_normal(
                  (2, 4, model.window_samples)).astype(np.float32),
              "verts": verts.numpy(), "faces": np.asarray(flame_data["faces"], np.int32),
              "template": np.asarray(flame_data["v_template"], np.float32),
              "image_size": np.array(RENDER_SIZE),
              "tp_out": str(out / "tp" / "trained.npz"),
              "multihost_out": str(out / "multihost" / "trained.npz")}
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": "2"}
    started = {"all": start_job("all", inputs, out / "all"),
               "multihost": start_job("multihost", inputs, out / "multihost_job", env)}
    yield inputs, started
    for _, procs, _ in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def job_inputs(jobs_started):
    return jobs_started[0]


@pytest.fixture(scope="module")
def ranks(jobs_started):
    """Each rank's outputs of the "all" job."""
    return finish_job(jobs_started[1]["all"])


@pytest.fixture(scope="module")
def multihost_ranks(jobs_started):
    return finish_job(jobs_started[1]["multihost"])


def _one_process_cli(out) -> dict:
    """``train.main`` of the AR stage in this process, as the jobs run it."""
    saved = ttrain.ModelConfig
    ttrain.ModelConfig = lambda: jobs.SMALL_CFG
    try:
        ttrain.main(["--stage", "ar", "--synthetic", "--steps", "2", "--batch_size", "2",
                     "--device", "cpu", "--log_every", "1", "--out", str(out)])
    finally:
        ttrain.ModelConfig = saved
    return load_params_npz(str(out))


@pytest.fixture(scope="module")
def references(job_inputs, tmp_path_factory):
    """What the jobs are held to, computed in this process while they run
    (each test asks for it before the jobs' outputs): JAX's unsharded
    decode bits and generate, the unsharded model's fused decode bits, the
    one-process render, training runs and ``train.main`` weights."""
    inputs = job_inputs
    jm, params, flat = jax_model_and_flat(CFG)
    audio = jnp.asarray(inputs["audio"])
    style = jm.encode_style(params, None)
    state = jm.initial_state(params, style, batch_size=2)
    cond = jm.audio_condition(params, audio)
    refs = {"decode/exact": np.asarray(jax.jit(jm.decode_window)(params, cond, style,
                                                                 state.prev_attn_feat)),
            "generate": np.asarray(jax.jit(jm.generate)(params, jnp.asarray(inputs["chunks"]),
                                                        style))}
    model = port_model(CFG)
    for tag, change in (("fused", {"fused_ar": True}),
                        ("int8", {"fused_ar": True, "int8_ar": True, "bf16_ar": True,
                                  "bf16_audio": True})):
        model.set_precision(dataclasses.replace(jobs.SMALL_CFG, **change))
        with torch.no_grad():
            tstyle = model.encode_style(None)
            tstate = model.initial_state(tstyle, batch_size=2)
            refs[f"decode/{tag}"] = model.decode_window(
                model.audio_condition(torch.from_numpy(inputs["audio"])), tstyle,
                tstate.prev_attn_feat).numpy()
    renderer = MeshRenderer(image_size=RENDER_SIZE, faces=inputs["faces"], scale=1.0,
                            template_verts=inputs["template"], device="cpu")
    refs["render"] = renderer(torch.from_numpy(inputs["verts"])).numpy()
    refs["train"] = {stage: jobs.train_run(stage, flat) for stage in ("vae", "ar")}
    refs["cli"] = _one_process_cli(tmp_path_factory.mktemp("one_process_cli") / "trained.npz")
    return refs


def test_tp_decode_bits_equal_jax(references, ranks):
    """tp=2-sharded decode emits the same code bits as JAX's unsharded
    single-device decode, on both ranks."""
    for r in ranks:
        np.testing.assert_array_equal(r["decode/exact"], references["decode/exact"])


@pytest.mark.parametrize("tag", ["fused", "int8"])
def test_tp_fused_decode_from_gathered_packs(references, ranks, tag):
    """The fused decode of a tp=2 model (the block stacks' plain versions on
    the CPU) packs the gathered weights: its bits equal the unsharded
    model's fused decode bit for bit, and the rank's q weight is its shard."""
    flat = jax_model_and_flat(CFG)[2]
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r[f"decode/{tag}"], references[f"decode/{tag}"])
        np.testing.assert_array_equal(r["decode/q_local"],
                                      flat["blocks//q//w"][..., rank * 32:(rank + 1) * 32])


def test_dp_generate_matches_jax(references, ranks):
    """dp=2 generate (each rank its 2 clips, assembled by
    local_batch_to_global) matches JAX's unsharded generate to 1e-5."""
    want = references["generate"]
    for r in ranks:
        assert r["generate/motions"].shape == want.shape == (4, 2 * CFG.vae.window, 12)
        np.testing.assert_allclose(r["generate/motions"], want, atol=1e-5, rtol=1e-5)


def test_render_frames_dp_matches_single_process(references, ranks):
    """Frame-parallel mesh rendering over dp=2 of 5 frames (padded to 6,
    trimmed) equals the one-process renderer output bit for bit."""
    want = references["render"]
    for r in ranks:
        assert r["render/frames"].shape == want.shape == (RENDER_FRAMES, RENDER_SIZE,
                                                          RENDER_SIZE, 3)
        np.testing.assert_array_equal(r["render/frames"], want)


def train_errors(r: dict, run: str, ref: dict) -> dict:
    """A run's largest differences from the one-process run, each over its
    TRAIN_TOL."""
    loss = np.abs(r[f"train/{run}/losses"] - ref["losses"]) / np.abs(ref["losses"])
    norm = np.abs(r[f"train/{run}/norms"] - ref["norms"]) / np.abs(ref["norms"])
    params = max(float(np.abs(r[f"train/{run}/params/{k}"] - v).max())
                 for k, v in ref["params"].items())
    return {"loss": float(loss.max()) / TRAIN_TOL["loss"],
            "grad_norm": float(norm.max()) / TRAIN_TOL["grad_norm"],
            "params": params / TRAIN_TOL["params"]}


@pytest.mark.parametrize("run", ["vae_dp", "ar_dp", "ar_tp"])
def test_training_under_a_mesh_matches_one_process(references, ranks, run):
    """3 steps from JAX's weights on the same global batches (DropPath on,
    at rates that drop): the loss, grad_norm and every final parameter
    (gathered) of each rank within TRAIN_TOL of the one-process run."""
    ref = references["train"][run.split("_")[0]]
    for r in ranks:
        assert len(r[f"train/{run}/losses"]) == jobs.TRAIN_STEPS
        errors = train_errors(r, run, ref)
        assert max(errors.values()) <= 1.0, errors


@pytest.mark.parametrize("fault", sorted(jobs.FAULTS))
def test_seeded_faults_exceed_the_tolerance(references, ranks, fault):
    """The tolerance catches each seeded fault tenfold: the norm over one tp
    shard, no gradient reduction over dp, DropPath masks drawn per rank."""
    for r in ranks:
        errors = train_errors(r, f"fault_{fault}", references["train"]["ar"])
        assert max(errors.values()) >= 10.0, errors


def test_dp_pipeline_loop(ranks):
    """Dataset -> prefetch(mesh) -> dp=2 AR train step with style clips over
    4 batches of 4 (tests/test_training.py's loop): finite losses."""
    for r in ranks:
        losses = r["pipeline/losses"]
        assert losses.shape == (4,) and np.isfinite(losses).all()


def check_cli_npz(path: str, want: dict) -> None:
    """Rank 0's npz loads through JAX's ``load_params(like=init)``, and
    equals the one-process run's within TRAIN_TOL's parameter limit."""
    like = jax.eval_shape(JaxARModel(CFG).init, jax.random.PRNGKey(0))
    loaded = _flatten(load_params(path, like=like))
    assert set(loaded) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(loaded[k], v, rtol=0, atol=TRAIN_TOL["params"], err_msg=k)


def test_train_main_tp2(references, ranks, job_inputs):
    """``train.main --tp 2 --device cpu --eval`` on two processes: rank 0
    writes the gathered weights and evaluates clip 0, rank 1 neither."""
    assert [int(r["train_cli/eval_frames"]) for r in ranks] == [500, -1]
    check_cli_npz(str(job_inputs["tp_out"]), references["cli"])


def test_train_main_multihost(references, multihost_ranks, job_inputs):
    """``train.main --multihost --device cpu --eval``: the group from the
    environment, dp over both ranks."""
    assert [int(r["eval_frames"]) for r in multihost_ranks] == [500, -1]
    check_cli_npz(str(job_inputs["multihost_out"]), references["cli"])
