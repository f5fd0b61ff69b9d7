"""artalk_tpu_torch stays free of jax, the precision switches resolve as in
the JAX engine, the parts it does not port yet raise instead of being
ignored, the kernels' wrappers take no device but the CPU and CUDA, and two
threads that first launch a kernel together build its library once."""

import os
import subprocess
import sys
import threading

import pytest
import torch

from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch import engine as tengine
from artalk_tpu_torch.models.gagavatar import avatar as gaga_avatar
from artalk_tpu_torch.ops import gsplat, rasterizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import artalk_tpu_torch
for m in pkgutil.walk_packages(artalk_tpu_torch.__path__, "artalk_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "artalk_tpu"))
print(" ".join(sorted(m for m in sys.modules if m.startswith("artalk_tpu_torch."))))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_import_leaves_jax_out():
    """Every module of the port, and chip_smoke.py, import without jax or
    artalk_tpu (whose __init__ imports jax); the GAGAvatar modules, the
    flash-attention wrapper, HuBERT, Mimi, the key sort, the debug renderers,
    the evaluation metrics, the native media runtime, the HTTP server, the
    checkpoint converter, the web UI, the metrics registry, the training
    package, the window-step export, the parallel package, the bench
    with its timing and roofline helpers, the checkpoint and video
    modules, and the measurement tools
    (``tools/``: the pool curve, the HTTP load test, the four stage
    profilers) are among them."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    imported = set(proc.stdout.split("\n")[0].split())
    gaga = {f"artalk_tpu_torch.models.gagavatar.{m}"
            for m in ("avatar", "dino", "generators", "style_unet", "watermark")}
    assert gaga | {"artalk_tpu_torch.ops.gsplat", "artalk_tpu_torch.ops.resize2d",
                   "artalk_tpu_torch.ops.attention", "artalk_tpu_torch.models.hubert",
                   "artalk_tpu_torch.models.mimi", "artalk_tpu_torch.ops.sort",
                   "artalk_tpu_torch.models.renderer_extras",
                   "artalk_tpu_torch.evaluation", "artalk_tpu_torch.runtime.media",
                   "artalk_tpu_torch.server", "artalk_tpu_torch.convert_checkpoint",
                   "artalk_tpu_torch.app_gradio", "artalk_tpu_torch.utils.convert",
                   "artalk_tpu_torch.utils.metrics", "artalk_tpu_torch.training.train",
                   "artalk_tpu_torch.training.trainer", "artalk_tpu_torch.training.data",
                   "artalk_tpu_torch.export_model", "artalk_tpu_torch.parallel.mesh",
                   "artalk_tpu_torch.parallel.sharding", "artalk_tpu_torch.parallel.render",
                   "artalk_tpu_torch.parallel.distributed", "artalk_tpu_torch.bench",
                   "artalk_tpu_torch.utils.timing", "artalk_tpu_torch.utils.roofline",
                   "artalk_tpu_torch.utils.checkpoint", "artalk_tpu_torch.utils.video",
                   "artalk_tpu_torch.tools"} | {
                       f"artalk_tpu_torch.tools.{m}" for m in (
                           "bench_streampool", "bench_http_serving", "profile_pipeline",
                           "profile_encoder", "profile_gsplat", "profile_gaga")} <= imported


_IMPORT_BLOCKED = """
import sys
for name in ("jax", "jaxlib", "artalk_tpu"):
    sys.modules[name] = None          # any import of them raises ImportError
import artalk_tpu_torch.training
from artalk_tpu_torch.training import data, losses, train, trainer
from artalk_tpu_torch import export_model
from artalk_tpu_torch.parallel import distributed, mesh, render, sharding
from artalk_tpu_torch.utils import checkpoint, video
print(sorted(artalk_tpu_torch.training.__all__))
"""


def test_training_and_export_import_with_jax_blocked():
    """The training package, the export entry point, the parallel package and
    the checkpoint and video modules import in a process where importing
    jax, jaxlib or artalk_tpu fails."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_BLOCKED], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "make_ar_train_step" in proc.stdout


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.resolve_device("cuda")
    assert tengine.resolve_device("cpu") == torch.device("cpu")


def test_engine_precision_switches_raise(monkeypatch, tmp_path):
    monkeypatch.setenv("ARTALK_AR_PRECISION", "bogus")
    with pytest.raises(ValueError, match="exact"):
        tengine.ARTAvatarInferEngine(device="cpu", assets_dir=str(tmp_path))


@pytest.mark.parametrize("env,want", [
    ({"ARTALK_AR_PRECISION": "fast"}, (True, True, False, False)),
    ({"ARTALK_AR_PRECISION": "int8"}, (True, True, True, True)),
    ({"ARTALK_AR_FUSED": "1"}, (False, False, True, False)),
])
def test_engine_precision_switches_resolve(monkeypatch, env, want):
    """The switches set (bf16_audio, bf16_ar, fused_ar, int8_ar) as the JAX
    engine's _resolve_ar_precision does."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = tengine._resolve_ar_precision(tcfg.ModelConfig())
    assert (cfg.bf16_audio, cfg.bf16_ar, cfg.fused_ar, cfg.int8_ar) == want


@pytest.mark.parametrize("env,want", [
    ({}, True),
    ({"ARTALK_GAGA_PRECISION": "exact"}, False),
    ({"ARTALK_BF16_SR": "0"}, True),
    ({"ARTALK_GAGA_PRECISION": "exact", "ARTALK_BF16_SR": "1"}, False),
])
def test_gaga_precision_switches_resolve(monkeypatch, env, want):
    """bf16 SR and splat colors follow ARTALK_GAGA_PRECISION alone; the JAX
    package's legacy ARTALK_BF16_SR does not split them in the port."""
    for k in ("ARTALK_GAGA_PRECISION", "ARTALK_BF16_SR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert gaga_avatar.resolve_precision() == want
    monkeypatch.setenv("ARTALK_GAGA_PRECISION", "bogus")
    with pytest.raises(ValueError, match="exact"):
        gaga_avatar.resolve_precision()


@pytest.mark.parametrize("flag", ["--run_app"])
def test_cli_unported_flags_raise(flag, monkeypatch):
    """``--run_app`` builds the engine and serves the web UI, as the JAX CLI
    does; without gradio (absent here) it raises the JAX CLI's RuntimeError
    instead of doing nothing."""
    from artalk_tpu_torch import cli

    built = []
    monkeypatch.setattr(cli, "ARTAvatarInferEngine", lambda **kw: built.append(kw))
    monkeypatch.setitem(sys.modules, "gradio", None)     # import gradio fails
    with pytest.raises(RuntimeError, match="gradio is not installed"):
        cli.main([flag])
    assert len(built) == 1


def test_rasterize_other_devices_raise():
    """CPU tensors take the plain version, CUDA tensors the kernel; nothing
    else silently falls back."""
    verts = torch.zeros((3, 3), device="meta")
    faces = torch.zeros((1, 3), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rasterizer.rasterize(verts, faces, height=8, width=32)


def test_rasterize_gaussians_other_devices_raise():
    """The splat, likewise: CPU tensors take rasterize_gaussians_plain, CUDA
    tensors the kernel, any other device raises."""
    n = 4
    args = [torch.zeros(shape, device="meta") for shape in
            ((n, 3), (n, 32), (n, 1), (n, 3), (n, 4), (3, 4))]
    with pytest.raises(ValueError, match="unsupported device"):
        gsplat.rasterize_gaussians(*args, size=128)


@pytest.mark.parametrize("name", ["ar_block_stack", "attention", "encoder_block_stack",
                                  "gsplat", "motion_json", "rasterizer", "sort"])
def test_kernel_headers_cover_the_includes(name):
    """A kernel library is named by a hash of its SOURCE and HEADERS only, so
    HEADERS must list every header the source reaches through #include "...":
    a missing one would leave a stale library in place after that header
    changed. Reads the files; needs no nvcc."""
    import importlib
    import re

    mod = importlib.import_module(f"artalk_tpu_torch.ops.{name}")
    reached, todo = set(), [mod.SOURCE]
    while todo:
        for inc in re.findall(r'^\s*#include\s+"([^"]+)"', todo.pop().read_text(), re.M):
            path = mod.SOURCE.parent / inc
            if path not in reached:
                reached.add(path)
                todo.append(path)
    assert reached <= set(getattr(mod, "HEADERS", ())), sorted(
        p.name for p in reached - set(getattr(mod, "HEADERS", ())))


def test_build_library_builds_once_across_threads(tmp_path, monkeypatch):
    """Threads that first launch one kernel together run nvcc once (the
    others wait on the source's lock and load the same library), and nvcc
    writes to a temporary file of its own thread. nvcc and the loader are
    stubbed, so this needs no CUDA; the switch interval is shortened so the
    threads interleave."""
    from artalk_tpu_torch.ops import _nvcc

    source = tmp_path / "k.cu"
    source.write_text("// kernel")
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path / "build")
    runs, outputs = [], set()

    def fake_nvcc(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        runs.append(threading.get_ident())
        outputs.add(out)
        with open(out, "w") as f:
            f.write("lib")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info: 32 registers")

    monkeypatch.setattr(_nvcc.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_nvcc.ctypes, "CDLL", lambda path: ("lib", path))
    n = 4 * (os.cpu_count() or 1)
    barrier, results, errors = threading.Barrier(n), [], []

    def first_launch():
        try:
            barrier.wait(timeout=30)
            results.append(_nvcc.build_library(source)[0])
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_launch) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(runs) == 1 and len(results) == n and len(set(results)) == 1
    (out,) = outputs
    assert str(runs[0]) in os.path.basename(out)
    assert results[0][1].endswith(".so") and os.path.exists(results[0][1])
    assert _nvcc.library_lock(source) is _nvcc.library_lock(str(source))


@pytest.mark.parametrize("suffix", [".cu", ".cpp"])
def test_build_library_picks_the_compiler_by_suffix(tmp_path, monkeypatch, suffix):
    """A CUDA source goes to nvcc for sm_90a, a host source to the host
    compiler as C++17 (no nvcc flag); both into the same hash-named cache,
    bound with ctypes.CDLL. The compiler and the loader are stubbed."""
    from artalk_tpu_torch.ops import _nvcc

    source = tmp_path / f"k{suffix}"
    source.write_text("// source")
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path / "build")
    cmds = []

    def fake_compiler(cmd, **kwargs):
        cmds.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_nvcc.subprocess, "run", fake_compiler)
    monkeypatch.setattr(_nvcc.ctypes, "CDLL", lambda path: ("lib", path))
    lib, _, report = _nvcc.build_library(source)
    _nvcc.build_library(source)                         # reused from the cache
    (cmd,) = cmds
    assert report == "" and "-std=c++17" in cmd and cmd[-1] == str(source)
    assert os.path.dirname(lib[1]) == str(tmp_path / "build")
    if suffix == ".cu":
        assert os.path.basename(cmd[0]) == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    else:
        assert os.path.basename(cmd[0]) in ("c++", "g++") and "-fPIC" in cmd
        assert not any("sm_90a" in arg or arg.startswith("-X") for arg in cmd)
