"""artalk_tpu_torch stays free of jax, and the parts it does not port yet
raise instead of being ignored."""

import os
import subprocess
import sys

import pytest
import torch

from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch import engine as tengine
from artalk_tpu_torch.models.ar_model import BitwiseARModel
from artalk_tpu_torch.models.wav2vec import Wav2VecEncoder
from artalk_tpu_torch.ops import rasterizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import artalk_tpu_torch
for m in pkgutil.walk_packages(artalk_tpu_torch.__path__, "artalk_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "artalk_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_import_leaves_jax_out():
    """Every module of the port, and chip_smoke.py, import without jax or
    artalk_tpu (whose __init__ imports jax)."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.resolve_device("cuda")
    assert tengine.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("env,err", [
    ({"ARTALK_AR_PRECISION": "fast"}, NotImplementedError),
    ({"ARTALK_AR_PRECISION": "int8"}, NotImplementedError),
    ({"ARTALK_AR_FUSED": "1"}, NotImplementedError),
    ({"ARTALK_AR_PRECISION": "bogus"}, ValueError),
])
def test_engine_precision_switches_raise(monkeypatch, tmp_path, env, err):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(err, match="ROADMAP.md" if err is NotImplementedError else "exact"):
        tengine.ARTAvatarInferEngine(device="cpu", assets_dir=str(tmp_path))


@pytest.mark.parametrize("kwargs", [
    {"do_stable_layer_norm": False}, {"feat_extract_norm": "group"},
    {"use_flash_attention": True}])
def test_unported_wav2vec_layouts_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Wav2VecEncoder(tcfg.Wav2VecConfig(**kwargs))


def test_mimi_encoder_raises():
    cfg = tcfg.ModelConfig(ar=tcfg.ARConfig(audio_encoder="mimi"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        BitwiseARModel(cfg)


@pytest.mark.parametrize("flag", ["--load_gaga", "--run_app"])
def test_cli_unported_flags_raise(flag):
    from artalk_tpu_torch.cli import main

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        main(["-a", "x.wav", flag])


def test_rasterize_other_devices_raise():
    """CPU tensors take the plain version, CUDA tensors the kernel; nothing
    else silently falls back."""
    verts = torch.zeros((3, 3), device="meta")
    faces = torch.zeros((1, 3), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rasterizer.rasterize(verts, faces, height=8, width=32)
