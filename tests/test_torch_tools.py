"""The port's measurement tools (``artalk_tpu_torch/tools/``) on the CPU at
small sizes: the StreamPool curve and its arithmetic against the JAX tool's,
the splat profiler's staged prepass against ``ops/gsplat.prepass`` (bit for
bit) and against the JAX tool's key sort, the pipeline, encoder and
GAGAvatar profilers' stages in the JAX tools' order, and each tool's CLI
without CUDA. The pool's ``device_step`` and the HTTP load test against the
JAX pool are in ``tests/test_torch_tools_http.py``.

On the CPU every kernel takes its plain version and the times are the CPU's;
the tests check what runs and what is printed, not the times."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artalk_tpu.ops import gsplat as jgs
from artalk_tpu.utils.assets import save_flame_npz, synthetic_flame

from artalk_tpu_torch.models.gagavatar import avatar as tavatar
from artalk_tpu_torch.models.gagavatar import dino as tdino
from artalk_tpu_torch.models.gagavatar import generators as tgen
from artalk_tpu_torch.models.gagavatar import style_unet as tunet
from artalk_tpu_torch.ops import gsplat as tgs
from artalk_tpu_torch.ops import resize2d as tresize
from artalk_tpu_torch.tools import (bench_streampool, profile_encoder, profile_gaga,
                                    profile_gsplat, profile_pipeline)

from test_ar_model import CFG
from test_torch_gagavatar import T_DINO, _shrink
from test_torch_params import torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = torch_config(CFG)
TOOLS = ("bench_streampool", "bench_http_serving", "profile_pipeline", "profile_encoder",
         "profile_gsplat", "profile_gaga")
PRECISION_ENV = ("ARTALK_AR_PRECISION", "ARTALK_AR_FUSED", "ARTALK_GAGA_PRECISION")


@pytest.fixture
def no_precision_env(monkeypatch):
    for k in PRECISION_ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def small_assets(tmp_path, monkeypatch):
    """An assets directory with a 400-vertex synthetic FLAME, as the tools'
    ``ASSETS``."""
    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(tmp_path / "flame_synthetic.npz"))
    monkeypatch.setattr(profile_pipeline, "ASSETS", tmp_path)
    return tmp_path


def _labels(out: str, pattern: str) -> list:
    """The label of each timed line: the text before its ms column."""
    return [m.group(1).strip() for m in re.finditer(pattern, out, re.M)]


# ------------------------------------------------------------- the pool curve


def test_curve_is_the_jax_tools_arithmetic():
    """``curve`` against tools/bench_streampool.py's lines: per_session =
    ms / b, streams = window_s / (ms / 1e3) * b, the knee the most streams."""
    ms_by_b = {1: 31.25, 2: 40.0, 4: 52.5, 8: 90.0, 16: 171.0, 32: 360.0}
    window_s = 100 / 25
    rows, knee = bench_streampool.curve(ms_by_b, window_s)
    want = []
    for b, ms in ms_by_b.items():          # the JAX tool's loop body
        per_session = ms / b
        streams = window_s / (ms / 1e3) * b
        want.append((b, ms, per_session, streams))
    assert rows == want
    assert knee == max(want, key=lambda r: r[3]) == want[-2]


def test_streampool_tool_prints_a_row_per_size_and_the_knee(capsys, monkeypatch,
                                                            no_precision_env):
    """int8 (both kernels' plain versions on the CPU): one row per B, the
    knee line, the rows ``curve`` gives."""
    monkeypatch.setenv("ARTALK_AR_PRECISION", "int8")
    rows = bench_streampool.main(["--sizes", "1,2", "--iters", "1"], device="cpu",
                                 config=SMALL)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu  precision=int8"
    assert [r[0] for r in rows] == [1, 2]
    for (b, ms, per_session, streams), line in zip(rows, out[1:3]):
        assert line.startswith(f"B={b:<3d}") and f"{per_session:6.2f} ms/session-window" in line
        assert ms > 0 and streams > 0
    knee = max(rows, key=lambda r: r[3])
    assert out[-1] == (f"knee: B={knee[0]} -> {knee[2]:.2f} ms/session-window, "
                       f"~{knee[3]:.0f} real-time streams/chip")


# ---------------------------------------------------------------- the splat


def _small_scene():
    return profile_gsplat.make_scene(np.random.default_rng(0), 2 * 32 * 32,
                                     torch.device("cpu"))


def _jax_tool_s2(xyz, scales, rots, opac, cam, size):
    """tools/profile_gsplat.py's ``_through_keys(..., stop="sort")`` with its
    default slot cap (the exact bound) and no budget cut: the JAX package's
    helpers and ``jax.lax.sort`` on the CPU. Returns (sorted keys, offsets)."""
    xyz, scales, rots, opac, cam = (jnp.asarray(t.numpy()) for t in (xyz, scales, rots,
                                                                     opac, cam))
    n = xyz.shape[0]
    cap = int(jgs.max_valid_slots_per_gaussian(xyz, opac, scales, rots, cam, focal=12.0,
                                               size=size))
    comp = jgs._project_components(xyz, scales, rots, cam, 12.0, size)
    op = jnp.where(comp["in_front"], opac[..., 0], 0.0)
    tiles_x = size // jgs.GTILE_W
    num_tiles = (size // jgs.GTILE_H) * tiles_x
    rank_bits = max((n - 1).bit_length(), 1)
    perm = jnp.argsort(comp["depth"])
    mx, my, radius, op_s = (a[perm] for a in (comp["mx"], comp["my"], comp["radius"], op))
    tx, ty, valid = jgs._slot_validity(mx, my, radius, op_s, size)
    tile_id = jnp.where(valid, (ty * tiles_x + tx).astype(jnp.int32), num_tiles)
    tile_id = jgs._compact_slots(tile_id, tx, ty, mx, my, num_tiles, cap)
    rank = jax.lax.broadcasted_iota(jnp.int32, (tile_id.shape[0], n), 1)
    key = (tile_id << rank_bits) | rank
    sorted_key = jax.lax.sort(key.reshape(-1), is_stable=False)
    offsets = jnp.searchsorted(
        sorted_key, (jnp.arange(num_tiles + 1, dtype=jnp.int32) << rank_bits)).astype(jnp.int32)
    return np.asarray(sorted_key), np.asarray(offsets)


def test_gsplat_stages_equal_prepass_and_the_jax_key_sort():
    """S3's staged lists equal ``ops/gsplat.prepass``'s bit for bit; S2's
    sorted keys and offsets equal the JAX tool's key sort (its valid keys,
    the ones before the last offset) exactly."""
    size = 128
    xyz, colors, opac, scales, rots, cam = _small_scene()
    inst, offsets = profile_gsplat.staged("gather", xyz, scales, rots, opac, cam, size)
    _, _, want_inst, want_offsets = tgs.prepass(xyz, colors, opac, scales, rots, cam,
                                                focal=12.0, size=size)
    assert inst.dtype == torch.int32 and inst.numel() > xyz.shape[0]
    assert torch.equal(inst, want_inst) and torch.equal(offsets, want_offsets)

    sorted_key, s2_offsets = profile_gsplat.staged("sort", xyz, scales, rots, opac, cam, size)
    jax_keys, jax_offsets = _jax_tool_s2(xyz, scales, rots, opac, cam, size)
    np.testing.assert_array_equal(s2_offsets.numpy(), jax_offsets)
    np.testing.assert_array_equal(sorted_key.numpy(), jax_keys[:jax_offsets[-1]])
    assert torch.equal(s2_offsets, offsets)


def test_gsplat_tool_prints_the_stages_and_the_sanity_line(capsys):
    assert profile_gsplat.main(["--iters", "1", "--size", "128"], device="cpu",
                               config=2 * 32 * 32)
    out = capsys.readouterr().out
    assert out.startswith(f"device: cpu  n={5023 + 2 * 32 * 32}  instances=")
    assert _labels(out, r"^(S\d .*?)\s+[-\d.]+ ms$") == [
        "S0 projection + slot validity", "S1 + depth argsort + row permute",
        "S2 + instance-key sort + offsets", "S3 + instance gather",
        "S4 full rasterize (adds the splat kernel)"]
    assert _labels(out, r"^([a-z/+ ]+?)\s+[-\d.]+ ms$") == [
        "projection/validity", "argsort + row permute", "key sort + offsets",
        "instance gather", "compositing kernel"]
    assert "S3 sanity vs production prepass: OK" in out


# ----------------------------------------------------- the stage profilers


def test_pipeline_tool_prints_the_jax_tools_stages(capsys, monkeypatch, small_assets,
                                                   no_precision_env):
    monkeypatch.setattr(profile_pipeline, "IMAGE_SIZE", 64)
    profile_pipeline.main(["--iters", "1"], device="cpu", config=SMALL)
    out = capsys.readouterr().out
    assert out.startswith("device: cpu   iters: 1\n")
    window = SMALL.vae.window
    assert _labels(out, r"^\s*(\S.*?)\s+[\d.]+ ms$") == [
        "audio_condition (wav2vec, 1 window)", "audio_condition (batched 8 windows)",
        "-> batched encode per window", "decode_window (AR only, cond precomputed)",
        "VAE decode_from_bits (200-frame pair)", "VAE re-encode (encode_to_bits)",
        "full window_step (stream step)", f"savgol postprocess ({8 * window} frames)",
        f"FLAME motion_to_verts ({window} frames)", "-> per frame",
        "mesh render (25 frames, 64^2 Phong)", "-> per frame"]


def test_encoder_tool_prints_the_jax_tools_stages(capsys):
    profile_encoder.main(["--iters", "1", "--windows", "2", "--fused"], device="cpu",
                         config=SMALL)
    out = capsys.readouterr().out
    assert out.startswith("device: cpu   iters: 1   windows: 2\n")
    standard = ["full __call__", "conv feature extractor", "pos conv embed",
                "encode (proj + 24-layer stack)"]
    assert _labels(out, r"^(\S.*?)\s+[\d.]+ ms$") == standard + standard + [
        "full __call__ fused bf16 pack", "full __call__ fused int8 pack"]
    assert out.index("--- f32 (batched 2 windows) ---") < out.index("--- bf16")


def test_gaga_tool_prints_the_jax_tools_variants(capsys, monkeypatch):
    """The avatar shrunk as tests/test_torch_gagavatar.py shrinks it (128-px
    camera, small DINO and StyleUNet), one timed chunk per variant."""
    _shrink(monkeypatch, tavatar, tdino, tgen, tunet, tresize.resize_antialias, T_DINO)
    monkeypatch.setattr(profile_gaga, "ITERS", 1)
    ms = profile_gaga.main(["--k", "2"], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu  k=2"
    assert any(re.fullmatch(r"instances/gaussian=[\d.]+ \(frame 0 of the chunk\)", line)
               for line in out)
    rows = [line for line in out if "ms/chunk" in line]
    assert [r.split()[0] for r in rows] == ["full", "no-SR", "SR-only", "full-bf16"]
    assert list(ms) == ["full", "no-SR", "SR-only", "full-bf16"] and min(ms.values()) > 0


# --------------------------------------------------------------- the CLIs


@pytest.mark.parametrize("name", TOOLS)
def test_cli_without_cuda_exits_nonzero_before_any_work(name):
    """``python -m artalk_tpu_torch.tools.<name>`` here, with no card: a
    non-zero exit naming CUDA, nothing printed on stdout."""
    proc = subprocess.run([sys.executable, "-m", f"artalk_tpu_torch.tools.{name}"],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr and proc.stdout == ""
