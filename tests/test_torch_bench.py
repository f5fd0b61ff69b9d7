"""The port's bench (``artalk_tpu_torch.bench``) and its two helpers,
``utils/timing`` and ``utils/roofline``, on the CPU.

The bench's CLI contract as ``tests/test_bench_cli.py`` holds ``bench.py``'s
(an unknown section is rejected before any device work), no fallback without
CUDA, ``run`` at a small config returning exactly each section's keys, a
failing section costing only its own keys and the exit code, ``count``'s
launch check, and the kernels' work models: FLOPs equal to torch's counter
over the plain block stacks at a narrow width, and the bounds of PERF.md's
kernel table at the production shapes."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from artalk_tpu_torch import bench
from artalk_tpu_torch.models.ar_model import BitwiseARModel
from artalk_tpu_torch.ops import ar_block_stack as ar_stack
from artalk_tpu_torch.ops import encoder_block_stack as enc_stack
from artalk_tpu_torch.ops import rasterizer
from artalk_tpu_torch.utils import roofline, timing

from test_ar_fused import CFG
from test_torch_params import torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = torch_config(CFG)
# the keys of each section, as the JAX bench names them
KEYS = {
    "motion": {"value", "real_time_factor", "windows", "clip_e2e_latency_ms", "motion_mfu",
               "motion_membw_frac", "motion_gflop_per_call", "motion_gb_per_call"},
    "stream": {"stream_p50_ms", "stream_spread_ms"},
    "mesh": {"mesh_ms_per_frame", "mesh_spread_ms", "mesh_mfu", "mesh_membw_frac",
             "mesh_gflop_per_call", "mesh_gb_per_call"},
    "gsplat": {"gsplat_ms_per_frame", "gsplat_spread_ms", "gsplat_mfu", "gsplat_membw_frac",
               "gsplat_gflop_per_call", "gsplat_gb_per_call"},
    "batched": {"batched6_frames_per_sec"},
    "gaga": {"gaga_ms_per_frame", "gaga_spread_ms", "gaga_mfu", "gaga_membw_frac",
             "gaga_gflop_per_call", "gaga_gb_per_call"},
    "fast": {"motion_fast_frames_per_sec"},
    "fused": {"motion_fused_frames_per_sec"},
    "fusedx": {"motion_fusedx_frames_per_sec"},
    "fstream": {"stream_fused_p50_ms", "stream_fused_spread_ms"},
    "int8": {"motion_int8_frames_per_sec", "stream_int8_p50_ms", "stream_int8_spread_ms"},
}
CPU_SECTIONS = ("motion", "stream", "batched", "fast", "fused", "fusedx", "fstream", "int8")
BASE_KEYS = {"metric", "value", "unit", "device"}


def _module_main(code_before: str, env: dict) -> subprocess.CompletedProcess:
    """``python -m artalk_tpu_torch.bench`` with ``code_before`` run first."""
    code = code_before + "; import runpy; runpy.run_module('artalk_tpu_torch.bench', " \
                         "run_name='__main__', alter_sys=True)"
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, **env}, cwd=REPO)


def test_unknown_section_rejected_before_any_device_work():
    """A typo'd section exits non-zero naming it and the known list, before
    the bench asks whether there is a card (asking raises here)."""
    proc = _module_main("import torch; torch.cuda.is_available = lambda: 1 / 0",
                        {"ARTALK_BENCH_SECTIONS": "gpslat, mesh"})
    assert proc.returncode != 0
    err = proc.stdout + proc.stderr
    assert "gpslat" in err and "known: " + ",".join(bench.KNOWN_SECTIONS) in err
    assert "ZeroDivisionError" not in err


def test_cli_without_cuda_exits_nonzero_naming_cuda():
    proc = subprocess.run([sys.executable, "-m", "artalk_tpu_torch.bench"], capture_output=True,
                          text=True, timeout=300, cwd=REPO,
                          env={**os.environ, "ARTALK_BENCH_SECTIONS": "stream"})
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and proc.stdout == ""


def test_section_keys_are_the_jax_benchs():
    assert bench.KNOWN_SECTIONS == tuple(KEYS)
    assert {name: set(keys) for name, keys in bench.SECTION_KEYS.items()} == KEYS


def test_run_small_config_returns_each_sections_keys():
    """Every CPU section at the small config: exactly its keys, all finite
    and positive; the fused sections' launch checks hold with no launch (the
    plain versions run)."""
    out = bench.run(CPU_SECTIONS, "cpu", config=SMALL, repeats=2)
    want = set().union(*(KEYS[s] for s in CPU_SECTIONS))
    assert set(out) == BASE_KEYS | want, set(out) ^ (BASE_KEYS | want)
    assert out["metric"] == "motion_frames_per_sec" and out["unit"] == "frames/s"
    assert out["device"] == {"name": "cpu", "power_limit": None}
    assert out["windows"] == bench.MOTION_WINDOWS
    for key in want:
        assert isinstance(out[key], (int, float)) and math.isfinite(out[key]) and out[key] > 0, key
    assert math.isclose(out["real_time_factor"], out["value"] / SMALL.fps)


def test_failing_section_costs_its_keys_and_the_exit_code(monkeypatch, capsys):
    """A section that raises fills errors[name]; the others' keys stay; the
    CLI prints the line last and exits 1."""
    def broken(*args):
        raise RuntimeError("planted")

    real_run = bench.run
    monkeypatch.setattr(bench, "bench_batched", broken)
    monkeypatch.setattr(bench, "run", lambda sections, device: real_run(
        sections, "cpu", config=SMALL, repeats=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("ARTALK_BENCH_SECTIONS", "batched,stream")
    assert bench.main() == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)
    assert out["errors"] == {"batched": "RuntimeError: planted"}
    assert KEYS["stream"] <= set(out) and not KEYS["batched"] & set(out)


def test_count_checks_launches_and_counts_aten_work():
    """``count``: an (m, k) @ (k, n) product is 2mkn FLOPs and its operands'
    and result's bytes; a declared launch that did not happen (a wrapper that
    fell back to its plain version) raises, as does one not declared."""
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    work = roofline.count(lambda: a @ b)
    assert work == roofline.Work(2 * 3 * 5 * 7, (15 + 35 + 21) * 4)
    kernel = roofline.Work(10.0, 20.0)
    with pytest.raises(RuntimeError, match="declared"):
        roofline.count(lambda: a @ b, {"ar_block_stack": (5, kernel)})

    def launch():
        rasterizer.LIB.count()

    assert roofline.count(launch, {"rasterize": (1, kernel)}) == kernel
    with pytest.raises(RuntimeError, match="declared"):
        roofline.count(launch)


def test_fused_sections_declare_their_launches(monkeypatch):
    """On the card a fused section declares 5 AR and 1 encoder launch a
    window; a plain-path run of the same generate (what a wrapper that
    skipped its kernel gives) fails that check."""
    model = BitwiseARModel(SMALL).init(torch.Generator().manual_seed(0))
    with bench.precision(model, fused_ar=True):
        kernels = bench.decode_kernels(model, 8)
        assert {k: n for k, (n, _) in kernels.items()} == {
            "ar_block_stack": 8 * len(model.patch_nums), "encoder_block_stack": 8}
        monkeypatch.setattr(bench, "_count",
                            lambda dev, fn, kernels: roofline.count(fn, kernels()))
        with pytest.raises(RuntimeError, match="declared"):
            bench.bench_stream(model, torch.device("cpu"), repeats=1)
    assert model.cfg == SMALL and model.fused_pack is None
    assert bench.decode_kernels(model, 8) == {}


def test_bf16_sections_declare_the_conv_front():
    """In the bf16 modes a section also declares one conv-front launch a
    conv of every window (``ops/conv_frontend.py``), with its work."""
    model = BitwiseARModel(SMALL).init(torch.Generator().manual_seed(0))
    convs = len(SMALL.wav2vec.conv_dim) + 1
    for fields, stacks in (({}, {}), ({"fused_ar": True}, {
            "ar_block_stack": 8 * len(model.patch_nums), "encoder_block_stack": 8})):
        with bench.precision(model, bf16_audio=True, bf16_ar=True, **fields):
            kernels = bench.decode_kernels(model, 8)
            assert {k: n for k, (n, _) in kernels.items()} == {"conv_frontend": 8 * convs,
                                                               **stacks}
            want = roofline.conv_frontend_work(SMALL.wav2vec, model.window_samples, 1) * 8
            assert kernels["conv_frontend"][1] == want and want.flops > 0
    assert bench.decode_kernels(model, 8) == {}


def test_pipelined_ms_median_and_spread():
    calls = []
    ms, spread = timing.pipelined_ms(lambda i, prev: calls.append((i, prev)) or i, 3,
                                     repeats=3, device="cpu")
    assert len(calls) == 1 + 3 * 3 and calls[0] == (0, None) and calls[2] == (1, 0)
    assert ms > 0 and spread >= 0


def _ar_inputs(model, level, dtype):
    g = torch.Generator().manual_seed(level)
    d, pn = model.embed_dim, model.patch_nums[level]
    start = model.prev_len + model.offsets[level]
    x = torch.randn((1, pn, d), generator=g)
    ada = torch.randn((model.depth, 1, pn, 6 * d), generator=g) * 0.1
    kc = torch.randn((model.depth, 1, model.cache_len, d), generator=g).to(dtype)
    return x, ada, kc, kc.clone(), start


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_ar_level_work_matches_the_flop_counter(dtype):
    """``ar_level_work``'s FLOPs equal torch's counter over
    ``ar_block_stack_plain`` at a narrow width within 1 % at every level; its
    bytes count the pack as built. Both leave out the LayerNorms, the AdaLN
    modulation, q/k L2 normalisation, softmax, GELU, the gated residuals and
    the bias adds: the model counts products only."""
    model = BitwiseARModel(SMALL).init(torch.Generator().manual_seed(0))
    pack = ar_stack.pack_block_weights(model.blocks, model.num_heads, dtype)
    hidden = pack["wfc1"].shape[-1]
    assert sum(t.numel() * t.element_size() for t in pack.values()) == roofline.pack_bytes(
        model.depth, model.embed_dim, hidden, dtype,
        5 * model.embed_dim + hidden + model.num_heads)
    cache = torch.float32 if dtype == torch.float32 else torch.bfloat16
    for level, pn in enumerate(model.patch_nums):
        x, ada, kc, vc, start = _ar_inputs(model, level, cache)
        counter = FlopCounterMode(display=False)
        with counter:
            ar_stack.ar_block_stack_plain(x, ada, pack, kc, vc, start=start,
                                          num_heads=model.num_heads)
        work = roofline.ar_level_work(model.depth, model.embed_dim, hidden, model.num_heads,
                                      pn, start, dtype, cache.itemsize)
        assert math.isclose(work.flops, counter.get_total_flops(), rel_tol=0.01), level


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_encoder_window_work_matches_the_flop_counter(dtype):
    """``encoder_window_work``'s FLOPs equal torch's counter over
    ``encoder_block_stack_plain`` at a narrow width within 1 %; its bytes
    count the pack as built. Both leave out the LayerNorms, softmax, GELU,
    the residuals and the bias adds."""
    model = BitwiseARModel(SMALL).init(torch.Generator().manual_seed(0))
    w2v = SMALL.wav2vec
    pack = model.audio_encoder.pack_fused(dtype)
    assert sum(t.numel() * t.element_size() for t in pack.values()) == roofline.pack_bytes(
        w2v.num_hidden_layers, w2v.hidden_size, w2v.intermediate_size, dtype,
        9 * w2v.hidden_size + w2v.intermediate_size)
    frames = w2v.num_output_frames(model.window_samples)
    x = torch.randn((1, frames, w2v.hidden_size), generator=torch.Generator().manual_seed(1))
    counter = FlopCounterMode(display=False)
    with counter:
        enc_stack.encoder_block_stack_plain(x, pack, num_heads=w2v.num_attention_heads)
    work = roofline.encoder_window_work(w2v.num_hidden_layers, w2v.hidden_size,
                                        w2v.intermediate_size, frames, dtype)
    assert math.isclose(work.flops, counter.get_total_flops(), rel_tol=0.01)


# PERF.md's kernel table: the bound column as chip_smoke.py prints it (4
# decimals; the table gives the AR int8 bound's 0.1535 as 0.154)
AR_WINDOW_BOUND = {torch.float32: "0.5464", torch.bfloat16: "0.2796", torch.int8: "0.1535"}
ENCODER_BOUND = {torch.float32: "0.7520", torch.bfloat16: "0.1812", torch.int8: "0.1255"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_work_models_reproduce_the_production_bounds(dtype):
    """At the production shapes (AR 12 x 768, 12 heads, hidden 3072, pn 1 ..
    100 after a 181-token prefix; encoder 24 x 1024, hidden 4096, 199
    frames) the bounds are PERF.md's: per window the larger of bytes and
    operations, summed over the levels."""
    patch_nums, prefix = (1, 5, 25, 50, 100), 181
    cache_bytes = 4 if dtype == torch.float32 else 2
    ar = 0.0
    for level, pn in enumerate(patch_nums):
        work = roofline.ar_level_work(12, 768, 3072, 12, pn, prefix + sum(patch_nums[:level]),
                                      dtype, cache_bytes)
        ar += max(roofline.bytes_ms(work.bytes), roofline.matmul_ms(work.flops, dtype))
    assert f"{ar:.4f}" == AR_WINDOW_BOUND[dtype]
    enc = roofline.encoder_window_work(24, 1024, 4096, 199, dtype)
    enc_ms = max(roofline.bytes_ms(enc.bytes), roofline.matmul_ms(enc.flops, dtype))
    assert f"{enc_ms:.4f}" == ENCODER_BOUND[dtype]


def test_sort_and_splat_bounds_at_the_avatar_frame():
    """The sort of the avatar frame's 879,296 keys: 0.00210 ms; the splat of
    its 21,005,706 composites: 0.0254 ms (operations)."""
    assert f"{roofline.bytes_ms(roofline.sort_work(879_296).bytes):.5f}" == "0.00210"
    splat = roofline.splat_work(180_255, 4, 879_296, 129, 512, 21_005_706)
    assert f"{roofline.fp32_ms(splat.flops):.4f}" == "0.0254"
    assert roofline.bytes_ms(splat.bytes) < roofline.fp32_ms(splat.flops)
