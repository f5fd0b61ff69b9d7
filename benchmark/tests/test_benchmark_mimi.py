"""The Mimi cell shrunk to the CPU: its work model against torch's FLOP
counter, its readers on a synthetic layer data, a sound run correct and
runs with the encoder broken underneath not correct."""

import copy
import statistics
import time
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, run, work, work_mimi
from benchmark.drivers import stream_mimi_http
from benchmark.reference.params import make_params
from benchmark.reference.params_mimi import mimi_motion_spec
from benchmark.tests.small import SMALL_MODEL

WORKLOAD = "stream-mimi-int8-http"
SMALL_MIMI = {"sampling_rate": 24000, "num_filters": 8, "num_residual_layers": 1,
              "ratios": [8, 6, 5, 4], "kernel_size": 7, "last_kernel_size": 3,
              "residual_kernel_size": 3, "dilation_growth_rate": 2, "compress": 2,
              "hidden_size": 32, "num_hidden_layers": 2, "num_heads": 2, "head_dim": 16,
              "intermediate_size": 64, "codebook_size": 16, "codebook_dim": 8,
              "num_quantizers": 4, "num_semantic_quantizers": 1, "norm_eps": 1e-05,
              "rope_theta": 10000.0, "sliding_window": 16, "layer_scale": 0.01}
MODEL = dict({k: v for k, v in SMALL_MODEL.items() if k != "wav2vec"}, mimi=SMALL_MIMI,
             mimi_codebook_std=4e-4, ar=dict(SMALL_MODEL["ar"], audio_dim=32))
TRAFFIC = {"sessions": 4, "client_processes": 2, "chunk_seconds": 0.16, "period_s": 1.0,
           "phase_spread_s": 1.0}


def _model():
    from artalk_tpu_torch.utils.params import params_from_flat

    params = make_params(mimi_motion_spec(MODEL), 3, torch.device("cpu"))
    return params_from_flat({k: v.numpy() for k, v in params.items()},
                            stream_mimi_http.model_config(MODEL))


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("samples", [2560, 7681])
def test_mimi_flops(samples):
    model = _model()
    audio = torch.randn(2, samples, generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        assert _flops(lambda: model.audio_encoder(audio)) == \
            2 * work_mimi.mimi_window_work(SMALL_MIMI, samples).flops


def test_window_step_flops():
    model = _model()
    style = model.encode_style(None)
    state = model.initial_state(style)
    audio = torch.randn(1, model.window_samples, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert _flops(lambda: model.window_step(state, audio, style)) == \
            work_mimi.window_step_flops(MODEL, MODEL["window_samples"])


def test_mimi_work_at_the_published_widths():
    """23.2 GFLOP a 4-s window; bound by FLOPs at 140 rows."""
    config = harness.cell_files(WORKLOAD)[2]["model"]
    one = work_mimi.mimi_window_work(config["mimi"], config["window_samples"])
    assert 23.0e9 < one.flops < 23.3e9
    many = work_mimi.mimi_window_work(config["mimi"], config["window_samples"], rows=140)
    assert many.flops == 140 * one.flops
    assert many.bytes / work.HBM_BYTES_PER_S < many.flops / work.FP32_FLOP_PER_S


def _reader(name):
    return harness.load_module(harness.BENCH / "layer_metrics" / f"{name}.py", name)


def test_readers_read_a_synthetic_layer_data():
    config = harness.cell_files(WORKLOAD)[2]["model"]
    data = {"mimi_ms": [50.0, 70.0, 60.0], "model": config, "capacity": 140}
    assert _reader("mimi_ms_per_tick.stream").read(None, data, None, None) == 60.0
    bound = work_mimi.mimi_window_work(config["mimi"], 64000, rows=140).bound_s(67e12)
    roof = _reader("mimi_roofline.stream").read(None, data, None, None)
    assert roof == pytest.approx(100 * bound / 0.060)
    for name in ("mimi_ms_per_tick.stream", "mimi_roofline.stream"):
        assert _reader(name).read(None, dict(data, mimi_ms=[]), None, None) is None


def test_tick_device_time_sums_the_four_stages(monkeypatch):
    """``mimi_tick_ms`` sums a tick's four stage spans that carry
    ``device_us``, and leaves out a tick whose stages do not."""
    from artalk_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    monkeypatch.setattr(stream_mimi_http.program_spans, "registry", lambda: m)
    ticks = []
    for t, timed in enumerate((True, True, False)):
        with m.span("pool.tick") as tick:
            for k, name in enumerate(stream_mimi_http.STAGES):
                with m.span(name) as sp:
                    pass
                if timed:
                    sp.attrs["device_us"] = 1000 * (t + 1) + k
        ticks.append(tick)
    data = {"ticks": [types.SimpleNamespace(start=t.start_ns / 1e9 - 1e-6,
                                            end=t.end_ns / 1e9 + 1e-6) for t in ticks]}
    assert stream_mimi_http.mimi_tick_ms(data) == [4.006, 8.006]


def _context(seed, traffic=TRAFFIC):
    entry, cell, config = harness.cell_files(WORKLOAD)
    cell = copy.deepcopy(cell)
    cell["traffic"].update(traffic)
    args = types.SimpleNamespace(seed=seed, seconds=4.0, trace=0)
    return run.Context(args, entry, cell, dict(config, model=copy.deepcopy(MODEL)),
                       torch.device("cpu"))


def _run(seed=2**31 + 99):
    result, numbers = run.execute(_context(seed), time.perf_counter())
    return result, {n: v for n, v, _ in numbers}


def test_sound_run_is_correct_and_reads_its_spans():
    result, numbers = _run()
    assert result["correct"] and result["failed"] == 0, numbers
    assert numbers["chunks_checked"] > 0 and numbers["rvq_code_gap"] == 0.0


def test_small_run_layer_data():
    ctx = _context(2**31 + 5)
    state = stream_mimi_http.setup(ctx)
    enc = state["engine"].model.audio_encoder
    try:
        stream_mimi_http.window(ctx, state)
        data = stream_mimi_http.layer_data(ctx, state)
    finally:
        stream_mimi_http.release(state)
    assert data["mimi_ms"] == []                       # no device time on the CPU
    assert data["step_flops"] == work_mimi.window_step_flops(MODEL, MODEL["window_samples"])
    for name in ("pool_step_ms.stream", "step_mfu.stream", "front_ms.stream"):
        assert _reader(name).read(ctx, data, ctx.spans, None) > 0, name
    kept = state["taps"].kept
    assert set(kept) == state["rec"].sampled
    assert all(len(kept[s]) == len(state["rec"].steps[s]) for s in kept)
    assert statistics.mean(len(v) for v in kept.values()) >= 2
    assert not {"transform", "decode_codes"} & set(enc.__dict__)   # its own methods again


def _flip_codes(monkeypatch):
    from artalk_tpu_torch.models.mimi import MimiEncoder

    orig = MimiEncoder.quantize

    def quantize(self, emb):
        codes = orig(self, emb)
        codes[:, -1] = (codes[:, -1] + 1) % self.cfg.codebook_size
        return codes

    monkeypatch.setattr(MimiEncoder, "quantize", quantize)


def _perturb_transformer(monkeypatch):
    from artalk_tpu_torch.models.mimi import MimiEncoder

    orig = MimiEncoder.transform
    monkeypatch.setattr(MimiEncoder, "transform", lambda self, x: orig(self, x) * 1.01)


@pytest.mark.parametrize("fault", [_flip_codes, _perturb_transformer], ids=["codes", "emb"])
def test_broken_encoder_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, numbers = _run()
    assert not result["correct"], numbers

