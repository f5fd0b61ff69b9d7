"""The Whisper cell shrunk to the CPU: its manifest entries, its work models
against torch's FLOP counter, its readers on synthetic layer data, a sound
run correct and runs with the encoder or its context broken underneath not
correct."""

import copy
import statistics
import time
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, run, work, work_whisper
from benchmark.drivers import stream_whisper_http
from benchmark.reference.params import make_params
from benchmark.reference.params_whisper import whisper_motion_spec, whisper_spec
from benchmark.tests.small import SMALL_MODEL

WORKLOAD = "stream-whisper-int8-http"
SMALL_WHISPER = {"num_mel_bins": 16, "n_fft": 400, "hop_length": 160, "sampling_rate": 16000,
                 "chunk_length": 0.48, "d_model": 32, "encoder_layers": 2,
                 "encoder_attention_heads": 4, "encoder_ffn_dim": 64,
                 "max_source_positions": 24, "layer_norm_eps": 1e-05}
MODEL = dict({k: v for k, v in SMALL_MODEL.items() if k != "wav2vec"}, whisper=SMALL_WHISPER,
             ar=dict(SMALL_MODEL["ar"], audio_dim=32))
TRAFFIC = {"sessions": 4, "client_processes": 2, "chunk_seconds": 0.16, "period_s": 1.0,
           "phase_spread_s": 1.0}
STREAM_METRICS = ("front_ms", "pool_step_ms", "ar_stack_roofline", "step_mfu",
                  "device_idle_frac", "queue_wait_ms", "tick_gap_ms", "handler_self_ms",
                  "tick_offcpu_ms", "row_fill", "idle_encoding_frac")
NEW_METRICS = ("whisper_ms_per_tick.stream", "whisper_roofline.stream", "flash_roofline.stream")


def test_manifest_entries():
    man = harness.manifest()
    entry, cell, config = harness.cell_files(WORKLOAD)
    assert entry["chips"] == 1 and entry["config"] == "artalk-whisper-mesh"
    assert cell["driver"] == "stream_whisper_http" and config["reduced"] == []
    assert set(cell["limits"]) == {"ar_bit_gap", "carry_bit_gap", "motion_err",
                                   "whisper_emb_err", "mel_err"}
    by_name = {m["name"]: m for m in man["end_to_end"] + man["per_layer"]}
    for name in ("window_p95_ms", "window_p50_ms", *(f"{m}.stream" for m in STREAM_METRICS),
                 *NEW_METRICS):
        assert WORKLOAD in by_name[name]["workloads"], name
    for name in ("encoder_stack_roofline.stream", "features_ms_per_tick.stream",
                 "mimi_ms_per_tick.stream", "mimi_roofline.stream"):
        assert WORKLOAD not in by_name[name]["workloads"], name
    for name in NEW_METRICS:
        assert by_name[name]["workloads"] == [WORKLOAD]
        assert by_name[name]["moves"] == "window_p95_ms"
    m = config["model"]
    assert m["whisper"]["d_model"] == m["ar"]["audio_dim"] == 1280
    assert config["parameters"] == sum(
        torch.Size(shape).numel() for _, shape, _ in whisper_motion_spec(m))
    # Whisper large-v3's encoder alone: the published 635,048,960
    assert sum(torch.Size(shape).numel() for _, shape, _ in whisper_spec(m["whisper"])) \
        == 635_048_960


def _model():
    from artalk_tpu_torch.utils.params import params_from_flat

    params = make_params(whisper_motion_spec(MODEL), 3, torch.device("cpu"))
    return params_from_flat({k: v.numpy() for k, v in params.items()},
                            stream_whisper_http.model_config(MODEL))


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("rows", [1, 3])
def test_whisper_flops(rows):
    model = _model()
    audio = torch.randn(rows, 7680, generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        assert _flops(lambda: model.audio_encoder(audio)) == \
            work_whisper.whisper_window_work(SMALL_WHISPER, rows=rows).flops


def test_window_step_flops():
    model = _model()
    style = model.encode_style(None)
    state = model.initial_state(style)
    audio = torch.randn(1, model.window_samples, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert _flops(lambda: model.window_step(state, audio, style)) == \
            work_whisper.window_step_flops(MODEL, MODEL["window_samples"])


def test_flash_work_counts_the_attention_products():
    """The plain attention's two products per layer are the kernel's
    operations with P V once; the kernel's convention counts P V twice."""
    from artalk_tpu_torch.ops.attention import flash_attention

    s = work_whisper.shapes(SMALL_WHISPER)
    q = torch.randn(2, 4, s["positions"], s["head_dim"])
    counted = _flops(lambda: flash_attention(q, q, q, scale=0.125))
    assert work_whisper.flash_work(SMALL_WHISPER, rows=2).flops == counted * 6 // 4


def test_whisper_work_at_the_published_widths():
    """2.27 TFLOP a 30-s context (1.89 in the layers' products, 0.37 in
    attention), bound by FLOPs at any batch; the flash kernel's attention is
    bound by its FLOPs too."""
    w = harness.cell_files(WORKLOAD)[2]["model"]["whisper"]
    one = work_whisper.whisper_window_work(w)
    assert 2.26e12 < one.flops < 2.28e12
    assert 0.36e12 < 32 * work_whisper.flash_work(w, 1).flops * 4 / 6 < 0.38e12
    many = work_whisper.whisper_window_work(w, rows=160)
    assert many.flops == 160 * one.flops
    assert many.bytes / work.HBM_BYTES_PER_S < many.flops / work.BF16_FLOP_PER_S
    flash = work_whisper.flash_work(w, 160)
    assert flash.bytes / work.HBM_BYTES_PER_S < flash.flops / work.BF16_FLOP_PER_S


def _reader(name):
    return harness.load_module(harness.BENCH / "layer_metrics" / f"{name}.py", name)


class _Trace:
    def __init__(self, seconds, launches):
        self.result = (seconds, launches)

    def kernel_s(self, names):
        assert names == ["flash_kernel", "flash_split_kernel"]
        return self.result


def test_readers_read_synthetic_layer_data():
    config = harness.cell_files(WORKLOAD)[2]["model"]
    data = {"whisper_ms": [500.0, 700.0, 600.0], "model": config, "capacity": 160,
            "traced_ticks": 3}
    assert _reader("whisper_ms_per_tick.stream").read(None, data, None, None) == 600.0
    bound = work_whisper.whisper_window_work(config["whisper"], rows=160).bound_s(989e12)
    roof = _reader("whisper_roofline.stream").read(None, data, None, None)
    assert roof == pytest.approx(100 * bound / 0.600)
    for name in ("whisper_ms_per_tick.stream", "whisper_roofline.stream"):
        assert _reader(name).read(None, dict(data, whisper_ms=[]), None, None) is None
    flash = _reader("flash_roofline.stream")
    one = work_whisper.flash_work(config["whisper"], 160).bound_s(989e12)
    assert flash.read(None, data, None, _Trace(2.0, 96)) == pytest.approx(100 * 96 * one / 2.0)
    assert flash.read(None, data, None, _Trace(2.0, 95)) is None      # not 32 a tick
    assert flash.read(None, data, None, _Trace(0.0, 0)) is None
    assert flash.read(None, data, None, None) is None
    xlsr = harness.cell_files("stream-int8-http")[2]["model"]
    assert flash.read(None, dict(data, model=xlsr), None, _Trace(2.0, 96)) is None


def test_tick_device_time_sums_the_three_stages(monkeypatch):
    """``whisper_tick_ms`` sums a tick's three stage spans that carry
    ``device_us``, and leaves out a tick whose stages do not."""
    from artalk_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    monkeypatch.setattr(stream_whisper_http.program_spans, "registry", lambda: m)
    ticks = []
    for t, timed in enumerate((True, True, False)):
        with m.span("pool.tick") as tick:
            for k, name in enumerate(stream_whisper_http.STAGES):
                with m.span(name) as sp:
                    pass
                if timed:
                    sp.attrs["device_us"] = 1000 * (t + 1) + k
        ticks.append(tick)
    data = {"ticks": [types.SimpleNamespace(start=t.start_ns / 1e9 - 1e-6,
                                            end=t.end_ns / 1e9 + 1e-6) for t in ticks]}
    assert stream_whisper_http.whisper_tick_ms(data) == [3.003, 6.003]


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


def test_sound_run_is_correct():
    """The cell runs int8: Whisper's stem and layers in bfloat16, its
    log-mel front in float32."""
    result, numbers = _run()
    assert result["correct"] and result["failed"] == 0, numbers
    assert numbers["chunks_checked"] > 0
    assert numbers["mel_err"] <= 1e-5 < numbers["whisper_emb_err"], numbers


def test_small_run_layer_data():
    ctx = _context(2**31 + 5)
    state = stream_whisper_http.setup(ctx)
    enc = state["engine"].model.audio_encoder
    try:
        stream_whisper_http.window(ctx, state)
        data = stream_whisper_http.layer_data(ctx, state)
    finally:
        stream_whisper_http.release(state)
    assert data["whisper_ms"] == []                    # no device time on the CPU
    assert data["step_flops"] == work_whisper.window_step_flops(MODEL, MODEL["window_samples"])
    for name in ("pool_step_ms.stream", "step_mfu.stream", "front_ms.stream"):
        assert _reader(name).read(ctx, data, ctx.spans, None) > 0, name
    for name in NEW_METRICS:
        assert _reader(name).read(ctx, data, ctx.spans, None) is None, name
    kept = state["taps"].kept
    assert set(kept) == state["rec"].sampled
    assert all(len(kept[s]) == len(state["rec"].steps[s]) for s in kept)
    assert statistics.mean(len(v) for v in kept.values()) >= 2
    assert not {"log_mel", "forward"} & set(enc.__dict__)     # its own methods again


def _drop_positions(monkeypatch):
    from artalk_tpu_torch.models.whisper import WhisperEncoder

    orig = WhisperEncoder.stem
    monkeypatch.setattr(WhisperEncoder, "stem",
                        lambda self, mel: (lambda x: x - self.positions.to(x.dtype))(
                            orig(self, mel)))


def _forget_context(monkeypatch):
    from artalk_tpu_torch.models.ar_model import BitwiseARModel

    orig = BitwiseARModel.roll_audio_ctx
    monkeypatch.setattr(BitwiseARModel, "roll_audio_ctx",
                        lambda self, ctx, chunk: torch.zeros_like(orig(self, ctx, chunk)))


@pytest.mark.parametrize("fault", [_drop_positions, _forget_context],
                         ids=["positions", "context"])
def test_broken_encoder_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, numbers = _run()
    assert not result["correct"], numbers
