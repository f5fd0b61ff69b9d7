"""The end-to-end arithmetic: latency from the due time with failures at
+inf, the frame rate over a window that ends inside a clip."""

import math
import types

import numpy as np
import pytest

from benchmark import harness


def test_percentile_counts_failures_as_missing_the_limit():
    ok = [100.0, 200.0, 300.0, 400.0]
    assert harness.percentile(ok, 50) == 250.0
    lat = ok * 5 + [math.inf]                 # 1 failure in 21
    assert math.isfinite(harness.percentile(lat, 95))
    lat = ok * 5 + [math.inf] * 2             # 2 failures in 22: the 95th is one
    assert harness.percentile(lat, 95) == math.inf
    assert harness.percentile([], 50) == math.inf


def test_percentile_interpolates_between_order_statistics():
    v = list(np.random.default_rng(0).random(101) * 1000)
    assert np.isclose(harness.percentile(v, 95), np.percentile(v, 95))
    assert np.isclose(harness.percentile(v, 50), np.median(v))


def test_stream_latency_runs_from_the_due_time(monkeypatch):
    from benchmark.drivers import stream_http

    # (session, k, due, sent, done, status, frames): late sends still count from due
    chunks = [[0, 0, 10.0, 10.0, 11.0, 200, 100], [0, 1, 14.0, 15.0, 15.5, 200, 100],
              [1, 0, 12.0, 12.0, 12.2, 504, 0]]
    proc = types.SimpleNamespace(stdin=types.SimpleNamespace(write=lambda s: None,
                                                             flush=lambda: None),
                                 stdout=types.SimpleNamespace(readline=lambda: _line(chunks)),
                                 wait=lambda timeout=None: 0)
    ctx = types.SimpleNamespace(seconds=8.0, tracer=harness.Tracer(False, 1.0))
    state = {"clients": [proc], "rec": stream_http.Recorder()}
    out = stream_http.window(ctx, state)
    lat = sorted([1000.0, 1500.0, math.inf])
    assert out["attempted"] == 3 and out["failed"] == 1
    assert out["metrics"]["window_p50_ms"] == harness.percentile(lat, 50) == 1500.0
    assert out["metrics"]["window_p95_ms"] == math.inf


def _line(chunks):
    import json
    return json.dumps({"chunks": chunks, "motions": {}})


def test_frame_rate_counts_the_clip_in_flight_at_the_deadline(monkeypatch):
    from benchmark.drivers import offline

    clock = {"t": 0.0}
    monkeypatch.setattr(harness, "clock", lambda: clock["t"])

    def render(ctx, state, audio):                # each clip: 0.75 s a second of audio
        clock["t"] += len(audio) / 16000 * 0.75
        return np.zeros((len(audio) // 640, 106), np.float32), np.zeros((len(audio) // 640, 6, 4))

    monkeypatch.setattr(offline, "render_clip", render)
    clips = [np.zeros(16000 * s, np.float32) for s in (4, 2, 3)]
    ctx = types.SimpleNamespace(seconds=5.0, seed=1, tracer=harness.Tracer(False, 1.0),
                                model={"vae": {"patch_nums": [1, 5, 25, 50, 100]},
                                       "sample_rate": 16000, "fps": 25})
    state = {"clips": clips, "cap": offline.Capture()}
    out = offline.window(ctx, state)
    # clips of 3.0, 1.5 and 2.25 s: the third starts at 4.5 s, inside the
    # window, and ends at 6.75 s; all 225 frames count over 6.75 s
    assert out["attempted"] == 3
    assert out["metrics"]["frames_per_s"] == (100 + 50 + 75) / 6.75


SMALL_RUNS = {
    "mesh-offline-exact": ({"clip_seconds": [0.2, 1.0], "strata": 4}, 1.0,
                           ["decode_ms_per_window.offline", "mesh_ms_per_frame.offline",
                            "mfu.offline"]),
    "stream-int8-http": ({"sessions": 4, "client_processes": 2, "chunk_seconds": 0.16,
                          "period_s": 1.0, "phase_spread_s": 1.0}, 4.0,
                         ["front_ms.stream", "pool_step_ms.stream", "step_mfu.stream"]),
}


@pytest.mark.parametrize("workload", sorted(SMALL_RUNS))
def test_span_readers_read_a_small_run(workload):
    """The readers that take spans find one record per call of the window
    and give a positive number; the trace's readers give none untraced."""
    from benchmark.tests.small import small_context

    traffic, seconds, names = SMALL_RUNS[workload]
    ctx = small_context(workload, seed=2**31 + 5, seconds=seconds, traffic=traffic)
    driver = harness.load_module(harness.BENCH / "drivers" / f"{ctx.cell['driver']}.py",
                                 "driver_small")
    state = driver.setup(ctx)
    try:
        driver.window(ctx, state)
        data = driver.layer_data(ctx, state)
    finally:
        driver.release(state)
    for name in names:
        mod = harness.load_module(harness.BENCH / "layer_metrics" / f"{name}.py", name)
        value = mod.read(ctx, data, ctx.spans, None)
        assert value is not None and value > 0, name
    if workload.startswith("stream"):
        # one span per step and per submit, each with what its hook read
        steps = ctx.spans.of("pool.step", since=state["start"])
        assert steps and all(len(t.info) == 2 for t in steps)
        submits = ctx.spans.of("batcher.submit", since=state["start"])
        assert {sp.info for sp in submits} <= set(state["sids"])
        assert len(data["fronts"]) == sum(1 for c in state["chunks"] if c[5] == 200)
    for name in ("device_idle_frac.offline", "ar_stack_roofline.stream"):
        mod = harness.load_module(harness.BENCH / "layer_metrics" / f"{name}.py", name)
        assert mod.read(ctx, data, ctx.spans, None) is None
