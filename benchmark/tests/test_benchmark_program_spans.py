"""The readers of the program's own spans (``benchmark/program_spans.py``
and the per-layer metrics built on it) on the small CPU runs of
``benchmark/tests/small.py``: each reads a number from a run, none from an
empty ring, a ring that dropped spans or a program that records no spans;
the offset to the trace's clock pairs each span with its range."""

import threading
import time
import types

import pytest
import torch

from benchmark import harness, program_spans

STREAM = ["queue_wait_ms.stream", "tick_gap_ms.stream", "handler_self_ms.stream",
          "tick_offcpu_ms.stream", "row_fill.stream"]
SMALL_RUNS = {
    "mesh-offline-exact": ({"clip_seconds": [0.2, 1.0], "strata": 4}, 1.0,
                           ["ar_decode_ms_per_window.offline"]),
    "stream-int8-http": ({"sessions": 4, "client_processes": 2, "chunk_seconds": 0.16,
                          "period_s": 1.0, "phase_spread_s": 1.0}, 4.0, STREAM),
}


def reader(name: str):
    return harness.load_module(harness.BENCH / "layer_metrics" / f"{name}.py", f"lm_{name}")


def registry():
    from artalk_tpu_torch.utils.metrics import GLOBAL_METRICS
    return GLOBAL_METRICS


@pytest.fixture(scope="module", params=sorted(SMALL_RUNS))
def small_run(request):
    from benchmark.tests.small import small_context

    workload = request.param
    traffic, seconds, names = SMALL_RUNS[workload]
    registry().reset()
    ctx = small_context(workload, seed=2**31 + 9, seconds=seconds, traffic=traffic)
    driver = harness.load_module(harness.BENCH / "drivers" / f"{ctx.cell['driver']}.py",
                                 "driver_small_spans")
    state = driver.setup(ctx)
    try:
        driver.window(ctx, state)
        data = driver.layer_data(ctx, state)
    finally:
        driver.release(state)
    return ctx, data, names, list(registry()._ring)


def test_readers_read_a_small_run(small_run):
    ctx, data, names, _ = small_run
    for name in names:
        value = reader(name).read(ctx, data, ctx.spans, None)
        assert value is not None and value > 0, name
    assert reader("idle_encoding_frac.stream").read(ctx, data, ctx.spans, None) is None
    if "row_fill.stream" in names:
        # 4 sessions, each chunk alone or with a few others in a tick of 4 rows
        assert 0 < reader("row_fill.stream").read(ctx, data, ctx.spans, None) <= 1
        ticks = program_spans.stream_ticks(data)
        assert len(ticks) <= len(data["ticks"])
        assert all(t.attrs["rows_stepped"] == 4 for t in ticks)


def test_readers_read_nothing_without_spans(small_run, monkeypatch):
    ctx, data, names, kept = small_run
    reg = registry()
    reg.reset()
    try:
        for name in names:
            assert reader(name).read(ctx, data, ctx.spans, None) is None, name
        # a ring that dropped spans
        reg._ring.extend(kept)
        monkeypatch.setattr(reg, "spans_dropped", lambda: 1)
        for name in names:
            assert reader(name).read(ctx, data, ctx.spans, None) is None, name
        # a program whose registry records no spans (the parent commit's)
        monkeypatch.undo()
        monkeypatch.delattr(type(reg), "spans")
        assert program_spans.registry() is None
        for name in names:
            assert reader(name).read(ctx, data, ctx.spans, None) is None, name
    finally:
        monkeypatch.undo()
        reg.reset()


def _traced(work):
    """(tracer, harness.Trace) of ``work`` run under the CPU profiler."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.__enter__()
    t0 = harness.clock()
    try:
        # the profiler's first range pays its set-up (the harness's own
        # range comes first in a traced run)
        with torch.profiler.record_function("warm"):
            pass
        work()
    finally:
        t1 = harness.clock()
        prof.__exit__(None, None, None)
    path = harness.BENCH / "_cache" / f"spans_trace_{threading.get_ident()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        trace_events = harness.load_json(path)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return types.SimpleNamespace(t0=t0), trace_events, t0, t1


def test_offset_pairs_each_span_with_its_range():
    reg = registry()
    reg.reset()

    def work():
        for i in range(20):
            with reg.span("pool.tick", tick=i):
                with reg.span("pool.download"):
                    time.sleep(0.001)

    tracer, events, t0, t1 = _traced(work)
    trace = harness.Trace(events, t0, t1)
    found = program_spans.trace_offset(tracer, trace)
    assert found is not None and found["pairs"] == 40
    spans = {n: [sp.start_ns for sp in reg.spans(n)] for n in ("pool.tick", "pool.download")}
    ranges = {n: sorted(s for name, s, _ in trace.ranges if name == n) for n in spans}
    for n in spans:
        for s, r in zip(spans[n], ranges[n]):
            assert abs((r - s) - found["offset_ns"]) < 0.2e6       # 0.2 ms
    assert found["spread_ns"] < 0.4e6
    reg.reset()


def test_idle_encoding_share_on_a_synthetic_trace():
    """Kernels over the ticks, a request thread encoding between them: the
    share of idle time inside ``http.encode`` is the encode's length over
    the idle time, on the trace's clock."""
    reg = registry()
    reg.reset()

    def encode():
        with reg.span("http.encode", request=1, sid=0):
            time.sleep(0.02)

    def work():
        for i in range(3):
            with reg.span("pool.tick", tick=i):
                time.sleep(0.01)
            if i == 1:
                t = threading.Thread(target=encode)
                t.start()
                t.join(timeout=10)

    tracer, events, t0, t1 = _traced(work)
    ticks = [e for e in events if e.get("name") == "pool.tick" and e.get("ph") == "X"]
    kernels = [dict(e, cat="kernel", name="k") for e in ticks]
    trace = harness.Trace(events + kernels, t0, t1)
    data = {"ticks": []}
    ctx = types.SimpleNamespace(tracer=tracer)
    value = reader("idle_encoding_frac.stream").read(ctx, data, None, trace)
    (enc,) = reg.spans("http.encode")
    idle_ns = trace.window_s * 1e9 - trace.busy_s() * 1e9
    assert 0 < value < 1
    assert value == pytest.approx(enc.duration_ns / idle_ns, rel=0.05)
    assert reader("idle_encoding_frac.stream").read(ctx, data, None, None) is None
    reg.reset()


def test_avatar_share_reads_the_clips(monkeypatch):
    """``avatar_ms_per_frame.offline`` sums the ``gaga.avatar`` spans inside
    each clip (a span outside every clip, as in the traced one, is left
    out) over the clips' frames."""
    reg = registry()
    reg.reset()
    clips = []
    for ms in (30, 10, 20):
        t0 = harness.clock()
        with reg.span("gaga.avatar"):
            time.sleep(ms / 1e3)
        clips.append({"t0": t0, "t1": harness.clock(), "frames": 50})
    kept = [clips[0], clips[2]]
    value = reader("avatar_ms_per_frame.offline").read(
        None, {"clips": kept, "frames": 100}, None, None)
    spans = reg.spans("gaga.avatar")
    want = (spans[0].duration_ns + spans[2].duration_ns) / 1e6 / 100
    assert value == pytest.approx(want)
    reg.reset()
    assert reader("avatar_ms_per_frame.offline").read(
        None, {"clips": kept, "frames": 100}, None, None) is None
