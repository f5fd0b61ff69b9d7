"""The span recorder of ``artalk_tpu_torch/utils/metrics.py`` on the CPU.

Spans nest by thread (parent ids, per-thread stacks), carry their
attributes, read CPU time (where asked) no larger than their wall time, and stay in a
bounded ring that counts what it dropped; a span recorded from stamps taken
elsewhere joins the ring as it is. A stage keeps its count and a bounded
window of durations. A span opens a profiler range only on a thread the
running profiler records (and a span already open when it started gets its
range with its first child); on any other thread it still reaches the ring.
Under ``torch.export`` a span records nothing, and the exported window step
holds no profiler op, even with a profiler running."""

import threading
import time

import pytest
import torch

from artalk_tpu_torch import export_model
from artalk_tpu_torch.models.ar_model import BitwiseARModel
from artalk_tpu_torch.utils import metrics as tmetrics
from artalk_tpu_torch.utils.metrics import GLOBAL_METRICS, Metrics, device_trace

from test_export import CFG
from test_torch_params import torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)


def test_spans_nest_with_parent_ids_and_attributes():
    m = Metrics()
    with m.span("outer", request=7) as outer:
        with m.span("inner", sid=3) as inner:
            time.sleep(0.002)
        inner_id = inner.id
    with m.span("after") as after:
        pass
    assert outer.parent == 0 and inner.parent == outer.id and after.parent == 0
    assert len({outer.id, inner_id, after.id}) == 3
    assert outer.attrs == {"request": 7} and inner.attrs == {"sid": 3}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns <= after.start_ns
    assert inner.duration_ns >= 2_000_000
    assert [sp.name for sp in m.spans()] == ["outer", "inner", "after"]
    assert [sp.name for sp in m.spans("inner")] == ["inner"]
    assert [sp.name for sp in m.spans({"outer", "after"}, since_ns=outer.end_ns)] == ["after"]
    assert m.spans(until_ns=outer.start_ns) == []
    # attributes filled while the span is open are kept
    with m.span("late") as sp:
        sp.attrs["tick"] = 5
    assert m.spans("late")[0].attrs == {"tick": 5}


def test_cpu_time_is_at_most_wall_time():
    m = Metrics()
    with m.span("sleep", cpu_time=True) as slept:
        time.sleep(0.02)
    with m.span("spin", cpu_time=True) as spun:
        t = time.thread_time_ns()
        while time.thread_time_ns() - t < 20_000_000:
            pass
    for sp in (slept, spun):
        assert 0 <= sp.cpu_ns <= sp.duration_ns
    assert slept.cpu_ns < 0.5 * slept.duration_ns        # off the CPU while asleep
    assert spun.cpu_ns >= 20_000_000                     # the loop's own CPU time
    with m.span("wall only") as plain:                   # the CPU clock is read on request
        pass
    assert plain.cpu_ns is None


def test_threads_keep_their_own_stacks():
    m = Metrics()
    ready, go = threading.Barrier(3), threading.Event()

    def work(name):
        with m.span(name):
            ready.wait(timeout=10)
            with m.span(name + ".child"):
                go.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    with m.span("main"):
        ready.wait(timeout=10)
        go.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    by_name = {sp.name: sp for sp in m.spans()}
    assert set(by_name) == {"a", "b", "a.child", "b.child", "main"}
    for n in ("a", "b"):
        assert by_name[n + ".child"].parent == by_name[n].id
        assert by_name[n + ".child"].thread == by_name[n].thread
        assert by_name[n].parent == 0
    assert by_name["a"].thread != by_name["b"].thread != by_name["main"].thread


def test_ring_is_bounded_and_counts_what_it_dropped(monkeypatch):
    assert tmetrics.SPAN_RING >= 65536 and GLOBAL_METRICS._ring.maxlen == tmetrics.SPAN_RING
    monkeypatch.setattr(tmetrics, "SPAN_RING", 16)
    m = Metrics()
    assert m.spans_dropped() == 0
    for i in range(40):
        with m.span("s", i=i):
            pass
    kept = m.spans()
    assert len(kept) == 16 and m.spans_dropped() == 24
    assert [sp.attrs["i"] for sp in kept] == list(range(24, 40))   # the newest stay
    m.reset()
    assert m.spans() == [] and m.spans_dropped() == 0


def test_recorded_span_keeps_stamps_taken_elsewhere():
    m = Metrics()
    stamps = {}

    def stamp():
        stamps["start"] = time.monotonic_ns()

    t = threading.Thread(target=stamp)
    t.start()
    t.join(timeout=10)
    with m.span("tick") as tick:
        pass
    q = m.record_span("queue", stamps["start"], tick.start_ns, request=4, tick=1)
    assert q.duration_ns == tick.start_ns - stamps["start"] >= 0
    assert q.cpu_ns is None and q.attrs == {"request": 4, "tick": 1}
    assert q.thread == threading.get_ident() and q.id != tick.id and q.parent == 0
    assert m.spans("queue") == [q]


def test_stage_is_a_span_with_a_bounded_timing(monkeypatch):
    monkeypatch.setattr(tmetrics, "TIMINGS_KEPT", 5)
    m = Metrics()
    for _ in range(12):
        with m.stage("inference.generate"):
            pass
    snap = m.snapshot()
    assert snap["inference.generate_count"] == 12
    assert len(m.timings["inference.generate"]) == 5
    assert sorted(k for k in snap if k.startswith("inference")) == [
        "inference.generate_count", "inference.generate_p50_ms", "inference.generate_p95_ms"]
    assert len(m.spans("inference.generate")) == 12
    assert "spans" not in snap


def test_clock_is_the_monotonic_one():
    """The benchmark and its clients read ``time.monotonic``: a span's stamps
    lie between two readings of it."""
    m = Metrics()
    before = time.monotonic()
    with m.span("x") as sp:
        pass
    after = time.monotonic()
    assert before * 1e9 - 1e6 <= sp.start_ns <= sp.end_ns <= after * 1e9 + 1e6


def test_ranges_open_only_where_the_profiler_records(tmp_path):
    m = Metrics()
    other = {}

    def elsewhere():
        with m.span("span.elsewhere") as sp:
            other["span"] = sp

    with m.span("span.before") as before:
        with device_trace(str(tmp_path)):
            with m.span("span.traced") as traced:
                time.sleep(0.001)
            t = threading.Thread(target=elsewhere)
            t.start()
            t.join(timeout=10)
    assert traced.ranged == tmetrics.RANGE
    assert before.ranged == tmetrics.LATE_RANGE        # its range opened with its child
    assert other["span"].ranged == tmetrics.NO_RANGE
    assert {sp.name for sp in m.spans()} == {"span.before", "span.traced", "span.elsewhere"}
    with open(tmp_path / "trace.json") as f:
        text = f.read()
    assert "span.traced" in text and "span.elsewhere" not in text
    with m.span("span.untraced") as quiet:
        pass
    assert quiet.ranged == tmetrics.NO_RANGE


def test_no_span_while_exporting():
    """The exported window step holds no profiler op, though a profiler runs
    while it is traced, and the trace adds no span to the ring."""
    model = BitwiseARModel(torch_config(CFG)).init(torch.Generator().manual_seed(0))
    GLOBAL_METRICS.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        program = export_model.export_window_step(model, batch=1, device="cpu")
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    # the one eager step ``export_window_step`` runs first records its three
    # spans (and ranges, under the profiler); the trace adds none
    window = [sp for sp in GLOBAL_METRICS.spans() if sp.name.startswith("window.")]
    assert [sp.name for sp in window] == ["window.encode", "window.decode", "window.vae"]
    assert all(sp.ranged == tmetrics.RANGE for sp in window)


@pytest.mark.parametrize("profiled", [False, True])
def test_span_cost_is_microseconds(profiled):
    """A loose bound that catches a span doing far more than four clock
    reads and an append (the cost on the card's host is in PERF.md)."""
    m = Metrics()
    n = 2000
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    if profiled:
        prof.__enter__()
    try:
        t = time.perf_counter()
        for _ in range(n):
            with m.span("cost"):
                pass
        per_span = (time.perf_counter() - t) / n
    finally:
        if profiled:
            prof.__exit__(None, None, None)
    assert per_span < (2e-3 if profiled else 2e-4)
    assert len(m.spans("cost")) == n
