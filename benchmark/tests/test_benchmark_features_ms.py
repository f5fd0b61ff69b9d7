"""``features_ms_per_tick.stream``: the conv front's device time per pool
tick, read from the program's ``wav2vec.frontend`` spans inside each
``pool.tick``; nothing where the program records no such span (the parent
commit's program) or where no span carries a device time (a CPU run)."""

import types

from benchmark import harness, program_spans


def reader():
    return harness.load_module(harness.BENCH / "layer_metrics" / "features_ms_per_tick.stream.py",
                               "lm_features_ms")


def _ticks(reg, device_us):
    """Three harness ticks, each holding a ``pool.tick`` span and, inside it,
    a ``wav2vec.frontend`` span with the given device time (None: none)."""
    ticks = []
    for i, us in enumerate(device_us):
        t0 = 10.0 + i
        reg.record_span("pool.tick", program_spans.ns(t0 + 0.1), program_spans.ns(t0 + 0.9))
        attrs = {} if us is None else {"device_us": us}
        reg.record_span("wav2vec.frontend", program_spans.ns(t0 + 0.2),
                        program_spans.ns(t0 + 0.3), **attrs)
        ticks.append(types.SimpleNamespace(start=t0, end=t0 + 1.0))
    return {"ticks": ticks}


def test_reads_the_median_device_time():
    reg = program_spans.registry()
    reg.reset()
    try:
        data = _ticks(reg, [12000, 14000, 30000])
        assert reader().read(None, data, None, None) == 14.0
    finally:
        reg.reset()


def test_reads_nothing_without_device_times_or_spans(monkeypatch):
    reg = program_spans.registry()
    reg.reset()
    try:
        assert reader().read(None, _ticks(reg, [None, None, None]), None, None) is None
        reg.reset()
        data = _ticks(reg, [12000, 14000, 30000])
        monkeypatch.setattr(program_spans, "kept",
                            lambda names=None, *a: [] if names == "wav2vec.frontend"
                            else program_spans.registry().spans(names))
        assert reader().read(None, data, None, None) is None
        monkeypatch.undo()
        monkeypatch.delattr(type(reg), "spans")
        assert reader().read(None, data, None, None) is None
    finally:
        monkeypatch.undo()
        reg.reset()
