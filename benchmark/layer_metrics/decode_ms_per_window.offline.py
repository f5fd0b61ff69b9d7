"""Engine inference (``engine.py`` -> ``models/wav2vec.py``, ``ar_model.py``,
``bitwise_vae.py``, ``ops/savgol.py``): ms of ``engine.inference`` per
4-s window, over the clips after the traced stretch. The span ends when the
motion is on the host, so it holds the whole decode."""


def read(ctx, data, spans, trace):
    ms = sum(spans.durations("engine.inference", data["since"], data["until"])) * 1e3
    return ms / data["windows"] if data["windows"] else None
