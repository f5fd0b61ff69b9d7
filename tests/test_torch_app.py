"""The port's web-app callback (``app_gradio.process_request``) and metrics
registry (``utils/metrics``) on the CPU, against the JAX package.

``process_request``: the audio branch's saved motions equal JAX
``engine.inference`` of the same wav to atol 1e-5 (``tests/test_torch_engine.py``'s
tolerance); the text branch goes through an injected TTS, as
``tests/test_engine.py`` does; invalid input warns and returns (None, None).
The registry: after the same inference, stream and mesh rendering on both
engines, the counters and every stage's count equal the JAX engine's, under
the same names; ``device_trace`` writes a trace whose events hold the
``inference.generate`` range."""

import json
import os

import numpy as np
import pytest

from artalk_tpu.engine import ARTAvatarInferEngine as JaxEngine
from artalk_tpu.utils.assets import save_flame_npz, synthetic_flame
from artalk_tpu.utils.checkpoint import _flatten
from artalk_tpu.utils.metrics import GLOBAL_METRICS as JAX_METRICS

from artalk_tpu_torch.app_gradio import process_request
from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.utils.audio import load_audio_16k_mono
from artalk_tpu_torch.utils.metrics import GLOBAL_METRICS, Metrics, device_trace

from test_engine import CFG, _write_wav
from test_torch_params import torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)



@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    assets = tmp_path_factory.mktemp("assets")
    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(assets / "flame_synthetic.npz"))
    jeng = JaxEngine(assets_dir=str(assets), output_dir=str(tmp_path_factory.mktemp("jout")),
                     config=CFG, image_size=128, interpret=True)   # 128-pixel tiles
    teng = ARTAvatarInferEngine(
        assets_dir=str(assets), output_dir=str(tmp_path_factory.mktemp("tout")),
        config=torch_config(CFG), params=_flatten(jeng.params), image_size=64,
        device="cpu")
    return jeng, teng


def test_process_request_audio_branch(engines, tmp_path):
    jeng, teng = engines
    wav = _write_wav(tmp_path / "clip.wav")
    video_path, motion_path = process_request(
        teng, "Audio", wav, None, "English", "mesh", "default")
    assert os.path.exists(video_path)
    assert os.path.basename(motion_path) == "clip_default_mesh_motions.npy"
    motions = np.load(motion_path)
    assert motions.shape == (8, 106)
    np.testing.assert_allclose(motions, jeng.inference(load_audio_16k_mono(wav)), atol=1e-5)
    np.testing.assert_array_equal(motions[:, 104:], 0.0)


def test_process_request_text_branch(engines, tmp_path):
    """The text branch with the TTS service stubbed (gTTS is a network call)."""
    _, teng = engines
    calls = {}

    def fake_tts(text, language, out_dir):
        calls["args"] = (text, language, out_dir)
        return _write_wav(tmp_path / "tts_output.wav", seconds=0.2)

    video_path, motion_path = process_request(
        teng, "Text", None, "hello world", "English", "mesh", "default", tts=fake_tts)
    assert calls["args"] == ("hello world", "English", teng.output_dir)
    assert os.path.exists(video_path)
    assert np.load(motion_path).shape == (5, 106)


def test_process_request_invalid_inputs(engines):
    _, teng = engines
    warnings = []
    out = process_request(teng, "Audio", None, None, "English", "mesh", "default",
                          warn=warnings.append)
    assert out == (None, None)
    out = process_request(teng, "Text", None, "   ", "English", "mesh", "default",
                          warn=warnings.append)
    assert out == (None, None)
    assert warnings == ["Please upload an audio file", "Please input text content"]


def _counts(snapshot: dict) -> dict:
    """The registry's counters and each stage's count (times differ)."""
    return {"counters": snapshot["counters"],
            **{k: v for k, v in snapshot.items() if k.endswith("_count")}}


def test_metrics_match_jax_engine(engines, rng):
    jeng, teng = engines
    ws = teng.model.window_samples
    audio = (rng.standard_normal(ws + 1000) * 0.1).astype(np.float32)
    snapshots = []
    for engine, metrics in ((jeng, JAX_METRICS), (teng, GLOBAL_METRICS)):
        metrics.reset()
        motions = engine.inference(audio)
        list(engine.stream([audio[:ws], audio[ws:]]))
        engine.rendering(audio, motions, shape_id="mesh", save_name="metrics")
        snapshots.append(metrics.snapshot())
    want, got = snapshots
    assert _counts(got) == _counts(want)
    assert sorted(got) == sorted(want)
    assert got["counters"] == {"inference.windows": 2.0, "inference.frames": 6.0,
                               "render.frames": 6.0}
    assert {k for k in got if k.endswith("_count")} == {
        f"{s}_count" for s in ("inference.generate", "inference.postprocess",
                               "stream.window_step", "render.flame_verts", "render.rasterize")}
    assert got["stream.window_step_count"] == 2
    json.loads(GLOBAL_METRICS.dump_json())


def test_registry_and_device_trace(engines, tmp_path):
    _, teng = engines
    metrics = Metrics()
    with metrics.stage("outer"):
        metrics.count("n", 2)
        metrics.gauge("g", 3)
    snap = metrics.snapshot()
    assert snap["counters"] == {"n": 2.0} and snap["gauges"] == {"g": 3.0}
    assert snap["outer_count"] == 1 and snap["outer_p95_ms"] >= snap["outer_p50_ms"] >= 0
    with device_trace(str(tmp_path / "trace")) as prof:
        teng.inference(np.zeros(4000, np.float32))
    names = {e.key for e in prof.key_averages()}
    assert {"inference.generate", "inference.postprocess"} <= names
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "inference.generate" in f.read()
