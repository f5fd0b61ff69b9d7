"""The port's HTTP server on the CPU: the eight scenarios of
tests/isolated/test_server.py against ``artalk_tpu_torch.server``, plus a
second chunk in flight (409).

The JAX references are computed in the main thread before the server starts
(the server's threads run torch only): session rows equal JAX
``engine.stream`` rows to 1e-5, ``/v1/motion`` equals JAX ``engine.inference``
to 1e-5 (``tests/test_torch_engine.py``'s tolerance), the body of both motion
routes is byte for byte ``json.dumps`` of its float32 rows, and ``/v1/video``
returns a readable ``.y4m`` of the right frame count. Every HTTP call has a
timeout."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from artalk_tpu.config import ARConfig, ModelConfig, VAEConfig
from artalk_tpu.engine import ARTAvatarInferEngine as JaxEngine
from artalk_tpu.utils.checkpoint import _flatten

from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.server import MotionServer
from artalk_tpu_torch.utils.assets import save_flame_npz, synthetic_flame
from artalk_tpu_torch.utils.video import read_y4m

from test_engine import SMALL_W2V
from test_torch_params import torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)

# tests/isolated/test_serving.py's CFG: motion_dim 12 streams, cannot render
CFG = ModelConfig(
    ar=ARConfig(depth=2, num_heads=4, embed_dim=64, style_dim=16, audio_dim=32),
    vae=VAEConfig(motion_dim=12, code_dim=8, depth=2, num_heads=4, hidden_dim=32,
                  patch_nums=(1, 2, 4)),
    wav2vec=SMALL_W2V)
TIMEOUT = 120


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jeng = JaxEngine(load_gaga=False, config=CFG, seed=0, image_size=64, interpret=True,
                     output_dir=str(tmp_path_factory.mktemp("jrender")))
    rng = np.random.default_rng(7)
    ws = jeng.model.window_samples
    chunks = [rng.standard_normal(ws).astype(np.float32) * 0.1,
              rng.standard_normal(ws // 2).astype(np.float32) * 0.1]
    one_shot = (rng.standard_normal(int(1.5 * ws)) * 0.1).astype(np.float32)
    want = {"chunks": chunks, "stream": list(jeng.stream(chunks)),
            "audio": one_shot, "inference": jeng.inference(one_shot)}
    engine = ARTAvatarInferEngine(
        config=torch_config(CFG), params=_flatten(jeng.params), image_size=64, device="cpu",
        output_dir=str(tmp_path_factory.mktemp("render")))
    server = MotionServer(engine=engine, capacity=2, max_sessions=4, tick_ms=30.0)
    port = server.start(port=0)
    yield server, want, f"http://127.0.0.1:{port}"
    server.close()


def _req(url, method="GET", data=None, ctype="application/octet-stream"):
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.status, json.loads(resp.read().decode())


def _req_err(url, method="GET", data=None, ctype="application/octet-stream"):
    try:
        return _req(url, method, data, ctype)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _motion_req(url, data):
    """POST ``data`` to a motion route: (the parsed reply, its body equals
    ``json.dumps`` of the reply's rows read back as float32, which is exact:
    each value is a float32's shortest repr)."""
    code, _, raw = _req_raw(url, data)
    assert code == 200
    body = json.loads(raw.decode())
    rows = np.asarray(body["motion"], np.float32)
    return body, raw == json.dumps({"frames": len(rows), "motion": rows.tolist()}).encode()


def _open(base):
    code, body = _req(f"{base}/v1/sessions", "POST", b"{}", "application/json")
    assert code == 200
    return body["sid"]


def test_healthz(served):
    _, _, base = served
    code, body = _req(f"{base}/healthz")
    assert code == 200
    assert body["status"] == "ok"
    assert (body["device"], body["device_name"]) == ("cpu", "cpu")
    assert body["capacity"] >= 2
    assert body["sample_rate"] == 16000


def test_stream_session_matches_jax_stream(served):
    server, want, base = served
    sid = _open(base)
    for chunk, rows in zip(want["chunks"], want["stream"]):
        body, same_bytes = _motion_req(f"{base}/v1/sessions/{sid}/audio", chunk.tobytes())
        assert same_bytes
        assert body["frames"] == len(body["motion"]) == len(rows)
        np.testing.assert_allclose(np.asarray(body["motion"], np.float32), rows, atol=1e-5)
    code, _ = _req(f"{base}/v1/sessions/{sid}", "DELETE")
    assert code == 200
    code, _ = _req_err(f"{base}/v1/sessions/{sid}/audio", "POST", want["chunks"][0].tobytes())
    assert code == 404


def test_concurrent_chunks_share_one_tick(served):
    """Two clients posting together ride ONE batched pool step."""
    server, _, base = served
    sids = [_open(base) for _ in range(2)]
    steps = []
    orig_step = server.pool.step

    def counting_step(chunks):
        steps.append(sorted(chunks))
        return orig_step(chunks)

    server.pool.step = counting_step
    try:
        rng = np.random.default_rng(11)
        ws = server.pool.window_samples
        payloads = {s: rng.standard_normal(ws).astype(np.float32) * 0.1 for s in sids}
        results, errors = {}, []

        def post(s):
            try:
                results[s] = _req(f"{base}/v1/sessions/{s}/audio", "POST",
                                  payloads[s].tobytes())
            except Exception as exc:  # noqa: BLE001 — asserted below
                errors.append(exc)

        threads = [threading.Thread(target=post, args=(s,)) for s in sids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads) and not errors
        assert all(results[s][0] == 200 for s in sids)
        assert steps == [sorted(sids)]
    finally:
        del server.pool.step
        for s in sids:
            _req(f"{base}/v1/sessions/{s}", "DELETE")


def test_auto_grow_and_full(served):
    server, _, base = served
    sids = [_open(base) for _ in range(4)]   # capacity 2, max 4: one grow
    assert server.pool.capacity == 4
    code, _ = _req_err(f"{base}/v1/sessions", "POST", b"{}", "application/json")
    assert code == 503
    for s in sids:
        _req(f"{base}/v1/sessions/{s}", "DELETE")


def test_chunk_validation(served):
    """413 for a chunk over one window, 400 for an empty one, 409 for a
    second chunk while the first waits for its tick, 404 for an unknown
    session."""
    server, _, base = served
    sid = _open(base)
    ws = server.pool.window_samples
    code, _ = _req_err(f"{base}/v1/sessions/{sid}/audio", "POST",
                       np.zeros(ws + 1, np.float32).tobytes())
    assert code == 413
    code, _ = _req_err(f"{base}/v1/sessions/{sid}/audio", "POST", b"")
    assert code == 400
    code, _ = _req_err(f"{base}/v1/sessions/999/audio", "POST", b"\0\0\0\0")
    assert code == 404

    first = {}
    server.batcher.tick_s = 2.0        # hold the first chunk in its tick window
    try:
        t = threading.Thread(target=lambda: first.update(r=_req(
            f"{base}/v1/sessions/{sid}/audio", "POST", np.zeros(ws, np.float32).tobytes())))
        t.start()
        deadline = time.monotonic() + TIMEOUT
        while sid not in server.batcher._pending and time.monotonic() < deadline:
            time.sleep(0.01)
        code, body = _req_err(f"{base}/v1/sessions/{sid}/audio", "POST",
                              np.zeros(ws, np.float32).tobytes())
        assert code == 409 and "in flight" in body["error"]
        t.join(timeout=TIMEOUT)
        assert not t.is_alive() and first["r"][0] == 200
    finally:
        server.batcher.tick_s = 0.03
    _req(f"{base}/v1/sessions/{sid}", "DELETE")


def test_one_shot_matches_jax_inference(served):
    _, want, base = served
    body, same_bytes = _motion_req(f"{base}/v1/motion", want["audio"].tobytes())
    assert same_bytes
    assert body["frames"] == want["inference"].shape[0]
    np.testing.assert_allclose(np.asarray(body["motion"], np.float32), want["inference"],
                               atol=1e-5)


def test_json_pcm_and_bad_routes(served):
    _, _, base = served
    audio = np.zeros(100, np.float32) + 0.01
    code, body = _req(f"{base}/v1/motion", "POST",
                      json.dumps({"pcm": audio.tolist()}).encode(), "application/json")
    assert code == 200 and body["frames"] >= 1
    code, _ = _req_err(f"{base}/nope")
    assert code == 404
    code, _ = _req_err(f"{base}/v1/unknown", "POST", b"{}")
    assert code == 404


def _req_raw(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    req.add_header("Content-Type", "application/octet-stream")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.status, dict(resp.headers), resp.read()


@pytest.fixture(scope="module")
def served_render(tmp_path_factory):
    """A render-capable engine (motion_dim 106 feeds FLAME), random weights."""
    assets = tmp_path_factory.mktemp("assets_render")
    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(assets / "flame_synthetic.npz"))
    cfg = ModelConfig(
        ar=ARConfig(depth=2, num_heads=4, embed_dim=64, style_dim=16, audio_dim=32),
        vae=VAEConfig(motion_dim=106, code_dim=8, depth=2, num_heads=4, hidden_dim=32,
                      patch_nums=(1, 2, 4)),
        wav2vec=CFG.wav2vec)
    engine = ARTAvatarInferEngine(config=torch_config(cfg), seed=0, image_size=64,
                                  assets_dir=str(assets), device="cpu",
                                  output_dir=str(tmp_path_factory.mktemp("render_http")))
    server = MotionServer(engine=engine, capacity=1, tick_ms=30.0)
    port = server.start(port=0)
    yield server, f"http://127.0.0.1:{port}"
    server.close()


def test_video_returns_playable_file(served_render):
    """POST /v1/video: audio in, video bytes out. Without PyAV and ffmpeg the
    writer falls back to Y4M: 0.5 s at 25 fps is 13 frames of 64x64."""
    _, base = served_render
    audio = (np.random.default_rng(5).standard_normal(8000) * 0.1).astype(np.float32)
    code, headers, body = _req_raw(f"{base}/v1/video", audio.tobytes())
    assert code == 200
    fmt = headers["X-Video-Format"]
    assert fmt in ("mp4", "y4m", "npz") and len(body) > 0
    path = headers["X-Video-Path"]
    with open(path, "rb") as f:
        assert f.read() == body
    if fmt == "y4m":
        assert body.startswith(b"YUV4MPEG2")
        assert headers["Content-Type"] == "video/x-yuv4mpeg"
        frames, fps = read_y4m(path)
        assert frames.shape == (13, 64 * 3 // 2, 64) and fps == 25.0
    # an avatar shape_id without GAGA loaded maps to a clear 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _req_raw(f"{base}/v1/video?shape_id=someone.jpg", audio.tobytes())
    assert err.value.code == 400
    assert "GAGAvatar" in json.loads(err.value.read().decode())["error"]
