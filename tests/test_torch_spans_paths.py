"""The spans the port records where its work happens, on the CPU.

The HTTP server: two concurrent chunks ride one tick, and each has
``http.chunk`` holding ``batcher.wait`` and ``http.encode``, one request id
throughout, ``http.encode`` carrying the length of the reply's body; its ``batcher.queue`` carries the tick id of the ``batcher.tick``
that holds the carrying ``pool.tick`` and ends before that ``pool.tick``
starts; ``pool.tick`` carries rows stepped = capacity and rows with audio =
2, and holds the pack, the upload, the window step and the download; the
tick thread's spans follow one another through its loop. Offline inference records the window
spans once a window under ``inference.generate``; the mesh renderer its
three spans per 25-frame batch; a small GAGAvatar clip one ``gaga.avatar``
a call and one ``gaga.splat`` and ``gaga.upsample`` a frame."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.models.flame import FlameModel
from artalk_tpu_torch.models.gagavatar import avatar as tavatar
from artalk_tpu_torch.models.gagavatar import dino as tdino
from artalk_tpu_torch.models.gagavatar import generators as tgen
from artalk_tpu_torch.models.gagavatar import style_unet as tunet
from artalk_tpu_torch.ops import resize2d as tresize
from artalk_tpu_torch.server import MotionServer
from artalk_tpu_torch.utils.assets import (load_or_synthesize_flame, save_flame_npz,
                                           synthetic_flame)
from artalk_tpu_torch.utils.metrics import GLOBAL_METRICS

from test_engine import CFG as RENDER_CFG
from test_torch_gagavatar import ASSETS, T_DINO, _shrink
from test_torch_params import torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)
from test_torch_server import CFG as STREAM_CFG

TIMEOUT = 120
CAPACITY = 3


def _post(url: str, body: bytes, ctype: str = "application/octet-stream") -> dict:
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        assert resp.status == 200
        return json.loads(resp.read().decode())


@pytest.fixture(scope="module")
def two_chunks(tmp_path_factory):
    """A server of capacity 3 whose tick carried two concurrent chunks: the
    spans of the window, by name."""
    assets = tmp_path_factory.mktemp("assets")
    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(assets / "flame_synthetic.npz"))
    engine = ARTAvatarInferEngine(config=torch_config(STREAM_CFG), assets_dir=str(assets),
                                  output_dir=str(tmp_path_factory.mktemp("out")),
                                  image_size=64, device="cpu")
    server = MotionServer(engine=engine, capacity=CAPACITY, tick_ms=300.0)
    port = server.start(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        sids = [_post(f"{base}/v1/sessions", b"{}", "application/json")["sid"]
                for _ in range(2)]
        rng = np.random.default_rng(5)
        ws = server.pool.window_samples
        GLOBAL_METRICS.reset()
        replies, errors = {}, []

        def post(sid):
            try:
                pcm = (rng.standard_normal(ws) * 0.1).astype(np.float32).tobytes()
                replies[sid] = _post(f"{base}/v1/sessions/{sid}/audio", pcm)
            except Exception as exc:  # noqa: BLE001 — asserted below
                errors.append(exc)

        threads = [threading.Thread(target=post, args=(s,)) for s in sids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads) and not errors
        deadline = time.monotonic() + TIMEOUT     # the tick thread leaves its tick
        while not GLOBAL_METRICS.spans("batcher.tick") and time.monotonic() < deadline:
            time.sleep(0.01)
        spans = GLOBAL_METRICS.spans()
        snapshot = GLOBAL_METRICS.snapshot()
    finally:
        server.close()
    by_name = {}
    for sp in spans:
        by_name.setdefault(sp.name, []).append(sp)
    return {"sids": sids, "replies": replies, "spans": spans, "by_name": by_name,
            "snapshot": snapshot, "tick_thread": server.batcher._thread.ident}


def test_each_chunk_is_one_request_from_handler_to_tick(two_chunks):
    by = two_chunks["by_name"]
    chunks = by["http.chunk"]
    assert sorted(c.attrs["sid"] for c in chunks) == sorted(two_chunks["sids"])
    (tick,) = by["pool.tick"]
    (outer,) = by["batcher.tick"]
    (lock,) = by["batcher.lock"]
    for c in chunks:
        rid = c.attrs["request"]
        assert rid == c.id
        kids = [sp for sp in two_chunks["spans"] if sp.parent == c.id]
        assert sorted(sp.name for sp in kids) == ["batcher.wait", "http.encode"]
        assert all(sp.attrs["request"] == rid and sp.attrs["sid"] == c.attrs["sid"]
                   for sp in kids)
        wait, encode = sorted(kids, key=lambda sp: sp.start_ns)
        reply = two_chunks["replies"][c.attrs["sid"]]
        assert encode.attrs["bytes"] == len(json.dumps(reply).encode())
        assert c.start_ns <= wait.start_ns <= wait.end_ns <= encode.start_ns <= c.end_ns
        assert c.thread != two_chunks["tick_thread"]
        (queued,) = [q for q in by["batcher.queue"] if q.attrs["request"] == rid]
        assert queued.attrs["sid"] == c.attrs["sid"]
        assert queued.attrs["tick"] == outer.attrs["tick"] and tick.parent == outer.id
        assert lock.end_ns <= queued.end_ns <= tick.start_ns
        assert wait.start_ns <= queued.start_ns <= queued.end_ns <= wait.end_ns
    assert all(r["frames"] > 0 for r in two_chunks["replies"].values())


def test_pool_tick_counts_its_rows_and_holds_the_step(two_chunks):
    by, spans = two_chunks["by_name"], two_chunks["spans"]
    (tick,) = by["pool.tick"]
    assert tick.attrs["rows_stepped"] == CAPACITY and tick.attrs["rows_with_audio"] == 2
    kids = sorted((sp for sp in spans if sp.parent == tick.id), key=lambda sp: sp.start_ns)
    assert [sp.name for sp in kids] == ["pool.pack", "pool.upload", "window.encode",
                                        "window.decode", "window.vae", "pool.download"]
    (outer,) = by["batcher.tick"]
    assert tick.parent == outer.id and outer.attrs["tick"] == 0 and "tick" not in tick.attrs
    # the CPU clock is read where a reader takes it: the tick and the download
    assert outer.cpu_ns is not None and kids[-1].cpu_ns is not None
    assert tick.cpu_ns is None and kids[0].cpu_ns is None
    outer_kids = sorted((sp for sp in spans if sp.parent == outer.id),
                        key=lambda sp: sp.start_ns)
    assert [sp.name for sp in outer_kids] == ["batcher.aggregate", "batcher.lock",
                                              "pool.tick", "batcher.fanout"]
    assert outer_kids[0].duration_ns >= 0.3e9          # the tick_ms aggregation
    snapshot = two_chunks["snapshot"]
    keys = list(snapshot) + list(snapshot["counters"]) + list(snapshot["gauges"])
    assert not [k for k in keys if k.startswith(("pool.", "batcher.", "http."))]


def test_tick_thread_spans_cover_its_loop(two_chunks):
    top = [sp for sp in two_chunks["spans"]
           if sp.thread == two_chunks["tick_thread"] and sp.parent == 0
           and sp.name.startswith("batcher.") and sp.name != "batcher.queue"]
    assert [sp.name for sp in top][-1] == "batcher.tick"
    assert [sp.name for sp in top][-2:-1] in ([], ["batcher.idle"])
    (outer,) = two_chunks["by_name"]["batcher.tick"]
    kids = sorted((sp for sp in two_chunks["spans"] if sp.parent == outer.id),
                  key=lambda sp: sp.start_ns)
    # the children follow one another inside the tick, with no more than a
    # few statements between them: at most half the tick, which holds the
    # 300 ms aggregation, is left to those (a loaded host may stall any of
    # them); the loop's spans follow one another likewise
    assert outer.start_ns <= kids[0].start_ns and kids[-1].end_ns <= outer.end_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    covered = sum(sp.duration_ns for sp in kids)
    assert outer.duration_ns - covered < 0.5 * outer.duration_ns
    for a, b in zip(top, top[1:]):
        assert 0 <= b.start_ns - a.end_ns < outer.duration_ns


@pytest.fixture(scope="module")
def render_engine(tmp_path_factory):
    assets = tmp_path_factory.mktemp("assets")
    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(assets / "flame_synthetic.npz"))
    return ARTAvatarInferEngine(config=torch_config(RENDER_CFG), assets_dir=str(assets),
                                output_dir=str(tmp_path_factory.mktemp("out")),
                                image_size=64, device="cpu")


def test_inference_records_window_spans_once_a_window(render_engine):
    engine = render_engine
    ws = engine.model.window_samples
    audio = (np.random.default_rng(2).standard_normal(2 * ws + 1000) * 0.1).astype(np.float32)
    GLOBAL_METRICS.reset()
    engine.inference(audio)
    spans = GLOBAL_METRICS.spans()
    (generate,) = [sp for sp in spans if sp.name == "inference.generate"]
    windows = [sp for sp in spans if sp.name.startswith("window.")]
    assert [sp.name for sp in windows] == ["window.encode", "window.decode", "window.vae"] * 3
    assert all(sp.parent == generate.id for sp in windows)
    names = [sp.name for sp in spans if sp.parent == 0]
    assert names == ["inference.generate", "inference.postprocess", "inference.download"]


def test_mesh_renderer_records_three_spans_a_batch(render_engine):
    engine = render_engine
    motion = torch.from_numpy(
        (np.random.default_rng(3).standard_normal((30, 106)) * 0.1).astype(np.float32))
    verts = engine.flame.motion_to_verts(motion.new_zeros((30, 300)), motion)
    GLOBAL_METRICS.reset()
    frames = engine.mesh_renderer.render_frames(verts)
    assert frames.shape[0] == 30
    assert [sp.name for sp in GLOBAL_METRICS.spans()] == [
        "mesh.draw", "mesh.colorspace", "mesh.download"] * 2


def test_gagavatar_records_avatar_once_and_splat_a_frame(monkeypatch):
    monkeypatch.setenv("ARTALK_GAGA_PRECISION", "exact")
    _shrink(monkeypatch, tavatar, tdino, tgen, tunet, tresize.resize_antialias, T_DINO)
    gaga = tavatar.GAGAvatar(assets_dir=ASSETS, device="cpu")
    flame = FlameModel(load_or_synthesize_flame(ASSETS), n_shape=300, n_exp=100, scale=5.0)
    motions = (np.random.default_rng(4).standard_normal((3, 106)) * 0.1).astype(np.float32)
    GLOBAL_METRICS.reset()
    frames = gaga.render_motion_sequence("synthetic_0", motions, flame, transfer_chunk=2,
                                         colorspace="yuv420")
    assert frames.shape[0] == 3
    names = [sp.name for sp in GLOBAL_METRICS.spans()]
    assert names == ["gaga.avatar",
                     "gaga.prep", "gaga.splat", "gaga.upsample", "gaga.splat", "gaga.upsample",
                     "gaga.download",
                     "gaga.prep", "gaga.splat", "gaga.upsample", "gaga.download"]
