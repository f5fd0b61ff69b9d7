"""HTTP motion-streaming server: concurrent sessions batched onto one card.

Counterpart of ``artalk_tpu/server.py``: the deployment front end for
:class:`artalk_tpu_torch.serving.StreamPool`, a stdlib threaded HTTP server
whose concurrent audio-chunk requests are aggregated into ONE batched window
step per service tick, so B clients cost close to one.

Architecture (stdlib only):

- ``ThreadingHTTPServer`` handles requests on threads;
- a single ``_TickBatcher`` thread owns every pool step: chunk POSTs park on
  an event while their session id + audio join the pending tick, the batcher
  fires one ``StreamPool.step`` for all of them after ``tick_ms`` of
  aggregation, then wakes all waiters with their rows;
- one lock serializes pool mutations (open/close/grow) against ticks.

Spans (``utils/metrics.GLOBAL_METRICS``; each times the host): on a request
thread, ``http.chunk`` around a chunk's whole handler, with the children
``batcher.wait`` (from the chunk's enqueue to its tick's wake-up) and
``http.encode`` (the reply's body written, with its length in ``bytes``),
all three carrying the request id (``http.chunk``'s span id) and the session
id.
On the tick thread, ``batcher.idle`` (waiting with nothing pending) and
``batcher.tick`` (tick id) with the children ``batcher.aggregate`` (the
``tick_ms`` sleep), ``batcher.lock`` (acquiring the pool lock), the pool's
``pool.tick`` and ``batcher.fanout`` (handing out the rows); between its
first tick and its last, the tick thread is always inside one of them, and
``batcher.tick`` holds the thread's CPU time. For
each chunk a tick carries, the tick thread records ``batcher.queue``
(request id, session id, tick id) from the chunk's enqueue to the moment
the tick hands its batch to ``StreamPool.step``.

The motion replies of ``/v1/sessions/<sid>/audio`` and ``/v1/motion`` are
written by ``ops/motion_json.MotionJSON``: the bytes of ``json.dumps`` of the
rows, written by host code that does not hold the interpreter lock, so the
request threads encoding replies leave it to the tick thread, which launches
the pool step. Its library is built or loaded in ``MotionServer.__init__``.

``/v1/motion`` and ``/v1/video`` run ``engine.inference`` and
``engine.rendering`` on their request threads, on the same device as the
ticks. Every model call runs under ``torch.no_grad()``: grad mode is per
thread in PyTorch, and a request thread starts with it on. A kernel's first
launch may happen on any of these threads; its build is locked per process
(``ops/_nvcc.library_lock``).

Endpoints (JSON unless noted; audio is raw little-endian float32 16 kHz mono
PCM with ``Content-Type: application/octet-stream``, or ``{"pcm": [...]}``):

- ``GET  /healthz``                  -> {status, device, device_name, capacity,
                                     max_sessions, active, window_samples,
                                     sample_rate}
- ``POST /v1/sessions``              {"style_motion": null | [[106 floats]]}
                                     -> {"sid": n}        (503 when full)
- ``DELETE /v1/sessions/<sid>``      -> {"closed": n}     (404 unknown)
- ``POST /v1/sessions/<sid>/audio``  PCM chunk (<= one 4 s window; 413 when
                                     longer, 409 when a chunk is in flight)
                                     -> {"frames": F, "motion": [[106]...]}
                                     raw streaming motion, engine.stream
                                     semantics
- ``POST /v1/motion``                PCM, any length -> smoothed offline
                                     motion, ``engine.inference`` parity
- ``POST /v1/video[?shape_id=mesh]`` PCM, any length -> rendered talking-head
                                     video bytes: offline inference ->
                                     ``engine.rendering`` -> mp4 when an
                                     encoder exists, Y4M / npz otherwise
                                     (format in ``X-Video-Format``, server-side
                                     path in ``X-Video-Path``)

Run: ``python -m artalk_tpu_torch.server [--port 8042] [--sessions 8]
[--device cuda]``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .utils.metrics import GLOBAL_METRICS


class _TickBatcher:
    """Aggregates concurrent chunk submissions into one batched pool step.

    ``submit`` blocks the calling request thread until the tick that carried
    its chunk completes, then returns that session's motion rows. One chunk
    may be in flight per session (the pool advances a session one window per
    tick by construction); a second concurrent submit raises ``BusyError``.
    """

    class BusyError(RuntimeError):
        pass

    class GoneError(KeyError):
        pass

    def __init__(self, pool, pool_lock: threading.Lock, tick_ms: float = 5.0):
        self.pool = pool
        self.pool_lock = pool_lock
        self.tick_s = tick_ms / 1000.0
        self._cv = threading.Condition()
        self._pending: Dict[int, dict] = {}
        self._ticks = 0             # the id of the next tick that steps the pool
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="artalk-tick")
        self._thread.start()

    def submit(self, sid: int, chunk: np.ndarray, timeout: float = 600.0,
               request: int = 0):
        """Queue ``sid``'s chunk for the next tick and wait for its rows;
        ``request`` is the id its spans carry."""
        # The default timeout covers a first tick that builds the kernels
        # (nvcc takes up to minutes); steady-state ticks are milliseconds.
        entry = {"chunk": chunk, "event": threading.Event(), "request": request}
        with GLOBAL_METRICS.span("batcher.wait", request=request, sid=sid):
            with self._cv:
                if sid in self._pending:
                    raise self.BusyError(f"session {sid} already has a chunk "
                                         "in flight; await its response first")
                entry["enqueued_ns"] = time.monotonic_ns()
                self._pending[sid] = entry
                self._cv.notify()
            if not entry["event"].wait(timeout):
                raise TimeoutError("tick did not complete in time")
        if "error" in entry:
            raise entry["error"]
        return entry["motion"]

    def close(self):
        with self._cv:
            self._running = False
            self._cv.notify()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------ loop

    def _run(self):
        while True:
            with GLOBAL_METRICS.span("batcher.idle"):
                with self._cv:
                    while self._running and not self._pending:
                        self._cv.wait()
                    if not self._running:
                        return
            with GLOBAL_METRICS.span("batcher.tick", cpu_time=True) as tick_span:
                self._tick(tick_span)

    def _tick(self, tick_span):
        # aggregation window: let concurrent requests join this tick
        with GLOBAL_METRICS.span("batcher.aggregate"):
            time.sleep(self.tick_s)
        with self._cv:
            batch, self._pending = self._pending, {}
        with GLOBAL_METRICS.span("batcher.lock"):
            self.pool_lock.acquire()
        try:
            live = set(self.pool.active_sessions)
            gone = {s: e for s, e in batch.items() if s not in live}
            batch = {s: e for s, e in batch.items() if s in live}
            for sid, entry in gone.items():
                entry["error"] = self.GoneError(
                    f"session {sid} was closed while its chunk waited")
                entry["event"].set()
            if not batch:
                return
            tick_span.attrs["tick"] = tick = self._ticks
            self._ticks += 1
            stepped_ns = time.monotonic_ns()
            try:
                with torch.no_grad():
                    out = self.pool.step({s: e["chunk"] for s, e in batch.items()})
                for sid, entry in batch.items():
                    entry["motion"] = out[sid]
            except Exception as exc:  # noqa: BLE001 — fan the tick
                for entry in batch.values():  # failure out per-request
                    entry["error"] = exc
            for sid, entry in batch.items():
                GLOBAL_METRICS.record_span("batcher.queue", entry["enqueued_ns"], stepped_ns,
                                           request=entry["request"], sid=sid, tick=tick)
            with GLOBAL_METRICS.span("batcher.fanout"):
                for entry in batch.values():
                    entry["event"].set()
        finally:
            self.pool_lock.release()


class MotionServer:
    """Ties an engine (weights + offline path) to a StreamPool + HTTP front."""

    def __init__(self, engine=None, capacity: int = 8,
                 max_sessions: Optional[int] = None, tick_ms: float = 5.0,
                 config=None, params=None, device: Union[str, torch.device] = "cuda"):
        """Without ``engine``, builds ``ARTAvatarInferEngine(config=config,
        params=params, device=device)``; the pool runs on the engine's device."""
        from .engine import ARTAvatarInferEngine
        from .ops.motion_json import MotionJSON
        from .serving import StreamPool

        if engine is None:
            engine = ARTAvatarInferEngine(load_gaga=False, config=config,
                                          params=params, device=device)
        self.engine = engine
        self.motion_json = MotionJSON()
        with torch.no_grad():
            self.pool = StreamPool(engine.model, max_sessions=capacity)
        self.max_sessions = int(max_sessions or capacity)
        self.pool_lock = threading.Lock()
        self.batcher = _TickBatcher(self.pool, self.pool_lock, tick_ms)
        self._httpd: Optional[ThreadingHTTPServer] = None

    # ------------------------------------------------------------ operations

    @torch.no_grad()
    def open_session(self, style_motion=None) -> int:
        with self.pool_lock:
            if (self.pool.free_slots == 0
                    and self.pool.capacity < self.max_sessions):
                self.pool.grow(min(self.pool.capacity * 2, self.max_sessions))
            return self.pool.open_session(style_motion)

    def close_session(self, sid: int):
        with self.pool_lock:
            self.pool.close_session(sid)

    @torch.no_grad()
    def one_shot(self, audio: np.ndarray) -> np.ndarray:
        """Offline decode with ``engine.inference`` parity (smoothed)."""
        return np.asarray(self.engine.inference(audio))

    @torch.no_grad()
    def render_video(self, audio: np.ndarray, shape_id: str = "mesh") -> str:
        """Offline inference + full render; returns the written video path
        (mp4, or the Y4M / npz fallback of ``utils/video.write_video``). The
        mesh path needs no avatar assets."""
        motion = self.one_shot(audio)
        return self.engine.rendering(audio, motion, shape_id=shape_id,
                                     save_name=f"http_{uuid.uuid4().hex[:8]}")

    def health(self) -> dict:
        device = self.engine.device
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        with self.pool_lock:
            return {"status": "ok", "device": str(device), "device_name": name,
                    "capacity": self.pool.capacity,
                    "max_sessions": self.max_sessions,
                    "active": len(self.pool.active_sessions),
                    "window_samples": self.pool.window_samples,
                    "sample_rate": self.pool.sample_rate}

    # ------------------------------------------------------------------ http

    def serve(self, port: int = 8042, host: str = "127.0.0.1"):
        """Blocking serve loop; ``start()`` for the threaded variant."""
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        try:
            self._httpd.serve_forever()
        finally:
            self.close()

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Serve on a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="artalk-http").start()
        return self._httpd.server_address[1]

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.batcher.close()

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet by default
                pass

            # -------------------------------------------------- io helpers

            def _json(self, code: int, obj: dict):
                self._send_json(code, json.dumps(obj).encode())

            def _send_json(self, code: int, body: Union[bytes, memoryview]):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _err(self, code: int, msg: str):
                self._json(code, {"error": msg})

            def _read_pcm(self) -> np.ndarray:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    pcm = json.loads(raw.decode() or "{}").get("pcm", [])
                    return np.asarray(pcm, np.float32).reshape(-1)
                return np.frombuffer(raw, np.float32).copy()

            # ------------------------------------------------------ routes

            def do_GET(self):
                if self.path == "/healthz":
                    return self._json(200, server.health())
                return self._err(404, f"no route {self.path}")

            def do_POST(self):
                url = urlparse(self.path)
                parts = [p for p in url.path.split("/") if p]
                if parts == ["v1", "sessions"]:
                    return self._open()
                if (len(parts) == 4 and parts[:2] == ["v1", "sessions"]
                        and parts[3] == "audio"):
                    return self._chunk(parts[2])
                if parts == ["v1", "motion"]:
                    return self._one_shot()
                if parts == ["v1", "video"]:
                    query = parse_qs(url.query)
                    return self._video(query.get("shape_id", ["mesh"])[0])
                return self._err(404, f"no route {self.path}")

            def do_DELETE(self):
                parts = [p for p in self.path.split("/") if p]
                if len(parts) == 3 and parts[:2] == ["v1", "sessions"]:
                    try:
                        sid = int(parts[2])
                        server.close_session(sid)
                        return self._json(200, {"closed": sid})
                    except (KeyError, ValueError) as exc:
                        return self._err(404, str(exc))
                return self._err(404, f"no route {self.path}")

            # ---------------------------------------------------- handlers

            def _open(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n).decode() or "{}")
                style = body.get("style_motion")
                style = None if style is None else np.asarray(style, np.float32)
                try:
                    sid = server.open_session(style)
                except RuntimeError as exc:  # pool full at max capacity
                    return self._err(503, str(exc))
                return self._json(200, {"sid": sid})

            def _chunk(self, sid_str: str):
                with GLOBAL_METRICS.span("http.chunk") as sp:
                    sp.attrs["request"] = sp.id
                    return self._serve_chunk(sid_str, sp)

            def _serve_chunk(self, sid_str: str, sp):
                try:
                    sid = int(sid_str)
                except ValueError:
                    return self._err(404, f"bad session id {sid_str!r}")
                sp.attrs["sid"] = sid
                if sid not in server.pool.active_sessions:
                    return self._err(404, f"unknown session {sid}")
                pcm = self._read_pcm()
                if len(pcm) == 0:
                    return self._err(400, "empty audio chunk")
                if len(pcm) > server.pool.window_samples:
                    return self._err(
                        413, f"chunk of {len(pcm)} samples exceeds the "
                        f"{server.pool.window_samples}-sample window; "
                        "split it across requests")
                try:
                    motion = server.batcher.submit(sid, pcm, request=sp.id)
                except _TickBatcher.BusyError as exc:
                    return self._err(409, str(exc))
                except _TickBatcher.GoneError as exc:
                    return self._err(410, str(exc))
                except TimeoutError as exc:
                    return self._err(504, str(exc))
                with GLOBAL_METRICS.span("http.encode", request=sp.id, sid=sid) as enc:
                    body = server.motion_json.encode(motion)
                    enc.attrs["bytes"] = len(body)
                return self._send_json(200, body)

            def _one_shot(self):
                pcm = self._read_pcm()
                if len(pcm) == 0:
                    return self._err(400, "empty audio")
                motion = server.one_shot(pcm)
                return self._send_json(200, server.motion_json.encode(motion))

            VIDEO_TYPES = {".mp4": "video/mp4", ".y4m": "video/x-yuv4mpeg",
                           ".npz": "application/octet-stream"}

            def _video(self, shape_id: str):
                pcm = self._read_pcm()
                if len(pcm) == 0:
                    return self._err(400, "empty audio")
                try:
                    path = server.render_video(pcm, shape_id=shape_id)
                except RuntimeError as exc:  # e.g. avatar id without GAGA
                    return self._err(400, str(exc))
                ext = os.path.splitext(path)[1]
                with open(path, "rb") as f:
                    body = f.read()
                self.send_response(200)
                self.send_header("Content-Type", self.VIDEO_TYPES.get(
                    ext, "application/octet-stream"))
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Content-Disposition",
                                 f'attachment; filename="{os.path.basename(path)}"')
                self.send_header("X-Video-Format", ext.lstrip("."))
                self.send_header("X-Video-Path", path)
                self.end_headers()
                self.wfile.write(body)

        return Handler


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--port", type=int, default=8042)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--sessions", type=int, default=8,
                   help="initial pool capacity (batch rows)")
    p.add_argument("--max-sessions", type=int, default=None,
                   help="auto-grow ceiling (default: --sessions, no growth)")
    p.add_argument("--tick-ms", type=float, default=5.0,
                   help="aggregation window before each batched step")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.sessions < 1:
        p.error("--sessions must be >= 1")

    server = MotionServer(capacity=args.sessions,
                          max_sessions=args.max_sessions,
                          tick_ms=args.tick_ms, device=args.device)
    print(f"[artalk_tpu_torch] serving on http://{args.host}:{args.port} "
          f"(capacity {args.sessions}, max {server.max_sessions}, "
          f"device {server.engine.device})")
    server.serve(port=args.port, host=args.host)


if __name__ == "__main__":
    main()
