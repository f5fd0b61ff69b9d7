"""End-to-end HTTP serving load test on the card.

Counterpart of the repository's ``tools/bench_http_serving.py``. The device
curve (``tools/bench_streampool``) says nothing about what a client sees
through ``server.py``'s 5 ms aggregation tick, the per-tick host work and
the motion rows' copy to the host and into JSON. This drives N concurrent
stdlib-HTTP clients against an in-process ``MotionServer``, each streaming
back-to-back 4 s windows, and records per-chunk latency percentiles and the
aggregate throughput:

    python -m artalk_tpu_torch.tools.bench_http_serving [--clients 1 4 8 16] [--windows 6]
                                                        [--precision int8|fast|exact]

Each client holds one session and keeps exactly one chunk in flight (the
server answers 409 to a second), so N clients make N-deep batches at the
tick. Back-to-back streaming saturates the server; a real-time client posts
one window per 4 s, so the per-chunk p50 is the latency floor and
(4000 / p50) * N bounds the real-time sessions this HTTP tier sustains at
that concurrency.

The clients run as threads of the server's process, as in the JAX tool: they,
the request threads, the tick thread and the pool share one interpreter
lock. Per N the tool also prints the pool step's own time, the median of the
program's ``pool.tick`` spans (``utils/metrics.GLOBAL_METRICS``: one per
``StreamPool.step``, the batched window step and the motion's copy to the
host), so the front end's share can be told from the pool's.

``--precision`` sets ``ARTALK_AR_PRECISION`` (and ``ARTALK_AR_FUSED=1`` for
fast and int8) while the engine is built, and unsets both for exact. The
kernels are built before the server starts, so no nvcc runs inside a tick;
the port compiles nothing per capacity, so one warm-up chunk per client
replaces the JAX tool's retries of a 504 (an XLA compile). Any answer other
than 200 is an error: the tool raises, and the command exits non-zero.
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..bench import ASSETS, build_kernels, with_env
from ..config import ModelConfig
from ..engine import ARTAvatarInferEngine, resolve_device
from ..server import MotionServer
from ..utils.metrics import GLOBAL_METRICS
from . import device_line

PRECISION_ENV = {"exact": {}, "fast": {"ARTALK_AR_PRECISION": "fast", "ARTALK_AR_FUSED": "1"},
                 "int8": {"ARTALK_AR_PRECISION": "int8", "ARTALK_AR_FUSED": "1"}}
STEP_SPAN = "pool.tick"


def _request(conn: http.client.HTTPConnection, method: str, path: str, body: bytes,
             ctype: str) -> bytes:
    """One request on ``conn``; any status but 200 raises."""
    conn.request(method, path, body=body, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise RuntimeError(f"{method} {path}: HTTP {resp.status} {data[:200]!r}")
    return data


def client_loop(port: int, windows: int, window_samples: int, seed: int, results: dict,
                barrier: threading.Barrier) -> None:
    """One client: open a session, post a warm-up chunk, wait for the other
    clients, then post ``windows`` chunks back to back, each answered before
    the next. Sets ``results[seed]`` to (latencies ms, start, end, the motion
    rows of every chunk, the warm-up's first)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=1800)
    try:
        sid = json.loads(_request(conn, "POST", "/v1/sessions", json.dumps({}).encode(),
                                  "application/json"))["sid"]
        rng = np.random.default_rng(seed)
        payload = (rng.standard_normal(window_samples).astype(np.float32) * 0.1).tobytes()
        path = f"/v1/sessions/{sid}/audio"
        rows = [json.loads(_request(conn, "POST", path, payload,
                                    "application/octet-stream"))["motion"]]
        barrier.wait()

        lat = []
        t_begin = time.perf_counter()
        for _ in range(windows):
            t0 = time.perf_counter()
            rows.append(json.loads(_request(conn, "POST", path, payload,
                                            "application/octet-stream"))["motion"])
            lat.append((time.perf_counter() - t0) * 1e3)
        t_end = time.perf_counter()
        _request(conn, "DELETE", f"/v1/sessions/{sid}", b"", "application/json")
        results[seed] = (lat, t_begin, t_end, np.asarray(rows, np.float32))
    except BaseException:
        barrier.abort()  # release lockstep peers instead of hanging the run
        raise
    finally:
        conn.close()


def run_clients(port: int, n: int, windows: int, window_samples: int) -> dict:
    """N clients (seeds 100 + i) against the server; the first error of any
    of them raises here. Returns ``client_loop``'s results by seed."""
    results: dict = {}
    errors: List[BaseException] = []

    def client(i: int) -> None:
        try:
            client_loop(port, windows, window_samples, 100 + i, results, barrier)
        except BaseException as exc:  # noqa: BLE001 — re-raised below, in the caller
            errors.append(exc)

    barrier = threading.Barrier(n)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"{len(errors)} of {n} clients failed") from errors[0]
    return results


def main(argv: Optional[list] = None, device: Union[str, torch.device] = "cuda",
         config: Optional[ModelConfig] = None) -> Dict[int, dict]:
    """Run the load test on ``device`` with ``config`` (default: the engine's,
    ``<ASSETS>/config.json`` or the production ``ModelConfig()``; weights
    from ``<ASSETS>/artalk_params.npz`` or random from seed 0). Returns per N
    the p50 and p90 ms, windows per second, the pool step's p50 ms, and each
    client's motion rows by seed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, nargs="*", default=[1, 4, 8, 16])
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--precision", default="int8", choices=list(PRECISION_ENV))
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    print(device_line(dev), flush=True)
    if dev.type == "cuda":
        build_kernels()

    cap = max(args.clients)
    engine = with_env(PRECISION_ENV[args.precision], lambda: ARTAvatarInferEngine(
        assets_dir=str(ASSETS), config=config, device=dev))
    server = MotionServer(engine, capacity=cap, max_sessions=cap)
    port = server.start(port=0)
    ws = server.pool.window_samples
    print(f"server up on :{port}  capacity={cap}  precision={args.precision}\n")

    out: Dict[int, dict] = {}
    try:
        for n in args.clients:
            GLOBAL_METRICS.reset()
            by_seed = run_clients(port, n, args.windows, ws)
            results = list(by_seed.values())
            lats = np.concatenate([r[0] for r in results])
            # saturated wall: barrier release (min timed-phase start) to the
            # last client's last response; the warm-up excluded
            wall = max(r[2] for r in results) - min(r[1] for r in results)
            p50, p90 = np.percentile(lats, [50, 90])
            sw_s = n * args.windows / wall   # session-windows per second (saturated)
            steps = [sp.duration_ns / 1e6 for sp in GLOBAL_METRICS.spans(STEP_SPAN)]
            step_ms = round(float(np.median(steps)), 2) if steps else 0.0
            print(f"N={n:3d}  chunk p50 {p50:7.1f} ms  p90 {p90:7.1f} ms  "
                  f"throughput {sw_s:6.1f} windows/s  "
                  f"~{sw_s * 4.0:6.0f} RT streams sustainable  "
                  f"(p50-bound RT sessions at this N: {n * 4000.0 / p50:6.0f})")
            print(f"       pool step p50 {step_ms:7.1f} ms", flush=True)
            out[n] = {"p50_ms": float(p50), "p90_ms": float(p90), "windows_per_s": sw_s,
                      "pool_step_p50_ms": step_ms,
                      "rows": {seed: r[3] for seed, r in by_seed.items()}}
    finally:
        server.close()
    return out


if __name__ == "__main__":
    main()
