"""Real-time streaming clients, in a process of their own (never a thread of
the server): one thread per session, each on its own keep-alive HTTP
connection, posting raw float32 PCM chunks to
``/v1/sessions/<sid>/audio`` on an open-loop schedule.

    python3 -m benchmark.clients     (reads its job as one JSON line on stdin)

The job: the server's port, the sessions (id and index), the traffic
parameters and seed, the window's start and length on the monotonic clock
(shared by every process of the machine), and which sessions' motion to send
back. The process connects every session first (a session is opened in
set-up, and so is its connection: the server's listen queue is short, and a
burst of connects inside the window would wait for the client's SYN to be
sent again, 1 s and 3 s later), then prints "ready", waits for its job's start, and at the end
prints one JSON line: per chunk (session, k, due, sent, done, status) and
the motion of the sampled sessions. A chunk is due when its audio would be
complete in real time; it is sent then, or when the session's previous chunk
returns if that is later. Chunks due before the window's end are sent; each
is awaited at most ``timeout_s``.
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time

from benchmark import traffic


def connect(job: dict) -> http.client.HTTPConnection:
    return http.client.HTTPConnection("127.0.0.1", job["port"], timeout=job["timeout_s"])


def run_session(job: dict, conn: http.client.HTTPConnection, sid: int, index: int,
                out: list, motions: dict) -> None:
    tr, seed = job["traffic"], job["seed"]
    start = job["start"]
    keep = index in job["sampled"]
    for k, due_rel in enumerate(traffic.chunk_dues(tr, seed, index, job["seconds"])):
        due = start + due_rel
        body = traffic.chunk_audio(tr, seed, index, k).tobytes()
        wait = due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        sent = time.monotonic()
        status, frames = 0, 0
        try:
            conn.request("POST", f"/v1/sessions/{sid}/audio", body=body,
                         headers={"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            data = resp.read()
            status = resp.status
            if status == 200:
                reply = json.loads(data)
                frames = reply["frames"]
                if keep:
                    motions.setdefault(index, {})[k] = reply["motion"]
        except (OSError, http.client.HTTPException, ValueError):
            conn.close()
            conn = connect(job)
        out.append([index, k, due, sent, time.monotonic(), status, frames])
    conn.close()


def main() -> int:
    job = json.loads(sys.stdin.readline())
    n = int(round(job["traffic"]["chunk_seconds"] * traffic.SAMPLE_RATE))
    for pick in range(int(job["traffic"]["distinct_chunks"])):
        traffic.distinct_chunk(job["seed"], pick, n)
    conns = [connect(job) for _ in job["sids"]]
    for conn in conns:
        conn.connect()
    print("ready", flush=True)
    go = json.loads(sys.stdin.readline())
    job.update(go)
    out: list = []
    motions: dict = {}
    threads = [threading.Thread(target=run_session, args=(job, conn, sid, index, out, motions))
               for conn, sid, index in zip(conns, job["sids"], job["sessions"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(json.dumps({"chunks": out, "motions": {str(k): v for k, v in motions.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
