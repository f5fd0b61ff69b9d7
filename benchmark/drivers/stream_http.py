"""Real-time streaming over HTTP, as ``python -m artalk_tpu_torch.server``
serves it: an in-process ``MotionServer`` on 127.0.0.1 (pool capacity =
max sessions = the cell's sessions, the default 5 ms tick), and client
processes that post each session's 4-s chunks on an open-loop schedule
(``benchmark/clients.py``).

Set-up opens every session, steps the pool twice at capacity (which builds
and warms the fused kernels), and starts the clients. The window sends every
chunk due in it; each chunk's latency runs from when it was due to when its
client has the parsed motion, and a chunk that fails, is refused or times
out counts as +inf. ``window_p95_ms`` and ``window_p50_ms`` are taken over
all of them.

The check follows a few sessions drawn from the seed through every pool step
that carried their audio (the warm-up ticks too): the decisions the pool
served are read on the instance (``decode_window``'s bits and the carry
``vae.encode_to_bits`` returns), and the motion compared is what the
clients received.
"""

from __future__ import annotations

import json
import subprocess
import sys
import numpy as np
import torch

from benchmark import harness, judge, program, traffic, work
from benchmark.reference.motion import FP32, MotionReference, Precision
from benchmark.reference.params import make_params, motion_spec

WARM_TICKS = 2
SAMPLED = 4


class Recorder:
    """What the pool did for the sampled sessions, read on the instance."""

    def __init__(self):
        self.sampled = set()                         # session ids followed by the check
        self.last_bits = None
        self.last_carry = None
        self.carry0 = {}                             # sid -> its bootstrap carry bits
        self.steps = {}                              # sid -> [(audio, bits, carry)]
        self.window_open = False
        self.trace_from = float("inf")
        self.restore = []


def _attach(ctx, server, rec: Recorder) -> None:
    """Read the pool's decisions on the instance, and keep one span of each
    ``StreamPool.step`` (its info: rows with audio, whether it ran traced)
    and of each ``batcher.submit`` (its info: the session id)."""
    model, pool, batcher = server.engine.model, server.pool, server.batcher
    dec, enc, opener = model.decode_window, model.vae.encode_to_bits, pool.open_session

    def decode_window(*a, **k):
        rec.last_bits = dec(*a, **k)
        return rec.last_bits

    def encode_to_bits(*a, **k):
        out = enc(*a, **k)
        rec.last_carry = out[0]
        return out

    def open_session(*a, **k):
        sid = opener(*a, **k)
        rec.carry0[sid] = rec.last_carry[0].clone()
        return sid

    model.decode_window = decode_window
    model.vae.encode_to_bits = encode_to_bits
    pool.open_session = open_session
    rec.restore = [(model, "decode_window"), (model.vae, "encode_to_bits")]

    def before_step(chunks):
        if (ctx.tracer.traced and ctx.tracer.prof is None and ctx.tracer.trace is None
                and rec.window_open and harness.clock() >= rec.trace_from):
            ctx.tracer.start()

    def after_step(out, chunks):
        for sid in rec.sampled & set(chunks):
            rec.steps[sid].append((np.asarray(chunks[sid], np.float32),
                                   rec.last_bits[sid].clone(), rec.last_carry[sid].clone()))
        info = (len(chunks), ctx.tracer.prof is not None)
        if ctx.tracer.due():
            ctx.tracer.stop()
        return info

    ctx.spans.wrap(pool, "step", "pool.step", before=before_step, after=after_step)
    ctx.spans.wrap(batcher, "submit", "batcher.submit", after=lambda out, sid, *a, **k: sid)


def start_clients(ctx, state) -> None:
    tr = ctx.cell["traffic"]
    n, procs = int(tr["sessions"]), int(tr["client_processes"])
    sids = state["sids"]
    state["clients"] = []
    for p in range(procs):
        idx = list(range(p, n, procs))
        job = {"port": state["port"], "seed": ctx.seed, "traffic": tr, "seconds": ctx.seconds,
               "timeout_s": float(tr["timeout_s"]), "sessions": idx,
               "sids": [sids[i] for i in idx], "sampled": state["sampled"]}
        proc = subprocess.Popen([sys.executable, "-m", "benchmark.clients"],
                                cwd=str(harness.ROOT), stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        proc.stdin.write(json.dumps(job) + "\n")
        proc.stdin.flush()
        state["clients"].append(proc)
    for proc in state["clients"]:
        if proc.stdout.readline().strip() != "ready":
            raise harness.BenchmarkError("a client process did not start")


def make_server(ctx, engine, sessions: int):
    from artalk_tpu_torch.server import MotionServer

    return MotionServer(engine=engine, capacity=sessions, max_sessions=sessions,
                        tick_ms=float(ctx.cell["tick_ms"]))


def setup(ctx, engine=None):
    tr = ctx.cell["traffic"]
    n = int(tr["sessions"])
    if engine is None:
        engine = program.build_engine(ctx.model, ctx.cell, ctx.seed, ctx.device)
    server = make_server(ctx, engine, n)
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed % 2**64, 21]))
    sampled = sorted(rng.choice(n, size=min(SAMPLED, n), replace=False).tolist())
    rec = Recorder()
    _attach(ctx, server, rec)
    sids = [server.open_session() for _ in range(n)]
    rec.sampled = {sids[i] for i in sampled}
    rec.steps = {sids[i]: [] for i in sampled}
    port = server.start(0)
    warm = traffic.speech_like(ctx.seed, 99, int(tr["chunk_seconds"] * traffic.SAMPLE_RATE))
    with torch.no_grad():
        for _ in range(WARM_TICKS):
            server.pool.step({sid: warm for sid in sids})
    state = {"engine": engine, "server": server, "rec": rec, "sids": sids, "port": port,
             "sampled": sampled}
    start_clients(ctx, state)
    return state


def window(ctx, state) -> dict:
    rec = state["rec"]
    start = harness.clock() + 0.5
    for proc in state["clients"]:
        proc.stdin.write(json.dumps({"start": start}) + "\n")
        proc.stdin.flush()
    rec.trace_from = start + ctx.seconds / 4   # a traced run profiles ticks past the start
    rec.window_open = True
    results = [json.loads(proc.stdout.readline()) for proc in state["clients"]]
    for proc in state["clients"]:
        proc.wait(timeout=60)
    rec.window_open = False
    ctx.tracer.stop()
    chunks = [c for r in results for c in r["chunks"]]
    received = {}
    for r in results:
        for index, by_k in r["motions"].items():
            received[int(index)] = {int(k): np.asarray(v, np.float32) for k, v in by_k.items()}
    lat = [(done - due) * 1e3 if status == 200 else float("inf")
           for _, _, due, _, done, status, _ in chunks]
    late = sorted((sent - due) * 1e3 for _, _, due, sent, _, _, _ in chunks)
    ontime = [x for x in late if x < 1000.0]
    print(f"generator lateness ms (sends not held by an earlier chunk): "
          f"p50 {harness.percentile(ontime, 50):.3f} p95 {harness.percentile(ontime, 95):.3f} "
          f"max {max(ontime) if ontime else float('nan'):.3f}; {len(late) - len(ontime)} of "
          f"{len(late)} sends held over 1 s by a chunk in flight", file=sys.stderr)
    state.update(chunks=chunks, received=received, start=start)
    failed = sum(1 for c in chunks if c[5] != 200)
    return {"attempted": len(chunks), "failed": failed,
            "metrics": {"window_p95_ms": harness.percentile(lat, 95),
                        "window_p50_ms": harness.percentile(lat, 50)}}


def release(state) -> None:
    for proc in state.get("clients", []):
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    server = state.pop("server", None)
    if server is not None:
        server.close()
    for obj, name in state["rec"].restore:   # the model's own methods again
        obj.__dict__.pop(name, None)
    state.pop("engine", None)


# ----------------------------------------------------------------- the check


def _follow(ctx, state, prec: Precision) -> dict:
    """The reference's logits, carry latents and raw motion along every
    recorded step of each sampled session, from its bootstrap carry."""
    model, device = ctx.model, ctx.device
    ref = MotionReference(model, make_params(motion_spec(model), ctx.seed, device), prec)
    rec = state["rec"]
    out = {}
    for sid, steps in sorted(rec.steps.items()):
        audio = torch.from_numpy(np.stack([a for a, _, _ in steps])).to(device)
        served = [(b, c) for _, b, c in steps]
        out[sid] = {"followed": ref.follow(audio, served, rec.carry0[sid]),
                    "latent0": ref.initial_latent(rec.carry0[sid], device),
                    "served": served}
    return out


def _matched(ctx, state, sid: int, followed: dict) -> tuple:
    """(received motions, the reference's motion of the same steps): each
    received chunk k is matched, in order, to the next recorded step whose
    audio is chunk k's."""
    index = state["sids"].index(sid)
    steps = state["rec"].steps[sid]
    got = state["received"].get(index, {})
    tr = ctx.cell["traffic"]
    w = ctx.model["vae"]["patch_nums"][-1]
    prog, ref, j = [], [], WARM_TICKS
    for k in sorted(got):
        audio = traffic.chunk_audio(tr, ctx.seed, index, k)
        while j < len(steps) and not np.array_equal(steps[j][0], audio):
            j += 1
        if j == len(steps):
            break
        frames = got[k].shape[0]
        prog.append(got[k])
        ref.append(followed["motion"][j * w:j * w + frames].cpu().numpy())
        j += 1
    return prog, ref


def numbers_of(ctx, state, ref: dict, candidate: dict | None = None) -> dict:
    """The compared numbers of the program (``candidate`` None: its served
    decisions and the motion its clients received) or of a lower-precision
    reference in its place, against the reference."""
    sids = sorted(ref)
    if candidate is None:
        served = [ref[s]["served"] for s in sids]
        carry0 = [state["rec"].carry0[s] for s in sids]
    else:
        served = [judge.control_decisions(candidate[s]["followed"]) for s in sids]
        carry0 = [(candidate[s]["latent0"] > 0).to(torch.int32) for s in sids]
    motions, refs, checked = [], [], 0
    for s in sids:
        got, ref_motion = _matched(ctx, state, s, ref[s]["followed"])
        if candidate is not None:
            got = _matched(ctx, state, s, candidate[s]["followed"])[1]
        checked += len(ref_motion)
        motions.append(np.concatenate(got) if got else None)
        refs.append(np.concatenate(ref_motion) if ref_motion else None)
    nums = judge.stream_numbers([ref[s]["followed"] for s in sids], served, carry0,
                                [ref[s]["latent0"] for s in sids], motions, refs)
    nums["chunks_checked"] = checked
    return nums


def _fp32_reference(ctx, state) -> dict:
    if "ref" not in state:
        state["ref"] = _follow(ctx, state, FP32)
    return state["ref"]


def program_numbers(ctx, state) -> dict:
    return numbers_of(ctx, state, _fp32_reference(ctx, state))


def check(ctx, state) -> tuple:
    nums = program_numbers(ctx, state)
    ok, rows = judge.verdict(nums, ctx.cell["limits"])
    ok = ok and nums["chunks_checked"] > 0
    return ok, rows + [("chunks_checked", nums["chunks_checked"], None)]


def control(ctx, state, prec: Precision) -> dict:
    return numbers_of(ctx, state, _fp32_reference(ctx, state), _follow(ctx, state, prec))


# ----------------------------------------------------------- layer readings


def window_ticks(ctx, state) -> list:
    """The ``pool.step`` spans of the window that returned (set-up's warm-up
    ticks left out)."""
    return [t for t in ctx.spans.of("pool.step", since=state["start"]) if t.info is not None]


def layer_data(ctx, state) -> dict:
    """The ticks after the traced stretch, the client chunks matched to
    their ``batcher.submit`` spans, and the work from shapes."""
    model = ctx.model
    window = window_ticks(ctx, state)
    ticks = [t for t in window if not t.info[1]] or window
    by_sid = {}
    for sp in ctx.spans.of("batcher.submit", since=state["start"]):
        by_sid.setdefault(sp.info, []).append((sp.start, sp.end))
    fronts = []
    for index, _, _, sent, done, status, _ in state["chunks"]:
        if status != 200:
            continue
        for t0, t1 in by_sid.get(state["sids"][index], []):
            if sent <= t0 and t1 <= done:
                fronts.append(((done - sent) - (t1 - t0)) * 1e3)
                break
    return {"ticks": ticks, "fronts": fronts,
            "traced_ticks": sum(1 for t in window if t.info[1]),
            "capacity": int(ctx.cell["traffic"]["sessions"]), "model": model,
            "step_flops": work.window_step_flops(model, model["window_samples"])}
