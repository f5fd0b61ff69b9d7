"""Multi-session streaming: B live audio streams decoded in one batch.

Counterpart of ``artalk_tpu/serving.py``'s ``StreamPool``. Every active
session owns one row of a fixed-size batch, and each tick runs one batched
``window_step`` that advances all of them together. Joining or leaving a
session resets that session's row of the batched carry and style table.

Rows of sessions absent from a tick are stepped on silence to keep the batch
shape, and the previous carry is merged back for them with ``torch.where``,
so a paused session continues exactly where it stopped. (The JAX pool does
the same masking inside its jitted, donated step; the port runs eagerly.)

Spans (``utils/metrics.GLOBAL_METRICS``; each times the host): ``step`` is
one ``pool.tick`` (rows stepped = capacity, rows with audio), with the
children ``pool.pack`` (the host buffer), ``pool.upload`` (its copy to the
device), the window step's ``window.*`` and ``pool.download`` (the motion's
copy to the host, which waits for the device; with the thread's CPU time).
After the download the device-timed spans of the step (the Mimi encoder's
stages) get their ``device_us``.

The pool decodes in the model's precision mode (``BitwiseARModel.set_precision``),
with the routing rules of ``models/ar_model.kernel_takes``.

Usage::

    pool = StreamPool(model, max_sessions=8)        # model on its device
    sid = pool.open_session(style_motion=None)      # join (optional style)
    out = pool.step({sid: audio_chunk_16k})         # one tick, all sessions
    pool.close_session(sid)                         # leave

    python -m artalk_tpu_torch.serving -a audio.wav [--sessions 4] [--device cuda]
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.ar_model import BitwiseARModel, WindowState
from .utils.metrics import GLOBAL_METRICS


class StreamPool:
    """Fixed-capacity pool of concurrent streaming decode sessions.

    ``model`` holds its parameters on the device the pool runs on; with
    ``fused_ar`` the pool builds the model's weight packs once if it has
    none."""

    def __init__(self, model: BitwiseARModel, max_sessions: int = 4):
        self.model = model
        model.set_precision(model.cfg)
        self.device = model.pos_embed.device
        self.capacity = int(max_sessions)
        cfg = model.cfg
        null = model.encode_style(None)                       # (1, 1, d)
        self._null_style = null
        # per-slot style rows; row i is a session's conditioning token
        self._styles = null.repeat(self.capacity, 1, 1)
        self._state = model.initial_state(self._styles, batch_size=self.capacity)
        self._free: List[int] = list(range(self.capacity))[::-1]
        self._active: Dict[int, bool] = {}
        self.window_samples = model.window_samples
        self.fps = cfg.fps
        self.sample_rate = cfg.sample_rate

    # ------------------------------------------------------------- lifecycle

    def open_session(self, style_motion: Optional[np.ndarray] = None) -> int:
        """Claim a slot; returns the session id. Raises when full."""
        if not self._free:
            raise RuntimeError(
                f"StreamPool full ({self.capacity} sessions); close one first")
        sid = self._free.pop()
        if style_motion is None:
            style = self._null_style
        else:
            motion = torch.from_numpy(np.asarray(style_motion, np.float32))[None]
            style = self.model.encode_style(motion.to(self.device))
        self._styles[sid] = style[0]
        fresh = self.model.initial_state(style, batch_size=1)
        self._state.prev_bits[sid] = fresh.prev_bits[0]
        self._state.prev_attn_feat[sid] = fresh.prev_attn_feat[0]
        self._active[sid] = True
        return sid

    def close_session(self, sid: int) -> None:
        if self._active.pop(sid, None) is None:
            raise KeyError(f"unknown session {sid}")
        self._free.append(sid)

    def grow(self, new_capacity: int) -> None:
        """Raise capacity without losing live sessions: carries and styles
        keep their slot ids, the new slots join the free list. Shrinking is
        unsupported: closing sessions already frees slots, and compacting ids
        would rename live sessions under the caller."""
        new_capacity = int(new_capacity)
        if new_capacity <= self.capacity:
            raise ValueError(
                f"grow: new capacity {new_capacity} must exceed {self.capacity}")
        extra = new_capacity - self.capacity
        self._styles = torch.cat([self._styles, self._null_style.repeat(extra, 1, 1)])
        fresh = self.model.initial_state(self._null_style, batch_size=extra)
        self._state = WindowState(
            torch.cat([self._state.prev_bits, fresh.prev_bits]),
            torch.cat([self._state.prev_attn_feat, fresh.prev_attn_feat]))
        self._free = list(range(self.capacity, new_capacity))[::-1] + self._free
        self.capacity = new_capacity

    @property
    def active_sessions(self) -> List[int]:
        return sorted(self._active)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    # ------------------------------------------------------------------ tick

    def device_step(self, audio: torch.Tensor, stepped: torch.Tensor
                    ) -> Tuple[WindowState, torch.Tensor]:
        """The tick's device work, on device tensors: one batched window step
        of ``audio`` (capacity, window_samples), then the carry of each row
        where ``stepped`` (capacity,) bool is False put back. Commits and
        returns the new carry, with the motion (capacity, window, 106) on the
        device. Counterpart of the JAX pool's jitted ``_masked_step``."""
        new_state, motion = self.model.window_step(self._state, audio, self._styles)
        m = stepped[:, None, None]
        self._state = WindowState(
            torch.where(m, new_state.prev_bits, self._state.prev_bits),
            torch.where(m, new_state.prev_attn_feat, self._state.prev_attn_feat))
        return self._state, motion

    def step(self, chunks: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        """Advance the sessions in ``chunks`` by one 4-s window.

        chunks: session id -> 1-D 16 kHz audio (<= window_samples; shorter
        chunks are zero-padded, as in ``engine.stream``). Sessions not in
        ``chunks`` idle this tick: their carry is kept. Returns session id ->
        (ceil(valid_samples / 640), 106) raw motion."""
        with GLOBAL_METRICS.span("pool.tick", rows_stepped=self.capacity,
                                 rows_with_audio=len(chunks)):
            unknown = [s for s in chunks if s not in self._active]
            if unknown:
                raise KeyError(f"unknown session(s) {unknown}")
            with GLOBAL_METRICS.span("pool.pack"):
                ws = self.window_samples
                buf = np.zeros((self.capacity, ws), np.float32)
                n_valid: Dict[int, int] = {}
                for sid, chunk in chunks.items():
                    chunk = np.asarray(chunk, np.float32).reshape(-1)
                    if len(chunk) > ws:
                        # dropping the tail would put audio and motion out of
                        # step by the excess every tick: make the caller split
                        raise ValueError(
                            f"session {sid}: chunk of {len(chunk)} samples exceeds "
                            f"the {ws}-sample window; split it across ticks")
                    buf[sid, : len(chunk)] = chunk
                    n_valid[sid] = len(chunk)
                stepped = torch.zeros(self.capacity, dtype=torch.bool)
                stepped[list(chunks)] = True
            with GLOBAL_METRICS.span("pool.upload"):
                audio, stepped = torch.from_numpy(buf).to(self.device), stepped.to(self.device)
            _, motion = self.device_step(audio, stepped)
            with GLOBAL_METRICS.span("pool.download", cpu_time=True):
                host_motion = motion.cpu().numpy()
            GLOBAL_METRICS.read_device_times()
            return {sid: host_motion[sid, : math.ceil(n / self.sample_rate * self.fps)]
                    for sid, n in n_valid.items()}


def _demo(argv=None) -> None:
    """N concurrent sessions streaming one WAV, with per-tick latency.

    python -m artalk_tpu_torch.serving -a audio.wav [--sessions 4] [--device cuda]
    Random-init weights unless <assets>/artalk_params.npz exists; the
    precision switches are read from the environment as by the engine."""
    import argparse
    import os
    import time

    from .config import assets_config, precision_from_env
    from .utils.audio import load_audio_16k_mono
    from .utils.params import load_model

    ap = argparse.ArgumentParser(description=_demo.__doc__)
    ap.add_argument("--audio_path", "-a", required=True)
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--assets", default="assets")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.sessions < 1:
        ap.error("--sessions must be >= 1")

    model = load_model(precision_from_env(assets_config(args.assets)),
                       checkpoint=os.path.join(args.assets, "artalk_params.npz"),
                       device=args.device)
    pool = StreamPool(model, max_sessions=args.sessions)
    audio = load_audio_16k_mono(args.audio_path)
    ws = pool.window_samples
    windows = [audio[i:i + ws] for i in range(0, len(audio), ws)]

    sids = [pool.open_session() for _ in range(args.sessions)]
    total_frames, t_start = 0, None
    for tick, chunk in enumerate(windows):
        t0 = time.perf_counter()
        out = pool.step({s: chunk for s in sids})
        ms = (time.perf_counter() - t0) * 1000.0
        tag = "  (includes the kernels' first build)" if tick == 0 else ""
        print(f"tick {tick}: {len(out)} sessions, {ms:.1f} ms "
              f"({ms / len(out):.1f} ms/session){tag}")
        if tick == 0:
            t_start = time.perf_counter()
        else:
            total_frames += sum(o.shape[0] for o in out.values())
    if total_frames:
        elapsed = time.perf_counter() - t_start
        print(f"steady state: {total_frames} motion frames in {elapsed:.2f} s "
              f"= {total_frames / elapsed:.0f} frames/s (host copies included)")


if __name__ == "__main__":
    _demo()
