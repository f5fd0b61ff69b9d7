"""The seeded traffic of every cell, from the parameters of its cell file.

One generator serves every mix; a cell file's ``traffic`` group gives its
numbers:

- offline clips (``"kind": "offline"``): ``clip_seconds`` [lo, hi] and
  ``strata``. The clip lengths are the ``strata`` quantiles of the
  log-uniform law on [lo, hi] (at (i + 0.5) / strata), in the same order on
  every seed: the radical-inverse (bit-reversed) order of the strata, so
  that short and long clips alternate and every stretch of the list holds
  an even share of lengths. A window that ends inside the list ends at
  about the same clip on every seed, so two seeds time the same mix; the
  seed draws only the audio.
- real-time sessions (``"kind": "stream"``): ``sessions`` sessions that each
  send one ``chunk_seconds`` chunk every ``period_s``, their phases spread
  evenly over ``phase_spread_s`` and dealt to the sessions by the seed.

Audio is speech-like from the seed: a voiced source (f0 drifting in 90-260
Hz, its first 12 harmonics falling off as 1/k) under a syllable envelope of
3-6 Hz with pauses, plus a little noise, at 16 kHz and about -20 dBFS.
"""

from __future__ import annotations

import functools
import math
from typing import List

import numpy as np

SAMPLE_RATE = 16000


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, *tags]))


def speech_like(seed: int, tag: int, n: int, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """``n`` samples of float32 speech-like audio, the same for the same
    (seed, tag)."""
    rng = _rng(seed, 7, tag)
    t = np.arange(n) / sample_rate
    knots = max(2, int(n / sample_rate * 4) + 2)
    f0 = np.interp(t, np.linspace(0, t[-1] if n > 1 else 1.0, knots),
                   rng.uniform(90.0, 260.0, knots))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    k = np.arange(1, 13)[:, None]
    voiced = (np.sin(k * phase[None] + rng.uniform(0, 2 * np.pi, (12, 1))) / k).sum(0)
    rate = rng.uniform(3.0, 6.0)
    env = np.clip(np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi)), 0.0, None) ** 2
    pauses = np.interp(t, np.linspace(0, max(t[-1], 1e-3), knots),
                       (rng.random(knots) > 0.2).astype(float))
    audio = voiced * env * pauses + 0.02 * rng.standard_normal(n)
    return (0.1 * audio / (np.abs(audio).max() + 1e-9)).astype(np.float32)


def radical_inverse(i: int) -> float:
    """``i``'s binary digits mirrored about the point: 1 -> 0.5, 2 -> 0.25,
    3 -> 0.75."""
    out, scale = 0.0, 0.5
    while i:
        out += scale * (i & 1)
        i >>= 1
        scale /= 2
    return out


def clip_seconds(traffic: dict) -> List[float]:
    """The offline clip lengths in seconds, in their order: the same list on
    every seed."""
    lo, hi = traffic["clip_seconds"]
    n = int(traffic["strata"])
    q = (np.arange(n) + 0.5) / n
    lengths = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
    order = sorted(range(n), key=radical_inverse)
    return [float(lengths[i]) for i in order]


def clip_audio(traffic: dict, seed: int) -> List[np.ndarray]:
    """The audio of each clip, in order; clip i of the window is clip
    i % strata of this list."""
    return [speech_like(seed, 1000 + i, int(round(s * SAMPLE_RATE)))
            for i, s in enumerate(clip_seconds(traffic))]


def session_phases(traffic: dict, seed: int) -> np.ndarray:
    """(sessions,) seconds after the window's start at which each session's
    first chunk is due."""
    n = int(traffic["sessions"])
    spread = float(traffic["phase_spread_s"])
    even = (np.arange(n) + 0.5) / n * spread
    return even[_rng(seed, 2).permutation(n)]


def chunk_dues(traffic: dict, seed: int, session: int, until_s: float) -> List[float]:
    """Due times (seconds after the window's start) of one session's chunks
    that fall before ``until_s``."""
    first = session_phases(traffic, seed)[session]
    period = float(traffic["period_s"])
    return [first + k * period for k in range(max(0, math.ceil((until_s - first) / period)))]


def chunk_audio(traffic: dict, seed: int, session: int, k: int) -> np.ndarray:
    """Chunk ``k`` of a session: one of ``distinct_chunks`` seeded chunks,
    chosen by the seed (sessions reuse chunks; each chunk is still decoded in
    its session's own state)."""
    pool = int(traffic["distinct_chunks"])
    pick = int(_rng(seed, 3, session, k).integers(pool))
    return distinct_chunk(seed, pick, int(round(traffic["chunk_seconds"] * SAMPLE_RATE)))


@functools.lru_cache(maxsize=64)
def distinct_chunk(seed: int, pick: int, n: int) -> np.ndarray:
    chunk = speech_like(seed, 5000 + pick, n)
    chunk.setflags(write=False)
    return chunk
