"""Host-side audio I/O: WAV loading and resampling to the model's 16 kHz mono.

Copied from ``artalk_tpu/utils/audio.py``. Resampling goes through the
port's native polyphase resampler (``runtime/media.py``; scipy's
``resample_poly`` when g++ is missing), as the JAX package's does.
"""

from __future__ import annotations

import math
import wave
from typing import Tuple

import numpy as np

TARGET_SR = 16000


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples (channels, T) in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        channels = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    return data.reshape(-1, channels).T, sr


def resample(audio: np.ndarray, orig_sr: int, target_sr: int = TARGET_SR) -> np.ndarray:
    """Polyphase resample along the last axis (the native C++ kernel when
    built, scipy otherwise -- see ``runtime/media.py``)."""
    if orig_sr == target_sr:
        return audio
    from ..runtime import media

    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    flat = np.asarray(audio, np.float32).reshape(-1, audio.shape[-1])
    out = np.stack([media.resample_poly(row, up, down) for row in flat])
    return out.reshape(audio.shape[:-1] + (out.shape[-1],)).astype(np.float32)


def load_audio_16k_mono(path: str) -> np.ndarray:
    """Load any WAV -> float32 mono 16 kHz (reference: inference.py:230-231,
    resample then channel-mean)."""
    audio, sr = load_wav(path)
    audio = resample(audio, sr, TARGET_SR)
    return audio.mean(axis=0).astype(np.float32)
