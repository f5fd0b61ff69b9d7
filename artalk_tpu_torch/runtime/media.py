"""ctypes bindings for the native media kernels (+ NumPy fallbacks).

Counterpart of ``artalk_tpu/runtime/media.py``: the same functions, the same
fallbacks, and the C++ source copied into ``native/media.cpp``. The library
is declared and built as the port's other native libraries are
(``ops/_nvcc.py``), with ``-O3 -march=native`` (the JAX package's flags, so
both resample to the same samples on one host), at first use. Where it does
not build (no compiler), every entry point takes its fallback.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._nvcc import Library

_I64 = ctypes.c_int64
LIB = Library(Path(__file__).resolve().parent / "native" / "media.cpp", {
    "rgb_to_yuv420": (ctypes.c_int, [ctypes.c_void_p, _I64, _I64, _I64, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]),
    "write_y4m": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_void_p, _I64, _I64, _I64,
                                 ctypes.c_int, ctypes.c_int]),
    "resample_poly_f32": (_I64, [ctypes.c_void_p, _I64, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])},
    flags=("-O3", "-march=native"))
_build_failed = False


def _get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None (after one notice) where it does not build."""
    global _build_failed
    if _build_failed:
        return None
    try:
        return LIB.get()
    except (RuntimeError, OSError) as e:
        _build_failed = True
        print(f"[artalk_tpu_torch.runtime] native build failed ({e}); using NumPy fallbacks")
        return None


def native_available() -> bool:
    return _get_lib() is not None


# ---------------------------------------------------------------------------
# RGB -> YUV420
# ---------------------------------------------------------------------------


def _rgb_to_yuv420_numpy(frames: np.ndarray):
    f = frames.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = np.clip(0.299 * r + 0.587 * g + 0.114 * b + 0.5, 0, 255).astype(np.uint8)
    t, h, w, _ = frames.shape
    blocks = f.reshape(t, h // 2, 2, w // 2, 2, 3).mean(axis=(2, 4))
    rb, gb, bb = blocks[..., 0], blocks[..., 1], blocks[..., 2]
    u = np.clip(-0.168736 * rb - 0.331264 * gb + 0.5 * bb + 128.0 + 0.5, 0, 255)
    v = np.clip(0.5 * rb - 0.418688 * gb - 0.081312 * bb + 128.0 + 0.5, 0, 255)
    return y, u.astype(np.uint8), v.astype(np.uint8)


def rgb_to_yuv420(frames: np.ndarray):
    """(T, H, W, 3) uint8 RGB -> (Y (T,H,W), U (T,H/2,W/2), V) uint8 planes."""
    frames = np.ascontiguousarray(frames, np.uint8)
    t, h, w, _ = frames.shape
    if h % 2 or w % 2:
        raise ValueError(f"rgb_to_yuv420: height and width must be even, got {h}x{w}")
    lib = _get_lib()
    if lib is None:
        return _rgb_to_yuv420_numpy(frames)
    y = np.empty((t, h, w), np.uint8)
    u = np.empty((t, h // 2, w // 2), np.uint8)
    v = np.empty((t, h // 2, w // 2), np.uint8)
    lib.rgb_to_yuv420(frames.ctypes.data, t, h, w,
                      y.ctypes.data, u.ctypes.data, v.ctypes.data)
    return y, u, v


def _fps_rational(fps: float):
    return (int(fps), 1) if float(fps).is_integer() else \
        (int(round(fps * 1001)), 1001)


def _y4m_header(w: int, h: int, fps_num: int, fps_den: int) -> bytes:
    return f"YUV4MPEG2 W{w} H{h} F{fps_num}:{fps_den} Ip A1:1 C420jpeg\n".encode()


def write_y4m_planar(path: str, frames: np.ndarray, fps: float = 25.0) -> str:
    """Write a YUV4MPEG2 file from planar yuv420p frames (T, H * 3 // 2, W)
    uint8 -- the renderers' output (ops/colorspace.py) -- with no conversion."""
    frames = np.ascontiguousarray(frames, np.uint8)
    t, h32, w = frames.shape
    h = h32 * 2 // 3
    fps_num, fps_den = _fps_rational(fps)
    with open(path, "wb") as f:
        f.write(_y4m_header(w, h, fps_num, fps_den))
        for i in range(t):
            f.write(b"FRAME\n")
            f.write(frames[i].tobytes())
    return path


def write_y4m(path: str, frames: np.ndarray, fps: float = 25.0) -> str:
    """Write a YUV4MPEG2 file (codec-free, playable by mpv/ffplay/VLC) from
    (T, H, W, 3) uint8 RGB frames."""
    frames = np.ascontiguousarray(frames, np.uint8)
    t, h, w, _ = frames.shape
    fps_num, fps_den = _fps_rational(fps)
    lib = _get_lib()
    if lib is not None:
        rc = lib.write_y4m(path.encode(), frames.ctypes.data, t, h, w,
                           fps_num, fps_den)
        if rc != 0:
            raise RuntimeError(f"write_y4m failed with code {rc}")
        return path
    y, u, v = _rgb_to_yuv420_numpy(frames)
    with open(path, "wb") as f:
        f.write(_y4m_header(w, h, fps_num, fps_den))
        for i in range(t):
            f.write(b"FRAME\n")
            f.write(y[i].tobytes())
            f.write(u[i].tobytes())
            f.write(v[i].tobytes())
    return path


# ---------------------------------------------------------------------------
# Audio resampling
# ---------------------------------------------------------------------------


def resample_poly(audio: np.ndarray, up: int, down: int) -> np.ndarray:
    """Rational polyphase resample of 1-D float32 audio (a Kaiser-windowed
    sinc, scipy's defaults; scipy itself when no compiler is found)."""
    audio = np.ascontiguousarray(audio, np.float32).reshape(-1)
    lib = _get_lib()
    if lib is None:
        from scipy.signal import resample_poly as sp

        return sp(audio, up, down).astype(np.float32)
    out_len = (len(audio) * up + down - 1) // down
    out = np.empty(out_len, np.float32)
    n = lib.resample_poly_f32(audio.ctypes.data, len(audio), up, down,
                              out.ctypes.data)
    return out[:n]
