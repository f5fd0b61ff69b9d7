"""The JSON body of a motion reply, written by host code off the interpreter
lock.

``MotionJSON().encode(rows)`` gives exactly the bytes of
``json.dumps({"frames": len(rows), "motion": rows.tolist()}).encode()`` for a
float32 (frames, width) array, written by ``csrc/motion_json.cpp`` (shortest
round-trip digits laid out as ``repr(float)``). The library is built with
the host compiler at first use (``ops/_nvcc.py``) and called through
``ctypes.CDLL``, which releases the interpreter lock for the call, so request
threads encoding replies leave the lock to the threads that launch work on
the card: ``json.dumps`` holds it for the whole body.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ._nvcc import CSRC, build_library

SOURCE = CSRC / "motion_json.cpp"
# '{"frames": ', up to 20 digits, ', "motion": [' and ']}'
HEAD_MAX = 64
# a row's '[', ']' and the ', ' before it
ROW_EXTRA = 4
# the ', ' before a value
SEP = 2


class MotionJSON:
    """The loaded writer; making one builds the library, or finds it built."""

    def __init__(self):
        lib, _, _ = build_library(SOURCE)
        lib.motion_json_value_max.argtypes = []
        lib.motion_json_value_max.restype = ctypes.c_int
        self.value_max = lib.motion_json_value_max()
        fn = lib.motion_json
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64]
        fn.restype = ctypes.c_int64
        self._write = fn

    def bound(self, frames: int, width: int) -> int:
        """Bytes enough for the body of any float32 (frames, width) array:
        no value is longer than ``value_max``."""
        return HEAD_MAX + frames * (ROW_EXTRA + width * (self.value_max + SEP))

    def encode(self, rows: np.ndarray) -> memoryview:
        """The body for ``rows``, a float32 (frames, width) array, in one
        buffer of ``bound`` bytes. Raises TypeError for another dtype or
        rank."""
        if rows.dtype != np.float32 or rows.ndim != 2:
            raise TypeError(f"want float32 (frames, width) rows, got {rows.dtype} "
                            f"{rows.shape}")
        rows = np.ascontiguousarray(rows)
        frames, width = rows.shape
        buf = np.empty(self.bound(frames, width), np.uint8)
        n = self._write(rows.ctypes.data, frames, width, buf.ctypes.data, buf.size)
        if n < 0:
            raise RuntimeError(f"the body of {rows.shape} rows overran its bound")
        return memoryview(buf)[:n]
