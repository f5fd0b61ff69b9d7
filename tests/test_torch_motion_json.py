"""The native writer of the motion replies (``ops/motion_json.py``,
``csrc/motion_json.cpp``), built with the host compiler: its body is byte for
byte ``json.dumps({"frames": F, "motion": rows.tolist()}).encode()`` on
motion-shaped rows, random float32 bit patterns (subnormals included), the
special values and the neighbours of the edges of repr's fixed notation; no
value is longer than the bound the buffer is sized by, and the bound is
reached; the call goes through ``ctypes.CDLL``, which drops the interpreter
lock."""

import ctypes
import json
import sys
import threading

import numpy as np
import pytest

from artalk_tpu_torch.ops.motion_json import MotionJSON

F32 = np.float32


@pytest.fixture(scope="module")
def writer():
    return MotionJSON()


def _dumps(rows: np.ndarray) -> bytes:
    return json.dumps({"frames": int(rows.shape[0]), "motion": rows.tolist()}).encode()


def _edges() -> np.ndarray:
    """Specials and the float32 neighbours of 1e-4 and 1e16, where repr's
    layout turns between fixed and exponent notation."""
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e16, -1e16, 1e-4, 1e-45, -1e-45,
               np.finfo(F32).max, -np.finfo(F32).max, np.finfo(F32).tiny,
               np.finfo(F32).smallest_subnormal, 1.0, -1.0, 0.1, 123456789.0, 1e15]
    vals = [F32(v) for v in special]
    for edge in (1e-4, 1e16, 1e15, 1e-3):
        for sign in (1, -1):
            v = F32(sign * edge)
            for _ in range(4):
                vals.append(v)
                v = np.nextafter(v, F32(0))
            v = F32(sign * edge)
            for _ in range(4):
                v = np.nextafter(v, F32(sign * np.inf))
                vals.append(v)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF], np.uint32).view(F32)
    return np.concatenate([np.array(vals, F32), nans])


@pytest.mark.parametrize("shape", [(1, 106), (100, 106), (37, 12)])
def test_motion_rows_equal_json_dumps(writer, shape):
    rng = np.random.default_rng(sum(shape))
    rows = (rng.standard_normal(shape) * rng.choice([1e-3, 0.3, 5.0], size=shape)).astype(F32)
    assert bytes(writer.encode(rows)) == _dumps(rows)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_bit_patterns_equal_json_dumps(writer, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2 ** 32, size=(100, 106), dtype=np.uint64).astype(np.uint32).view(F32)
    # a quarter of the values subnormal, with the sign bit random
    sub = rng.random(rows.shape) < 0.25
    rows[sub] = (rows[sub].view(np.uint32) & np.uint32(0x807FFFFF)).view(F32)
    assert np.isnan(rows).any() and (np.abs(rows[np.isfinite(rows)]) < np.finfo(F32).tiny).any()
    assert bytes(writer.encode(rows)) == _dumps(rows)


def test_special_values_and_layout_edges_equal_json_dumps(writer):
    vals = _edges()
    body = bytes(writer.encode(vals.reshape(1, -1)))
    assert body == _dumps(vals.reshape(1, -1))
    text = body.decode()
    for word in ("[0.0, -0.0, Infinity, -Infinity, NaN, ", "1.0000000272564224e+16",
                 "1.401298464324817e-45", "0.00010000000474974513", "9.999999747378752e-05",
                 "9999999198822400.0", "123456792.0"):
        assert word in text, word
    for shape in ((0, 106), (3, 0)):
        rows = np.zeros(shape, F32)
        assert bytes(writer.encode(rows)) == _dumps(rows)


def test_value_bound_holds_at_its_worst_case(writer):
    """A float32 takes at most ``value_max`` (23) bytes: a sign, 17 digits, the
    point and e-XX, or a sign, "0.000" and 17 digits. Both worst cases exist,
    a body of them fits the bound, and one byte less than the body is refused
    without a write past it."""
    assert writer.value_max == 23
    rng = np.random.default_rng(11)
    expo = -(10 ** rng.uniform(-37, -5, 100_000)).astype(F32)
    fixed = -rng.uniform(1e-4, 1e-3, 100_000).astype(F32)
    worst = []
    for pool in (expo, fixed):
        lens = np.array([len(json.dumps(float(v))) for v in pool])
        assert lens.max() == writer.value_max
        worst.append(pool[lens == writer.value_max][:53])
    rows = np.concatenate(worst).reshape(2, -1)
    body = bytes(writer.encode(rows))
    assert body == _dumps(rows)
    assert len(body) <= writer.bound(*rows.shape)
    out = np.zeros(len(body) + 8, np.uint8)
    n = writer._write(rows.ctypes.data, 2, rows.shape[1], out.ctypes.data, len(body))
    assert n == len(body) and bytes(out[:n]) == body and not out[n:].any()
    out[:] = 0
    n = writer._write(rows.ctypes.data, 2, rows.shape[1], out.ctypes.data, len(body) - 1)
    assert n == -1 and not out[len(body) - 1:].any()


def test_writer_is_a_cdll_function_off_the_interpreter_lock(writer):
    fn = writer._write
    assert isinstance(fn, ctypes._CFuncPtr)
    assert not fn._flags_ & ctypes._FUNCFLAG_PYTHONAPI   # PyDLL would keep the lock
    assert fn.restype is ctypes.c_int64 and len(fn.argtypes) == 5


def test_other_dtypes_and_ranks_raise(writer):
    with pytest.raises(TypeError, match="float32"):
        writer.encode(np.zeros((2, 3), np.float64))
    with pytest.raises(TypeError, match="float32"):
        writer.encode(np.zeros(3, F32))
    rows = np.arange(12, dtype=F32).reshape(3, 4)
    assert bytes(writer.encode(rows[:, ::2])) == _dumps(rows[:, ::2])


def test_threads_write_at_once(writer):
    """Request threads write replies at once, each into its own buffer: every
    body equals json.dumps of its rows (the switch interval shortened so the
    threads interleave)."""
    rng = np.random.default_rng(5)
    arrays = [(rng.standard_normal((100, 106)) * 0.3).astype(F32) for _ in range(16)]
    want = [_dumps(a) for a in arrays]
    got, errors = [None] * len(arrays), []

    def write(i):
        try:
            for _ in range(5):
                got[i] = bytes(writer.encode(arrays[i]))
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=write, args=(i,)) for i in range(len(arrays))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads)
    assert got == want
