"""Ascending sort of int32 keys: a hand-written CUDA radix sort and its plain
version.

Counterpart of the Pallas bitonic sort in ``tools/exp_pallas_sort.py``
(``bitonic_sort`` / ``_bitonic_kernel``), which the JAX package wrote for the
payload-free instance-key sort of the splat prepass (``jax.lax.sort`` in
``artalk_tpu/ops/gsplat.py``); here that sort is ``ops/gsplat.py``'s
``_build_instances``. The keys are compared as signed int32.

``sort_keys`` sorts a contiguous 1-D int32 tensor of any length n: CUDA
tensors go through the kernel in ``csrc/sort.cu`` (an LSD radix sort of the
sign-flipped keys, 8 bits a pass, no padding; a pass whose digit is the same
for every key is skipped on the device), CPU tensors through
``sort_keys_plain``, any other device raises. A sort's output is a
permutation of its input in ascending order, so the two give the same keys
by different algorithms. ``sort_keys_plain`` is the TPU kernel's bitonic
network: it pads the keys to P = 2^ceil(log2 max(n, 2)) with INT32_MAX (which
sorts last), and for k = 2, 4, ..., P and j = k/2, ..., 1 exchanges the keys
at i and i ^ j so that the smaller comes first where bit k of i is 0 and last
where it is 1. It is independent of ``torch.sort``.

The kernel's shared library is built with nvcc at first use (``ops/_nvcc.py``).
Each call that launches the kernel counts one ``sort`` launch, and the CUDA
launches inside it (6 for n > 0: init, histogram, one per 8-bit digit, as the
entry point reports them) under ``sort/cuda``.
"""

from __future__ import annotations

import ctypes

import torch

from ._nvcc import CSRC, Library

INT32_MAX = 2 ** 31 - 1
MAX_KEYS = 2 ** 30 - 1   # the look-back status words keep 30 bits of count

LIB = Library(CSRC / "sort.cu", {
    "artalk_sort_keys": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                         + [ctypes.POINTER(ctypes.c_int)]),
    "artalk_sort_meta_words": (ctypes.c_longlong, [ctypes.c_int])}, kernel="sort", parts=("cuda",))


def padded_length(n: int) -> int:
    """P: the power of two the network sorts, at least 2."""
    return max(2, 1 << (n - 1).bit_length())


def _check(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int32 or keys.ndim != 1 or not keys.is_contiguous():
        raise ValueError(f"sort_keys: want a contiguous 1-D int32 tensor, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if keys.shape[0] > MAX_KEYS:
        raise ValueError(f"sort_keys: at most {MAX_KEYS} keys, got {keys.shape[0]}")


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """``keys`` (n,) int32 sorted ascending (signed), as a new tensor. A CUDA
    tensor goes through the kernel (on the current stream), a CPU tensor
    through ``sort_keys_plain``."""
    dev = keys.device
    if dev.type == "cpu":
        return sort_keys_plain(keys)
    if dev.type != "cuda":
        raise ValueError(f"sort_keys: unsupported device {dev}")
    _check(keys)
    n = keys.shape[0]
    if n == 0:
        return keys.clone()
    lib = LIB.get()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    # the ping-pong buffer and the histogram / look-back words, in one allocation
    work = torch.empty(n + lib.artalk_sort_meta_words(n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    err = lib.artalk_sort_keys(keys.data_ptr(), n, out.data_ptr(), work.data_ptr(),
                               work[n:].data_ptr(), stream, ctypes.byref(launched))
    if err != 0:
        raise RuntimeError(f"sort kernel launch failed: cudaError {err}")
    LIB.count()
    LIB.count("cuda", launched.value)
    return out


def sort_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of ``sort_keys``: the TPU kernel's padding and
    bitonic network, each substage a gather of the partner at ``i ^ j`` and a
    min/max by direction."""
    _check(keys)
    n = keys.shape[0]
    p = padded_length(n)
    x = torch.full((p,), INT32_MAX, dtype=torch.int32, device=keys.device)
    x[:n] = keys
    idx = torch.arange(p, device=keys.device)
    k = 2
    while k <= p:
        ascending = (idx & k) == 0
        j = k // 2
        while j >= 1:
            partner = x[idx ^ j]
            take_min = ((idx & j) == 0) == ascending
            x = torch.where(take_min, torch.minimum(x, partner), torch.maximum(x, partner))
            j //= 2
        k *= 2
    return x[:n]
