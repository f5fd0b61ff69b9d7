"""Flash attention with an additive bias: a hand-written CUDA kernel and its
plain version.

Counterpart of ``artalk_tpu/ops/attention.py``. ``flash_attention`` computes
the JAX function: logits ``(q * scale) . k^T + bias`` in float32, an online
softmax whose running max starts at ``NEG_INF`` (-1e30, so a row whose every
key is masked returns 0 where a plain softmax gives NaN), ``P . V`` with p and
v in float32, and ``acc / max(l, 1e-30)`` in q's dtype. A CUDA tensor goes
through the kernel in ``csrc/flash_attention.cu`` (tensor-core products at
float32 accuracy: split bf16 / TF32 operands), a CPU tensor through
``flash_attention_plain``; for a CUDA tensor it launches the kernel or
raises. When no input needs a gradient the kernel is launched directly,
else through an ``autograd.Function``. The caller's bias is read through its
strides, never broadcast into a (B, H, Lq, Lk) tensor.

The gradient, as the JAX custom VJP's, recomputes the float32 attention in
plain torch (the TPU kernel has no backward kernel, so neither does this one):
autograd through ``flash_attention_plain``. The bias gradient keeps the
bias's broadcast shape. (JAX's recompute is a plain softmax, whose gradient
is NaN on a wholly masked row; here it is 0 there.)

The kernel's shared library is built with nvcc at first use
(``ops/_nvcc.py``); each launch counts one ``flash_attention`` launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._nvcc import CSRC, Library

NEG_INF = -1e30   # the running max's start, as in the JAX kernel
MAX_HEAD_DIM = 128

LIB = Library(CSRC / "flash_attention.cu", {
    "artalk_flash_attention": (ctypes.c_int, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                               + [ctypes.c_float] + [ctypes.c_longlong] * 4
                               + [ctypes.c_int, ctypes.c_void_p])},
    headers=(CSRC / "mma_ptx.cuh",), kernel="flash_attention")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          scale: float = 1.0) -> torch.Tensor:
    """Plain-torch version of ``flash_attention``: the same function with the
    whole row at once (its final running max, clamped below at NEG_INF)."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF))
    out = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors, after checking them."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: want q (B, H, Lq, hd), k and v (B, H, Lk, hd)")
    b, h, lq, hd = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: want float32 or bfloat16 q, k, v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM or lq < 1 or lk < 1 or not 1 <= b * h <= 65535:
        raise ValueError(f"flash_attention: head dim {hd} (at most {MAX_HEAD_DIM}), "
                         f"lengths {lq}, {lk} and B*H {b * h} out of range")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    strides = (0, 0, 0, 0)
    if bias is not None:
        if bias.device != q.device:
            raise ValueError("flash_attention: bias must be on q's device")
        # a view, strides 0 where broadcast (.float() copies only another dtype)
        bias = torch.broadcast_to(bias.float(), (b, h, lq, lk))
        strides = bias.stride()
    fn = LIB.get().artalk_flash_attention
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    # the current stream's handle as an int, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
             out.data_ptr(), b * h, h, lq, lk, hd, scale, *strides, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: cudaError {err}")
    LIB.count()
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel; backward: autograd through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _launch(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) if t is not None else None
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = flash_attention_plain(*leaves, scale=ctx.scale)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, needs) if n], grad))
        return (*(next(grads) if n else None for n in needs), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    scale: float = 1.0) -> torch.Tensor:
    """Attention over (B, H, Lq, hd) x (B, H, Lk, hd) with an optional
    additive float32 bias broadcastable to (B, H, Lq, Lk); returns (B, H, Lq,
    hd) in q's dtype (float32 or bfloat16). Differentiable. A CPU tensor
    goes through ``flash_attention_plain``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FlashAttention.apply(q, k, v, bias, float(scale))
    return _launch(q, k, v, bias, float(scale))
