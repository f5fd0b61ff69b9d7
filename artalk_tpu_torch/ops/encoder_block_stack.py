"""The wav2vec2 encoder stack: all pre-LN layers of a window in one call.

Counterpart of ``artalk_tpu/ops/encoder_block_stack.py``.
``encoder_block_stack`` runs the post-(projection + positional conv) hidden
state through every stable-layer-norm encoder layer (pre-LN bidirectional
attention, pre-LN erf-GELU FFN, residuals) in one launch of the CUDA kernel
in ``csrc/encoder_block_stack.cu`` for CUDA tensors, and with
``encoder_block_stack_plain`` for CPU tensors; for a CUDA tensor it launches
the kernel or raises. The final LayerNorm stays with the caller.

Packs and numerics are those of ``ops/ar_block_stack.py``: whole matrices in
float32, bfloat16 or int8 (the JAX package's quantization, value for value),
bf16-rounded operands for bf16/int8 packs, float32 accumulation. Several
windows may go through one call: each window's result equals its own
single-window result bit for bit, in the kernel and in the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import nn as tnn
from ..parallel.sharding import whole
from ._nvcc import CSRC, build_library, library_lock
from .ar_block_stack import (PLAN_FOLD, WEIGHT_TYPES, PackDict, check_launch, check_pack,
                             check_shapes, count_launch, launch_plans, layer_mats, pack_dtype,
                             pack_weights, ptr, rounder, rows_alloc, softmax_attend,
                             weight_matmul)

# Launches of the CUDA kernel in this process; encoder_block_stack() adds one per launch.
LAUNCHES = 0
# The same launches by the pack's weight type ("f32", "bf16", "int8").
LAUNCHES_BY_PACK: dict = {}
# The same launches by the products' engine: "wgmma" (bf16 and int8 packs) or
# "mma_f32" (float32 packs).
LAUNCHES_BY_ENGINE: dict = {}
# Products whose contraction splits a CTA added itself (one plane written).
FOLDED = 0

SOURCE = CSRC / "encoder_block_stack.cu"
HEADERS = (CSRC / "mma_stages.cuh", CSRC / "wgmma_gemm.cuh", CSRC / "block_stack_common.cuh",
           CSRC / "mma_ptx.cuh")
BUILD_REPORT = ""   # nvcc's register and shared-memory report of the last fresh build
_LIB = None


class _EncParams(ctypes.Structure):
    """Mirror of ``EncParams`` in csrc/encoder_block_stack.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "wqkv", "wout", "wfc1", "wfc2", "bqkv", "bout", "bfc1", "bfc2", "ln1s",
        "ln1b", "ln2s", "ln2b", "sqkv", "sout", "sfc1", "sfc2", "y", "xa", "qkv", "attn",
        "h", "partial")] + [(n, ctypes.c_int) for n in ("B", "T", "d", "H", "hidden", "depth")
                            ] + [("eps", ctypes.c_float)] + [(n, ctypes.c_int) for n in (
                                "wtype", "sp_out", "sp_fc2", "plan_qkv", "plan_out", "plan_fc1",
                                "plan_fc2")]


HEAD_DIM = 64        # the kernel's head dim (wav2vec2: 1024 / 16)
TILE_M, TILE_N, TILE_K = 128, 128, 64   # the split rule's tile (the float32 packs' split tiles)


def encoder_splits(rows: int, d: int, hidden: int, sms: int) -> tuple:
    """Contraction splits of the output projection (d x d) and fc2 (hidden x
    d), whose row passes add the partial sums: the most that still give at
    most one item per SM (the kernel's grid) for ``rows`` (one window's
    frames), each split a whole number of 64-deep steps; fc2 splits at least
    at every ``d``-row int8 scale chunk, so that a split's sum is scaled
    once. They depend on the window, the widths and the card, never on the
    batch, so a row's sums are the same at any batch size."""
    base = -(-rows // TILE_M) * (d // TILE_N)
    splits = []
    for k in (d, hidden):
        valid = [s for s in range(1, 17) if k % (s * TILE_K) == 0 and d % (k // s) == 0]
        fit = [s for s in valid if base * s <= sms]
        splits.append(fit[-1] if fit else valid[0])
    return tuple(splits)


@torch.no_grad()
def pack_encoder_weights(layers, dtype: torch.dtype = torch.float32) -> PackDict:
    """Pack the stacked encoder layers (``Wav2VecEncoder.encoder.layers``).

    Returns ``wqkv`` (depth, d, 3d), ``wout`` (depth, d, d), ``wfc1`` (depth, d,
    hidden), ``wfc2`` (depth, hidden, d) in ``dtype``; float32 biases ``bqkv``,
    ``bout``, ``bfc1``, ``bfc2`` and LayerNorm rows ``ln1s``, ``ln1b``, ``ln2s``,
    ``ln2b``; for int8 the scales ``sqkv``, ``sout``, ``sfc1`` and ``sfc2``."""
    if dtype not in WEIGHT_TYPES:
        raise ValueError(f"pack dtype {dtype} is not float32, bfloat16 or int8")
    w = layer_mats(layers, "out")
    d = w["q"].shape[1]
    pack = pack_weights({
        "wqkv": torch.cat([w["q"], w["k"], w["v"]], dim=-1),
        "wout": w["out"], "wfc1": w["fc1"], "wfc2": w["fc2"]}, dtype, d)
    pack["bqkv"] = torch.cat([w["q_b"], w["k_b"], w["v_b"]], dim=-1).float()
    for name, t in (("bout", w["out_b"]), ("bfc1", w["fc1_b"]), ("bfc2", w["fc2_b"]),
                    ("ln1s", whole(layers.norm1.scale)), ("ln1b", whole(layers.norm1.bias)),
                    ("ln2s", whole(layers.norm2.scale)), ("ln2b", whole(layers.norm2.bias))):
        pack[name] = t.float().contiguous()
    return pack


def pack_batched_ok(pack: PackDict) -> bool:
    """May this pack run at batch > 1 (several windows)? The JAX package keeps
    float32 packs on the layer-by-layer path there (its half-width float32
    tiles are a parity mode, not a speed path), and the port routes alike."""
    return pack_dtype(pack) != torch.float32


def encoder_block_stack_plain(x: torch.Tensor, pack: PackDict, *, num_heads: int,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain-torch version of ``encoder_block_stack``, window by window."""
    if x.shape[0] != 1:
        return torch.cat([encoder_block_stack_plain(x[i:i + 1], pack, num_heads=num_heads,
                                                    eps=eps) for i in range(x.shape[0])])
    rnd = rounder(pack)
    x = x.float()
    hd = x.shape[-1] // num_heads
    for i in range(pack["wqkv"].shape[0]):
        def sc(name):
            return pack[name][i] if name in pack else None

        y = tnn.layer_norm(x, eps, pack["ln1s"][i], pack["ln1b"][i])
        qkv = weight_matmul(y, pack["wqkv"][i], sc("sqkv"), rnd) + pack["bqkv"][i]
        q, k, v = (tnn.split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
        attn = tnn.merge_heads(softmax_attend(q, k, v, rnd, logit_scale=hd ** -0.5))
        x = x + (weight_matmul(attn, pack["wout"][i], sc("sout"), rnd) + pack["bout"][i])
        y = tnn.layer_norm(x, eps, pack["ln2s"][i], pack["ln2b"][i])
        h = tnn.gelu_erf(weight_matmul(y, pack["wfc1"][i], sc("sfc1"), rnd) + pack["bfc1"][i])
        x = x + (weight_matmul(h, pack["wfc2"][i], sc("sfc2"), rnd) + pack["bfc2"][i])
    return x


def build() -> float:
    """Build (or reuse) and load the kernel's shared library. Returns the
    seconds spent, 0.0 when it was already loaded."""
    global _LIB, BUILD_REPORT
    with library_lock(SOURCE):
        if _LIB is not None:
            return 0.0
        lib, seconds, BUILD_REPORT = build_library(SOURCE, HEADERS)
        lib.artalk_encoder_block_stack.argtypes = [ctypes.POINTER(_EncParams), ctypes.c_void_p]
        lib.artalk_encoder_block_stack.restype = ctypes.c_int
        _LIB = lib
        return seconds


def encoder_block_stack(x: torch.Tensor, pack: PackDict, *, num_heads: int,
                        eps: float = 1e-5) -> torch.Tensor:
    """Run (B, T, d) tokens (B windows) through the whole pre-LN encoder stack;
    returns (B, T, d) float32. A CPU tensor goes through
    ``encoder_block_stack_plain``. A DTensor (a tensor-parallel model's
    activations) goes in whole (``parallel.sharding.whole``)."""
    global LAUNCHES, FOLDED
    x = whole(x)
    if x.device.type == "cpu":
        return encoder_block_stack_plain(x, pack, num_heads=num_heads, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"encoder_block_stack: unsupported device {x.device}")
    if x.ndim != 3:
        raise ValueError(f"encoder_block_stack: want (B, T, d) tokens, got {tuple(x.shape)}")
    b, t, d = x.shape
    depth, hidden = pack["wfc1"].shape[0], pack["wfc1"].shape[2]
    check_shapes(d, hidden, num_heads)
    if d // num_heads != HEAD_DIM:
        raise ValueError(f"encoder_block_stack: the kernel takes a head dim of {HEAD_DIM}, "
                         f"got d={d} with {num_heads} heads")
    if pack["wqkv"].shape != (depth, d, 3 * d):
        raise ValueError(f"pack wqkv {tuple(pack['wqkv'].shape)} does not fit d={d}")
    check_pack(pack, x.device)
    build()
    x = x.float().contiguous()
    m = b * t
    dev = x.device
    y = torch.empty((b, t, d), dtype=torch.float32, device=dev)
    # the products' operands: bf16 (the reference's rounding) unless the pack is float32
    op = torch.float32 if pack_dtype(pack) == torch.float32 else torch.bfloat16
    xa = torch.empty((rows_alloc(m), d), dtype=op, device=dev)
    qkv = torch.empty((m, 3 * d), dtype=op, device=dev)
    attn = torch.empty((rows_alloc(m), d), dtype=op, device=dev)
    h = torch.empty((rows_alloc(m), hidden), dtype=op, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sp_out, sp_fc2 = encoder_splits(t, d, hidden, sms)
    plans = launch_plans(m, ((3 * d, d, 1), (d, d, sp_out), (hidden, d, 1), (d, hidden, sp_fc2)),
                         pack, d, sms)
    planes = max(1 if p & PLAN_FOLD else s for p, s in ((plans[1], sp_out), (plans[3], sp_fc2)))
    partial = torch.empty(planes * m * d, dtype=torch.float32, device=dev)
    params = _EncParams(
        x=ptr(x), wqkv=ptr(pack["wqkv"]), wout=ptr(pack["wout"]), wfc1=ptr(pack["wfc1"]),
        wfc2=ptr(pack["wfc2"]), bqkv=ptr(pack["bqkv"]), bout=ptr(pack["bout"]),
        bfc1=ptr(pack["bfc1"]), bfc2=ptr(pack["bfc2"]), ln1s=ptr(pack["ln1s"]),
        ln1b=ptr(pack["ln1b"]), ln2s=ptr(pack["ln2s"]), ln2b=ptr(pack["ln2b"]),
        sqkv=ptr(pack.get("sqkv")), sout=ptr(pack.get("sout")), sfc1=ptr(pack.get("sfc1")),
        sfc2=ptr(pack.get("sfc2")), y=ptr(y), xa=ptr(xa), qkv=ptr(qkv), attn=ptr(attn),
        h=ptr(h), partial=ptr(partial), B=b, T=t, d=d, H=num_heads, hidden=hidden,
        depth=depth, eps=eps, wtype=WEIGHT_TYPES[pack_dtype(pack)], sp_out=sp_out,
        sp_fc2=sp_fc2, plan_qkv=plans[0], plan_out=plans[1], plan_fc1=plans[2],
        plan_fc2=plans[3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    check_launch("encoder_block_stack",
                 _LIB.artalk_encoder_block_stack(ctypes.byref(params), stream))
    LAUNCHES += 1
    FOLDED += count_launch(LAUNCHES_BY_PACK, LAUNCHES_BY_ENGINE, pack, plans, depth, "encoder")
    return y
