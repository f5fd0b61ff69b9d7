"""The AR block stack: one VAR scale level through all AdaLN blocks.

Counterpart of ``artalk_tpu/ops/ar_block_stack.py``. ``ar_block_stack`` runs
one level's new tokens through the whole block stack against the level's
KV-cache prefix, in one launch of the CUDA kernel in
``csrc/ar_block_stack.cu`` for CUDA tensors, and with
``ar_block_stack_plain`` for CPU tensors; for a CUDA tensor it launches the
kernel or raises.

Weights come packed by ``pack_block_weights`` as whole per-block matrices in
the ``(in, out)`` layout, in float32, bfloat16 or int8. The int8 pack
(``quantize_tiles``) is the JAX package's weight-only quantization, value for
value: symmetric, per output channel, with ``scale = max(absmax, 1e-12) / 127``
and round-half-to-even; for fc2 a scale covers one ``d``-row chunk of the
hidden contraction, as the JAX pack's transposed fc2 tiles have it. The JAX
pack's ``(d, TW)`` tile stream, its padding of the level to 16 rows and its
batch tiling served Mosaic's VMEM and are not carried over.

Numerics, as in the Pallas kernel: for bf16 and int8 packs both operands of
every product (the attention products included) are rounded to bfloat16 and
accumulated in float32; int8 scales multiply each scale chunk's float32
result. LayerNorm statistics, softmax and residuals are float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ..models import nn as tnn
from ..parallel.sharding import whole
from ._nvcc import CSRC, Library

PackDict = Dict[str, torch.Tensor]

# A planted fault for chip_smoke.py: the folded splits added last first.
FOLD_LAST_FIRST = False

# the headers of both block-stack kernels
HEADERS = (CSRC / "mma_stages.cuh", CSRC / "wgmma_gemm.cuh", CSRC / "block_stack_common.cuh",
           CSRC / "mma_ptx.cuh")

WEIGHT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PACK_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1}
NOT_CO_RESIDENT = -1
NO_TENSOR_MAP = -2


class _ArParams(ctypes.Structure):
    """Mirror of ``ArParams`` in csrc/ar_block_stack.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "ada", "wqkv", "wproj", "wfc1", "wfc2", "bqkv", "bproj", "bfc1", "bfc2",
        "qscale", "sqkv", "sproj", "sfc1", "sfc2", "kc", "vc", "feats", "k_new", "v_new",
        "xa", "qkv", "attn", "h", "partial", "prof")] + [(n, ctypes.c_int) for n in (
        "B", "pn", "d", "H", "hidden", "depth", "cache_len", "start", "wtype", "ctype", "bm",
        "ln_width", "sp_proj", "sp_fc2", "plan_qkv", "plan_proj", "plan_fc1", "plan_fc2")]


# ar_block_stack() counts each launch as "ar_block_stack", by its pack
# ("ar_block_stack/f32", "/bf16", "/int8") and its folded products
# ("ar_block_stack/folded")
LIB = Library(CSRC / "ar_block_stack.cu", {
    "artalk_ar_block_stack": (ctypes.c_int, [ctypes.POINTER(_ArParams), ctypes.c_void_p])},
    headers=HEADERS, kernel="ar_block_stack", parts=(*PACK_NAMES.values(), "folded"))


# ---------------------------------------------------------------------------
# Packs
# ---------------------------------------------------------------------------


def quantize_tiles(w: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``(..., K, N)`` weights per output column
    and per ``chunk`` rows of the contraction. Returns (int8 weights of the
    same shape, ``(..., K // chunk, N)`` float32 scales)."""
    *lead, k, n = w.shape
    wc = w.float().reshape(*lead, k // chunk, chunk, n)
    scales = torch.clamp(wc.abs().amax(dim=-2), min=1e-12) / 127.0
    q = torch.clamp(torch.round(wc / scales[..., None, :]), -127, 127).to(torch.int8)
    return q.reshape(w.shape), scales


def pack_weights(mats: Dict[str, torch.Tensor], dtype: torch.dtype, d: int) -> PackDict:
    """``{name: (depth, K, N) float32}`` -> the pack's weights: cast to
    ``dtype``, or for int8 quantized with ``s<name>`` scales (chunk ``d``)."""
    pack = {}
    for name, w in mats.items():
        if dtype == torch.int8:
            pack[name], pack["s" + name[1:]] = quantize_tiles(w, d)
        else:
            pack[name] = w.to(dtype).contiguous()
    return pack


def layer_mats(layers, proj: str) -> Dict[str, torch.Tensor]:
    """The stacked q/k/v, ``proj`` (the attention output), fc1 and fc2
    weights of a layer stack, and their biases as ``<name>_b``, as whole
    plain tensors: a tensor-parallel model's DTensors gathered
    (``parallel.sharding.whole``), so that a kernel never runs on one shard.
    Raises ValueError unless they share one width: q/k/v/``proj`` (depth, d,
    d), fc1 (depth, d, hidden), fc2 (depth, hidden, d), biases (depth, out),
    which a tensor-parallel shard is not."""
    w = {}
    for name in ("q", "k", "v", proj, "fc1", "fc2"):
        lin = getattr(layers, name)
        w[name] = whole(lin.w)
        if lin.b is not None:
            w[f"{name}_b"] = whole(lin.b)
    depth, d = w["q"].shape[:2]
    hidden = w["fc1"].shape[-1]
    want = {"q": (d, d), "k": (d, d), "v": (d, d), proj: (d, d), "fc1": (d, hidden),
            "fc2": (hidden, d)}
    for name, (n_in, n_out) in want.items():
        if tuple(w[name].shape) != (depth, n_in, n_out) or (
                f"{name}_b" in w and tuple(w[f"{name}_b"].shape) != (depth, n_out)):
            raise ValueError(f"{name} weights {tuple(w[name].shape)}: want ({depth}, {n_in}, "
                             f"{n_out}), one width with q's; a tensor-parallel shard is not a "
                             "whole weight")
    return w


@torch.no_grad()
def pack_block_weights(blocks, num_heads: int, dtype: torch.dtype = torch.float32) -> PackDict:
    """Pack the stacked AdaLN blocks (``BitwiseARModel.blocks``) for the kernel.

    Returns ``wqkv`` (depth, d, 3d), ``wproj`` (depth, d, d), ``wfc1`` (depth, d,
    hidden) and ``wfc2`` (depth, hidden, d) in ``dtype``; float32 biases
    ``bqkv`` (with the zero k bias), ``bproj``, ``bfc1``, ``bfc2``; ``qscale``
    (depth, H), the per-head ``exp(min(scale_mul, log 100))``; and for int8 the
    scales ``sqkv``, ``sproj``, ``sfc1`` (depth, 1, N) and ``sfc2`` (depth,
    hidden // d, d)."""
    if dtype not in WEIGHT_TYPES:
        raise ValueError(f"pack dtype {dtype} is not float32, bfloat16 or int8")
    w = layer_mats(blocks, "proj")
    depth, d = w["q"].shape[:2]
    pack = pack_weights({
        "wqkv": torch.cat([w["q"], w["k"], w["v"]], dim=-1),
        "wproj": w["proj"], "wfc1": w["fc1"], "wfc2": w["fc2"]}, dtype, d)
    pack["bqkv"] = torch.cat([w["q_b"], torch.zeros_like(w["q_b"]), w["v_b"]], dim=-1)
    pack["bproj"] = w["proj_b"].float().contiguous()
    pack["bfc1"] = w["fc1_b"].float().contiguous()
    pack["bfc2"] = w["fc2_b"].float().contiguous()
    pack["qscale"] = torch.exp(torch.clamp(whole(blocks.scale_mul), max=math.log(100.0))
                               ).reshape(depth, num_heads).contiguous()
    return pack


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def rounder(pack: PackDict):
    """The operand rounding of a pack's products: bf16 for bf16/int8 packs."""
    if pack_dtype(pack) == torch.float32:
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).float()


def pack_dtype(pack: PackDict) -> torch.dtype:
    return pack["wqkv"].dtype


def weight_matmul(a: torch.Tensor, w: torch.Tensor, scales: Optional[torch.Tensor],
                  rnd) -> torch.Tensor:
    """``rnd(a) @ w`` in float32; with int8 scales (K // chunk, N), each
    chunk's product is scaled and the chunks summed in order."""
    a = rnd(a)
    w = w.float()
    if scales is None:
        return torch.matmul(a, w)
    chunk = w.shape[0] // scales.shape[0]
    y = None
    for c in range(scales.shape[0]):
        part = torch.matmul(a[..., c * chunk:(c + 1) * chunk], w[c * chunk:(c + 1) * chunk])
        y = part * scales[c] if y is None else y + part * scales[c]
    return y


def softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rnd,
                   logit_scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q k^T [* scale]) v`` over (B, H, L, hd) heads, with the kernel's
    order: rounded operands, unrounded sum of the exponentials."""
    logits = torch.matmul(rnd(q), rnd(k).transpose(-1, -2))
    if logit_scale is not None:
        logits = logits * logit_scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return torch.matmul(rnd(p), rnd(v)) / p.sum(dim=-1, keepdim=True)


def ar_block_stack_plain(x: torch.Tensor, ada: torch.Tensor, pack: PackDict,
                         k_cache: torch.Tensor, v_cache: torch.Tensor, *, start: int,
                         num_heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch version of ``ar_block_stack`` (same arguments and results)."""
    rnd = rounder(pack)
    depth = pack["wqkv"].shape[0]
    x = x.float()
    ada = ada.float()
    k_out, v_out = [], []
    for i in range(depth):
        def sc(name):
            return pack[name][i] if name in pack else None

        g1, g2, s1, s2, sh1, sh2 = ada[i].chunk(6, dim=-1)
        xm = tnn.layer_norm(x, eps=1e-6) * (s1 + 1.0) + sh1
        qkv = weight_matmul(xm, pack["wqkv"][i], sc("sqkv"), rnd) + pack["bqkv"][i]
        q, k, v = (tnn.split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
        q = tnn.l2_normalize(q) * pack["qscale"][i][:, None, None]
        k = tnn.l2_normalize(k)
        keys = torch.cat([tnn.split_heads(k_cache[i, :, :start].float(), num_heads), k], dim=2)
        vals = torch.cat([tnn.split_heads(v_cache[i, :, :start].float(), num_heads), v], dim=2)
        attn = tnn.merge_heads(softmax_attend(q, keys, vals, rnd))
        x = x + (weight_matmul(attn, pack["wproj"][i], sc("sproj"), rnd) + pack["bproj"][i]) * g1
        xm = tnn.layer_norm(x, eps=1e-6) * (s2 + 1.0) + sh2
        h = tnn.gelu_tanh(weight_matmul(xm, pack["wfc1"][i], sc("sfc1"), rnd) + pack["bfc1"][i])
        x = x + (weight_matmul(h, pack["wfc2"][i], sc("sfc2"), rnd) + pack["bfc2"][i]) * g2
        k_out.append(tnn.merge_heads(k))
        v_out.append(tnn.merge_heads(v))
    return (x, torch.stack(k_out).to(k_cache.dtype), torch.stack(v_out).to(v_cache.dtype))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def check_shapes(d: int, hidden: int, num_heads: int) -> None:
    """What the kernels' tiling takes: widths in whole 64-column tiles, from
    128 (the LayerNorm sums of a row as float4 vectors, as torch reads them)
    to 1024 (four values a thread in the row passes), and head dims of 32 to
    128 in steps of 32."""
    hd = d // num_heads
    if (d % 64 or not 128 <= d <= 1024 or hidden % d or hd * num_heads != d or hd % 32
            or hd > 128):
        raise ValueError(f"block stack kernel: d={d}, hidden={hidden}, heads={num_heads} "
                         "need d % 64 == 0, 128 <= d <= 1024, hidden % d == 0 and a head dim "
                         "of 32, 64, 96 or 128")


def check_pack(pack: PackDict, device: torch.device) -> None:
    """Every pack tensor on ``device`` and contiguous; scales iff int8."""
    for name, t in pack.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"pack[{name!r}] must be contiguous on {device}")
    wtype = pack_dtype(pack)
    if wtype not in WEIGHT_TYPES:
        raise ValueError(f"pack weights of dtype {wtype}: want float32, bfloat16 or int8")
    has_scales = "sqkv" in pack
    if has_scales != (wtype == torch.int8):
        raise ValueError("int8 packs need their scales, and only they have them")


TILE_N, TILE_K = 64, 64   # the split rule's tile columns and contraction step
# profile slots of the kernel (csrc/ar_block_stack.cu, enum Stage), as CTA 0
# sees them: per stage its own ns from a barrier to the next, then per stage
# its ns waiting in that barrier, then the barriers passed
PROFILE_STAGES = ("row passes", "q/k/v", "attention", "projection", "fc1", "fc2")


def ln_width(d: int, rows: int) -> int:
    """The threads across a row that torch's CUDA reduction kernel takes for
    a mean over ``rows`` contiguous rows of ``d`` float32 values, read as
    float4 vectors (``set_block_dimension`` of ATen/native/cuda/Reduce.cuh,
    512 threads a block): the order of the plain version's LayerNorm sums on
    the card, which the kernel's row passes replay for ``rows`` = pn."""
    def last_pow2(n):
        return 1 << (n.bit_length() - 1)
    dim0 = min(last_pow2(d // 4), 512)
    dim1 = min(last_pow2(rows), 512)
    height = min(dim1, 512 // min(dim0, 32))
    return min(dim0, 512 // height)


def row_tile(pn: int) -> int:
    """The row tile the split rule assumes for a level of ``pn`` tokens: 32 up
    to 64 tokens, 128 above (the float32 packs' product tiles); from pn,
    never from the batch."""
    return 32 if pn <= 64 else 128


# The wgmma engine (bf16 and int8 packs, csrc/wgmma_gemm.cuh): a warpgroup's
# tile is 64 weight columns by WIDE_ROWS operand rows in a wide plan (a CTA
# item of 128 columns) or NARROW_ROWS in a narrow one; the plan's bits.
WIDE_ROWS, NARROW_ROWS = 128, 64
PLAN_WIDE, PLAN_FOLD, PLAN_FOLD_LAST_FIRST = 1, 2, 4


def gemm_plan(rows: int, n: int, k: int, splits: int, chunk: Optional[int], sms: int) -> int:
    """The wgmma engine's tile plan of one launch's (rows, n) x k product
    split ``splits`` ways (the split count comes from one batch row:
    contraction_splits, encoder_splits). Folded (PLAN_FOLD) when the wide
    tiles of 128 rows x 128 columns alone give every SM an item: a CTA then
    adds all splits of its tile in order, and one plane is written; an int8
    pack (``chunk``: its scale chunk) only where each split lies within one
    chunk. Wide (PLAN_WIDE: the CTA's two warpgroups share 128 x 128 items)
    when the items, split or folded, give every SM one; else narrow (each
    warpgroup takes 64 x 64 items of its own), so that a product of few rows
    spreads its weights over twice the lanes. From the launch's rows, which
    the batch sets; the arithmetic of a row is the same in every plan."""
    wide_tiles = -(-rows // WIDE_ROWS) * (n // 128) if n % 128 == 0 else 0
    fold = splits > 1 and wide_tiles >= sms and (chunk is None or k // splits <= chunk)
    wide = wide_tiles * (1 if fold else splits) >= sms
    return (PLAN_WIDE if wide else 0) | (PLAN_FOLD if fold else 0)


def contraction_splits(rows: int, products, d: int, sms: int) -> list:
    """How many ways each (N, K) product's contraction is split: the most that
    still give at most one work item per CTA of the grid (one per SM) when
    ``rows`` (the tokens of one batch row) fill few row tiles; each split a
    whole number of 64-deep steps, at most 16. The count depends on the
    product's shape, ``rows`` and the card, never on the batch, so a row's
    sums are the same at any batch size. A split lies within one ``d``-row
    int8 scale chunk or covers whole chunks."""
    splits = []
    for n, k in products:
        base = -(-rows // row_tile(rows)) * (n // TILE_N)
        valid = [s for s in range(1, 17) if k % (s * TILE_K) == 0
                 and (d % (k // s) == 0 or (k // s) % d == 0) and base * s <= sms]
        splits.append(valid[-1] if valid else 1)
    return splits


def split_products(rows: int, d: int, hidden: int, device: torch.device):
    """Contraction splits of the two products whose row passes add the
    partial sums (the projection, fc2), and the card's SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return contraction_splits(rows, ((d, d), (d, hidden)), d, sms), sms


def launch_plans(rows: int, products, pack: PackDict, d: int, sms: int) -> list:
    """``gemm_plan`` of each (n, k, splits) product of a launch of ``rows``
    rows (zeros for a float32 pack), with the planted fold-order fault when
    FOLD_LAST_FIRST is set."""
    if pack_dtype(pack) == torch.float32:
        return [0] * len(products)
    chunk = d if pack_dtype(pack) == torch.int8 else None
    plans = [gemm_plan(rows, n, k, s, chunk, sms) for n, k, s in products]
    fault = PLAN_FOLD_LAST_FIRST if FOLD_LAST_FIRST else 0
    return [p | fault if p & PLAN_FOLD else p for p in plans]


def count_launch(lib: Library, pack: PackDict, plans, depth: int) -> None:
    """Count one launch of ``lib``'s kernel, by pack, and the products it
    folded (``depth`` per folded plan)."""
    lib.count()
    lib.count(PACK_NAMES[pack_dtype(pack)])
    folded = depth * sum(1 for p in plans if p & PLAN_FOLD)
    if folded:
        lib.count("folded", folded)


def rows_alloc(m: int) -> int:
    """Rows of an operand scratch for the wgmma engine: at least one 64-row box."""
    return max(m, NARROW_ROWS)


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check_launch(name: str, err: int) -> None:
    """Raise for an entry point's nonzero return."""
    if err == NOT_CO_RESIDENT:
        raise RuntimeError(f"{name}: the cooperative grid cannot be co-resident on this card "
                           "(shared memory or registers too large)")
    if err == NO_TENSOR_MAP:
        raise RuntimeError(f"{name}: the CUDA driver could not make a tensor map of an operand")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def ar_block_stack(x: torch.Tensor, ada: torch.Tensor, pack: PackDict,
                   k_cache: torch.Tensor, v_cache: torch.Tensor, *, start: int,
                   num_heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one level's tokens through the whole block stack.

    x: (B, pn, d) level tokens; ada: (depth, B, pn, 6d) AdaLN parameters at
    these positions (both float32 or bfloat16); pack: ``pack_block_weights``;
    k_cache/v_cache: (depth, B, cache_len, d) merged-head caches (float32 or
    bfloat16) whose rows [0, start) hold the prefix (keys L2-normalised).
    Returns (feats (B, pn, d) float32, k_new and v_new (depth, B, pn, d) in the
    cache dtype, k_new L2-normalised); the caller writes them at ``start``.
    A CPU tensor goes through ``ar_block_stack_plain``. A DTensor argument
    (a tensor-parallel model's activations) goes in whole (``whole``)."""
    x, ada, k_cache, v_cache = (whole(t) for t in (x, ada, k_cache, v_cache))
    if x.device.type == "cpu":
        return ar_block_stack_plain(x, ada, pack, k_cache, v_cache, start=start,
                                    num_heads=num_heads)
    _check_inputs(x, ada, pack, k_cache, v_cache, start, num_heads)
    return _launch(x, ada, pack, k_cache, v_cache, start, num_heads)


def _check_inputs(x, ada, pack, k_cache, v_cache, start: int, num_heads: int) -> None:
    """What the kernel takes; raises ValueError otherwise."""
    if x.device.type != "cuda":
        raise ValueError(f"ar_block_stack: unsupported device {x.device}")
    b, pn, d = x.shape
    depth, hidden = pack["wfc1"].shape[0], pack["wfc1"].shape[2]
    cache_len = k_cache.shape[2]
    check_shapes(d, hidden, num_heads)
    if ada.shape != (depth, b, pn, 6 * d):
        raise ValueError(f"ada {tuple(ada.shape)}: want {(depth, b, pn, 6 * d)}")
    if (k_cache.shape != (depth, b, cache_len, d) or v_cache.shape != k_cache.shape
            or k_cache.dtype != v_cache.dtype or k_cache.dtype not in CACHE_TYPES):
        raise ValueError(f"caches {tuple(k_cache.shape)} {k_cache.dtype} / "
                         f"{tuple(v_cache.shape)} {v_cache.dtype}: want two float32 or "
                         f"bfloat16 ({depth}, {b}, cache_len, {d})")
    if not 0 <= start <= cache_len - pn:
        raise ValueError(f"start {start} + {pn} tokens exceed the cache of {cache_len}")
    if ada.device != x.device:
        raise ValueError("ar_block_stack: ada must be on the tokens' device")
    for t in (k_cache, v_cache):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("ar_block_stack: caches must be contiguous on the tokens' device")
    check_pack(pack, x.device)


def _launch(x, ada, pack, k_cache, v_cache, start: int, num_heads: int,
            prof: Optional[torch.Tensor] = None):
    """One launch of the kernel on checked inputs; ``prof`` (int64, the
    kernel's profile slots) is added to when given."""
    lib = LIB.get()
    x = x.float().contiguous()
    ada = ada.float().contiguous()
    b, pn, d = x.shape
    depth, hidden = pack["wfc1"].shape[0], pack["wfc1"].shape[2]
    m = b * pn
    dev = x.device
    # the products' operands: bf16 (the reference's rounding) unless the pack is float32
    op = torch.float32 if pack_dtype(pack) == torch.float32 else torch.bfloat16
    feats = torch.empty((b, pn, d), dtype=torch.float32, device=dev)
    k_new = torch.empty((depth, b, pn, d), dtype=k_cache.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    xa = torch.empty((rows_alloc(m), d), dtype=op, device=dev)
    qkv = torch.empty((m, 3 * d), dtype=torch.float32, device=dev)
    attn = torch.empty((rows_alloc(m), d), dtype=op, device=dev)
    h = torch.empty((rows_alloc(m), hidden), dtype=op, device=dev)
    (sp_proj, sp_fc2), sms = split_products(pn, d, hidden, dev)
    plans = launch_plans(m, ((3 * d, d, 1), (d, d, sp_proj), (hidden, d, 1),
                             (d, hidden, sp_fc2)), pack, d, sms)
    planes = max(1 if p & PLAN_FOLD else s for p, s in ((plans[1], sp_proj), (plans[3], sp_fc2)))
    partial = torch.empty(planes * m * d, dtype=torch.float32, device=dev)
    params = _ArParams(
        x=ptr(x), ada=ptr(ada), wqkv=ptr(pack["wqkv"]), wproj=ptr(pack["wproj"]),
        wfc1=ptr(pack["wfc1"]), wfc2=ptr(pack["wfc2"]), bqkv=ptr(pack["bqkv"]),
        bproj=ptr(pack["bproj"]), bfc1=ptr(pack["bfc1"]), bfc2=ptr(pack["bfc2"]),
        qscale=ptr(pack["qscale"]), sqkv=ptr(pack.get("sqkv")), sproj=ptr(pack.get("sproj")),
        sfc1=ptr(pack.get("sfc1")), sfc2=ptr(pack.get("sfc2")), kc=ptr(k_cache),
        vc=ptr(v_cache), feats=ptr(feats), k_new=ptr(k_new), v_new=ptr(v_new), xa=ptr(xa),
        qkv=ptr(qkv), attn=ptr(attn), h=ptr(h), partial=ptr(partial), prof=ptr(prof), B=b,
        pn=pn, d=d, H=num_heads, hidden=hidden, depth=depth, cache_len=k_cache.shape[2],
        start=start, wtype=WEIGHT_TYPES[pack_dtype(pack)], ctype=CACHE_TYPES[k_cache.dtype],
        bm=row_tile(pn), ln_width=ln_width(d, pn), sp_proj=sp_proj, sp_fc2=sp_fc2,
        plan_qkv=plans[0], plan_proj=plans[1], plan_fc1=plans[2], plan_fc2=plans[3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    check_launch("ar_block_stack", lib.artalk_ar_block_stack(ctypes.byref(params), stream))
    count_launch(LIB, pack, plans, depth)
    return feats, k_new, v_new


def stage_times(x, ada, pack, k_cache, v_cache, *, start: int, num_heads: int,
                reps: int = 1) -> Tuple[Dict[str, Tuple[float, float]], float]:
    """``reps`` launches of the kernel on CUDA tensors, as ``ar_block_stack``
    runs them, with the kernel's profile on. Returns, per stage, the ms per
    launch that CTA 0 spends on its own work in it and waiting in the grid
    barrier after it (the last row pass has no barrier), and the grid
    barriers per launch."""
    _check_inputs(x, ada, pack, k_cache, v_cache, start, num_heads)
    n = len(PROFILE_STAGES)
    prof = torch.zeros(2 * n + 1, dtype=torch.int64, device=x.device)
    for _ in range(reps):
        _launch(x, ada, pack, k_cache, v_cache, start, num_heads, prof)
    ns = prof.cpu().tolist()
    return ({name: (ns[i] / reps / 1e6, ns[n + i] / reps / 1e6)
             for i, name in enumerate(PROFILE_STAGES)}, ns[-1] / reps)
