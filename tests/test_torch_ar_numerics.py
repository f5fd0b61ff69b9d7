"""A CPU rehearsal of the AR block-stack kernel's arithmetic
(csrc/ar_block_stack.cu with the stages of csrc/mma_stages.cuh) against
ar_block_stack_plain.

The kernel computes each product on the tensor cores:

- float32 packs as 3xTF32 (tests/test_torch_encoder_numerics.py's tf32
  split, the cross terms summed apart);
- bf16 and int8 packs with bf16 operands, each 64-deep step's sum from zero
  and added to the running sum in float32; an int8 pack's running sum scaled
  at the end of each d-deep scale chunk; the projection's and fc2's
  contraction split as contraction_splits splits it at 132 SMs, the splits'
  sums added in order by the row pass, then the bias and the gated residual.

Each modulated LayerNorm is the plain version's float32 formula with its
sums in the order torch's CUDA reduction takes for pn rows (ln_width), then
LN * (1 + scale) + shift in float32; the q/k/v output stays float32
for the L2 normalisation, and the attention rounds q, k, p and v as the plain
version does. The emulation replays that order with CPU matmuls for each
64-deep step (inside a step the CPU sums in another order than the tensor
cores: rounding noise of the size of the plain version's own). It must meet
chip_smoke.py's phase 6 limits against the plain version: float32 features
within 1e-4 and k/v within 1e-5; bf16 / int8 features within 3e-3 and k/v
within 2 bf16 ulps of their largest value; and the first block alone within
ONE_BLOCK (rms error 6e-4 of the block's contribution, at most 1 % of the k/v
values changed). Through 12 narrow blocks at three levels, and through one
block at the production width (d 768, hidden 3072, 12 heads, pn 100 at its
real cache offset).
"""

import math

import numpy as np
import pytest
import torch

from artalk_tpu_torch.models import nn as tnn
from artalk_tpu_torch.models.ar_model import _Blocks
from artalk_tpu_torch.ops import ar_block_stack as tab

from test_torch_encoder_numerics import mm_3xtf32
from test_torch_params import torch_threads  # noqa: F401 (autouse)

PACK_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
AR_FEATS_TOL = 3e-3
ONE_BLOCK = {"rms": 6e-4, "changed": 0.01}
SMS = 132   # H100 SXM
PATCH_NUMS = (1, 5, 25, 50, 100)   # the production VAE's levels
PREV_LEN = sum(PATCH_NUMS)         # prev_ratio 1
CACHE_LEN = 2 * PREV_LEN
STEP = 64                          # depth of a bf16 step of the kernel


def mm_kernel(a: torch.Tensor, w: torch.Tensor, scales, splits: int, f32: bool):
    """A product as the kernel computes it, its splits' sums added in order."""
    if f32:
        return mm_3xtf32(a.float(), w.float())
    a = a.to(torch.bfloat16).float()
    w = w.float()
    k = w.shape[0]
    chunk = k if scales is None else k // scales.shape[0]
    y = None
    for s0 in range(0, k, k // splits):
        acc, tot = None, None
        for c in range(s0, s0 + k // splits, STEP):       # a fresh sum per step
            part = torch.matmul(a[..., c:c + STEP], w[c:c + STEP])
            acc = part if acc is None else acc + part
            end = c + STEP
            if scales is not None and (end % chunk == 0 or end == s0 + k // splits):
                scaled = acc * scales[(end - 1) // chunk]
                tot = scaled if tot is None else tot + scaled
                acc = None
        part = acc if scales is None else tot
        y = part if y is None else y + part
    return y


def torch_order_sum(v: torch.Tensor, width: int) -> torch.Tensor:
    """The sums over the last axis in the order of torch's CUDA reduction
    with ``width`` threads across a row (csrc/mma_stages.cuh,
    torch_row_sum): thread x adds float4 vectors x, x + width, ... into four
    sums, combined in order, then a halving tree."""
    vec = v.reshape(*v.shape[:-1], v.shape[-1] // 4, 4)
    acc = torch.zeros(*v.shape[:-1], width, 4)
    for i0 in range(0, vec.shape[-2], width):
        n = min(width, vec.shape[-2] - i0)
        acc[..., :n, :] = acc[..., :n, :] + vec[..., i0:i0 + n, :]
    t = ((acc[..., 0] + acc[..., 1]) + acc[..., 2]) + acc[..., 3]
    off = width // 2
    while off >= 1:
        t = torch.cat([t[..., :off] + t[..., off:2 * off], t[..., off:]], dim=-1)
        off //= 2
    return t[..., :1]


def modulated_ln(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The kernel's LN(x) * (1 + scale) + shift: the plain version's float32
    formula with its sums in the order torch's CUDA reduction takes for pn
    rows (ln_width); rsqrt is the CPU's, not the card's rsqrtf."""
    width = tab.ln_width(x.shape[-1], x.shape[-2])
    inv = torch.tensor(1.0 / x.shape[-1], dtype=torch.float32)
    mean = torch_order_sum(x, width) * inv
    dx = x - mean
    ln = dx * torch.rsqrt(torch_order_sum(dx * dx, width) * inv + 1e-6)
    return ln * (scale + 1.0) + shift


def emulated_stack(x, ada, pack, k_cache, v_cache, *, start: int, num_heads: int):
    """ar_block_stack as the kernel computes it (same arguments and results)."""
    f32 = tab.pack_dtype(pack) == torch.float32
    rnd = tab.rounder(pack)
    d = x.shape[-1]
    hidden = pack["wfc1"].shape[-1]
    sp_proj, sp_fc2 = tab.contraction_splits(x.shape[1], ((d, d), (d, hidden)), d, SMS)
    x = x.float()
    k_out, v_out = [], []
    for i in range(pack["wqkv"].shape[0]):
        def sc(name):
            return pack[name][i] if name in pack else None

        g1, g2, s1, s2, sh1, sh2 = ada[i].float().chunk(6, dim=-1)
        qkv = mm_kernel(modulated_ln(x, s1, sh1), pack["wqkv"][i], sc("sqkv"), 1, f32) \
            + pack["bqkv"][i]
        q, k, v = (tnn.split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
        q = tnn.l2_normalize(q) * pack["qscale"][i][:, None, None]
        k = tnn.l2_normalize(k)
        keys = torch.cat([tnn.split_heads(k_cache[i, :, :start].float(), num_heads), k], dim=2)
        vals = torch.cat([tnn.split_heads(v_cache[i, :, :start].float(), num_heads), v], dim=2)
        attn = tnn.merge_heads(tab.softmax_attend(q, keys, vals, rnd))
        x = x + (mm_kernel(attn, pack["wproj"][i], sc("sproj"), sp_proj, f32)
                 + pack["bproj"][i]) * g1
        h = tnn.gelu_tanh(mm_kernel(modulated_ln(x, s2, sh2), pack["wfc1"][i], sc("sfc1"), 1,
                                    f32) + pack["bfc1"][i])
        x = x + (mm_kernel(h, pack["wfc2"][i], sc("sfc2"), sp_fc2, f32) + pack["bfc2"][i]) * g2
        k_out.append(tnn.merge_heads(k))
        v_out.append(tnn.merge_heads(v))
    return (x, torch.stack(k_out).to(k_cache.dtype), torch.stack(v_out).to(v_cache.dtype))


def _pack(d: int, hidden: int, heads: int, depth: int, mode: str, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    blocks = _Blocks(depth, d, 32, hidden, heads).requires_grad_(False)
    for lin in (blocks.ada_lin, blocks.q, blocks.k, blocks.v, blocks.proj, blocks.fc1,
                blocks.fc2):
        tnn.linear_init(lin, gen)
    blocks.scale_mul.copy_(math.log(4.0) + torch.rand(blocks.scale_mul.shape, generator=gen))
    return tab.pack_block_weights(blocks, heads, dtype=PACK_DTYPES[mode])


def _inputs(depth: int, d: int, heads: int, level: int, cache_dtype, seed: int):
    """chip_smoke.py's ar_inputs at B = 1, from a numpy seed."""
    rng = np.random.default_rng(seed)
    pn = PATCH_NUMS[level]
    x = rng.standard_normal((1, pn, d)) * 0.3
    ada = rng.standard_normal((depth, 1, pn, 6 * d)) * 0.1
    keys = rng.standard_normal((depth, 1, CACHE_LEN, heads, d // heads))
    kc = (keys / np.linalg.norm(keys, axis=-1, keepdims=True)).reshape(depth, 1, CACHE_LEN, d)
    vc = rng.standard_normal((depth, 1, CACHE_LEN, d)) * 0.5
    f = lambda a, dt=torch.float32: torch.from_numpy(a.astype(np.float32)).to(dt)  # noqa: E731
    return (f(x), f(ada), f(kc, cache_dtype), f(vc, cache_dtype),
            PREV_LEN + sum(PATCH_NUMS[:level]))


def bf16_ulps_of_max(got: torch.Tensor, want: torch.Tensor) -> float:
    top = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / 2.0 ** (math.floor(math.log2(top)) - 7)


def check_phase6(mode: str, got, want) -> None:
    feats_err = (got[0] - want[0]).abs().max().item()
    if mode == "f32":
        assert feats_err <= 1e-4
        assert max((g - w).abs().max().item() for g, w in zip(got[1:], want[1:])) <= 1e-5
    else:
        assert feats_err <= AR_FEATS_TOL
        assert max(bf16_ulps_of_max(g, w) for g, w in zip(got[1:], want[1:])) <= 2


@pytest.mark.parametrize("mode", list(PACK_DTYPES))
@pytest.mark.parametrize("d,hidden,heads,depth,levels",
                         [(256, 1024, 4, 12, (0, 2, 4)), (768, 3072, 12, 1, (4,))],
                         ids=["narrow-12", "production-1"])
def test_kernel_arithmetic_within_phase6_limits(mode, d, hidden, heads, depth, levels):
    pack = _pack(d, hidden, heads, depth, mode, seed=d + depth)
    cache_dtype = torch.float32 if mode == "f32" else torch.bfloat16
    for level in levels:
        x, ada, kc, vc, start = _inputs(depth, d, heads, level, cache_dtype, seed=100 + level)
        args = dict(start=start, num_heads=heads)
        want = tab.ar_block_stack_plain(x, ada, pack, kc, vc, **args)
        got = emulated_stack(x, ada, pack, kc, vc, **args)
        assert all(torch.isfinite(t.float()).all() for t in got)
        check_phase6(mode, got, want)
        if mode == "f32":
            continue
        # the first block alone, where rounding noise is not yet amplified
        one = {k: v[:1].contiguous() for k, v in pack.items()}
        w1 = tab.ar_block_stack_plain(x, ada[:1], one, kc[:1], vc[:1], **args)
        g1 = emulated_stack(x, ada[:1], one, kc[:1], vc[:1], **args)
        rms = ((g1[0] - w1[0]).pow(2).mean().sqrt() / (w1[0] - x).pow(2).mean().sqrt()).item()
        changed = max(float((g != w).float().mean()) for g, w in zip(g1[1:], w1[1:]))
        assert rms <= ONE_BLOCK["rms"] and changed <= ONE_BLOCK["changed"], (rms, changed)


def test_splits_and_row_tiles_do_not_depend_on_the_batch():
    """Row tiles and splits come from the level's tokens (pn) and the card:
    contraction_splits takes no batch. Each split is a whole number of
    64-deep steps, lies within one d-deep int8 scale chunk or covers whole
    ones, and one batch row's items fit the 132 SMs."""
    d, hidden = 768, 3072
    want = {1: [6, 8], 5: [6, 8], 25: [6, 8], 50: [4, 4], 100: [6, 8]}
    for pn in PATCH_NUMS:
        bm = tab.row_tile(pn)
        assert bm == (32 if pn <= 64 else 128)
        splits = tab.contraction_splits(pn, ((d, d), (d, hidden)), d, SMS)
        assert splits == want[pn], pn
        for k, s in zip((d, hidden), splits):
            assert k % (s * 64) == 0 and (d % (k // s) == 0 or (k // s) % d == 0)
            assert math.ceil(pn / bm) * (d // tab.TILE_N) * s <= SMS


# The wgmma engine's tile plans (ops/ar_block_stack.gemm_plan) of the four
# products (q/k/v, projection, fc1, fc2) at pn = PATCH_NUMS, at B = 1 and the
# stream cells' batches, on the H100's 132 SMs: W = wide, F = folded.
PLANS = {1: {1: "----", 140: "----", 408: "-W-W"},
         5: {1: "----", 140: "-WWW", 408: "WWWW"},
         25: {1: "----", 140: "WFWF", 408: "WFWF"},
         50: {1: "----", 140: "WFWF", 408: "WFWF"},
         100: {1: "----", 140: "WFWF", 408: "WFWF"}}


def _plan_letters(plans) -> str:
    return "".join("F" if p & tab.PLAN_FOLD else "W" if p & tab.PLAN_WIDE else "-"
                   for p in plans)


@pytest.mark.parametrize("batch", [1, 140, 408])
def test_tile_plans_at_the_serving_batches(batch):
    """The tiles come from the launch's rows (B x pn): narrow at B = 1, wide
    and folded at the stream cells' batches; the splits come from pn alone,
    the same at every batch, and a folded product is always wide."""
    d, hidden = 768, 3072
    for pn in PATCH_NUMS:
        splits = tab.contraction_splits(pn, ((d, d), (d, hidden)), d, SMS)
        products = ((3 * d, d, 1), (d, d, splits[0]), (hidden, d, 1), (d, hidden, splits[1]))
        plans = [tab.gemm_plan(batch * pn, n, k, s, d, SMS) for n, k, s in products]
        assert _plan_letters(plans) == PLANS[pn][batch], (pn, batch)
        for p in plans:
            assert not p & tab.PLAN_FOLD or p & tab.PLAN_WIDE
        assert splits == tab.contraction_splits(pn, ((d, d), (d, hidden)), d, SMS)


@pytest.mark.parametrize("rows,n,k,splits,chunk,want", [
    (128 * 132, 128, 768, 6, 768, tab.PLAN_WIDE | tab.PLAN_FOLD),   # one wide tile per SM
    (128 * 131, 128, 768, 6, 768, tab.PLAN_WIDE),                   # one short: split items
    (128 * 131, 128, 768, 1, 768, 0),                               # unsplit and short: narrow
    (128 * 132, 128, 768, 1, 768, tab.PLAN_WIDE),                   # nothing to fold
    (128 * 132, 128, 3072, 2, 768, tab.PLAN_WIDE),                  # a split over two chunks
    (128 * 132, 128, 3072, 2, None, tab.PLAN_WIDE | tab.PLAN_FOLD),  # bf16: no chunks
    (128 * 264, 192, 768, 6, 768, 0),                               # 192 columns: no wide tile
])
def test_fold_engages_when_the_grid_is_full(rows, n, k, splits, chunk, want):
    """A CTA adds the splits itself only when the 128 x 128 tiles alone give
    each of the SMs an item, and for int8 only where each split lies within
    one scale chunk; wide when the items (split or folded) fill the grid."""
    assert tab.gemm_plan(rows, n, k, splits, chunk, SMS) == want


def test_folded_splits_equal_the_row_pass_sum():
    """The fold inside the CTA against the row pass's sum of the split
    planes, in float32 as the card adds them: int8 packs scale each split's
    sum (one chunk) and add it, bf16 packs add the split's sum. Both start
    from 0 and take split 0 first, so they agree bit for bit; the same splits
    added last first (the planted fault of chip_smoke.py), or by a pairwise
    tree, do not."""
    rng = np.random.default_rng(7)
    d, splits, steps = 768, 6, 2
    acc = (rng.standard_normal((splits, 4096)) * np.exp(rng.uniform(-6, 6, (splits, 4096)))
           ).astype(np.float32)
    scale = rng.uniform(1e-3, 3e-2, (1, 4096)).astype(np.float32)
    for int8 in (True, False):
        # the split's value: its scaled sum (fmaf(acc, s, 0) rounds as acc * s) or its sum
        planes = acc * scale if int8 else acc
        assert planes.dtype == np.float32
        row_pass = np.zeros(4096, np.float32)
        for p in planes:                      # the row pass: v = 0; v += plane[s]
            row_pass = row_pass + p
        fold = np.zeros(4096, np.float32)
        for s in range(splits):               # the CTA: F = 0; F = __fadd_rn(F, value of s)
            fold = np.add(fold, planes[s], dtype=np.float32)
        assert fold.tobytes() == row_pass.tobytes()
        last_first = np.zeros(4096, np.float32)
        for s in reversed(range(splits)):
            last_first = last_first + planes[s]
        tree = (planes[0] + planes[1]) + (planes[2] + planes[3]) + (planes[4] + planes[5])
        assert (last_first != row_pass).any() and (tree != row_pass).any()
    assert d % (d // splits) == 0 and steps * 64 == d // splits   # one chunk a split
