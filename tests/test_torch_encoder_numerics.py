"""A CPU rehearsal of the encoder block-stack kernel's arithmetic
(csrc/mma_stages.cuh) against encoder_block_stack_plain.

The kernel computes each product on the tensor cores:

- float32 packs as 3xTF32: each operand x is split into hi = tf32(x) and
  lo = tf32(x - hi) (round to nearest, as the kernel rounds by adding half a
  TF32 ulp to the bits and masking the 13 low mantissa bits), and a product
  is hi.hi + (lo.hi + hi.lo), the cross terms summed apart;
- bf16 and int8 packs with bf16 operands and float32 sums, an int8 pack's
  sums scaled per scale chunk, and the output projection's and fc2's
  contraction split as the kernel splits it (encoder_splits at 132 SMs),
  each split within one scale chunk, its sum scaled by that chunk's scale
  and the splits added in order, then the bias and the residual.

The emulation replays that order with CPU matmuls (the sums inside each
product run in another order than on the card; that is rounding noise of
the same size as the plain version's own). It must stay within
chip_smoke.py's ENCODER_TOL of the plain version (atol = rtol: float32
1e-4, bf16 and int8 0.04) through 24 narrow layers and through one layer at
the production width (d 1024, hidden 4096, 16 heads, 199 frames).
"""

import math

import numpy as np
import pytest
import torch

from artalk_tpu_torch.models import nn as tnn
from artalk_tpu_torch.models.wav2vec import _Layers
from artalk_tpu_torch.ops import encoder_block_stack as teb
from artalk_tpu_torch.ops.ar_block_stack import rounder, softmax_attend

from test_torch_params import torch_threads  # noqa: F401 (autouse)

ENCODER_TOL = {"f32": 1e-4, "bf16": 0.04, "int8": 0.04}
PACK_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
FRAMES = 199
SMS = 132   # H100 SXM


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel rounds it: (bits + 0x1000) & ~0x1fff."""
    bits = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    ah, wh = tf32(a), tf32(w)
    al, wl = tf32(a - ah), tf32(w - wh)
    return torch.matmul(ah, wh) + (torch.matmul(al, wh) + torch.matmul(ah, wl))


def mm_kernel(a: torch.Tensor, w: torch.Tensor, scales, splits: int, f32: bool) -> torch.Tensor:
    """A product as the kernel computes it, before bias and residual."""
    if f32:
        return mm_3xtf32(a.float(), w.float())
    a = a.to(torch.bfloat16).float()
    w = w.float()
    k = w.shape[0]
    chunk = k if scales is None else k // scales.shape[0]
    step = min(k // splits, chunk)
    y = None
    for s in range(0, k, k // splits):      # splits, added in order
        part = None
        for c in range(s, s + k // splits, step):   # scale chunks within a split
            p = torch.matmul(a[..., c:c + step], w[c:c + step])
            if scales is not None:
                p = p * scales[c // chunk]
            part = p if part is None else part + p
        y = part if y is None else y + part
    return y


def emulated_stack(x: torch.Tensor, pack: dict, num_heads: int, eps: float = 1e-5):
    f32 = pack["wqkv"].dtype == torch.float32
    rnd = rounder(pack)
    d = x.shape[-1]
    hidden = pack["wfc1"].shape[-1]
    sp_out, sp_fc2 = teb.encoder_splits(x.shape[1], d, hidden, SMS)
    hd = d // num_heads
    x = x.float()
    for i in range(pack["wqkv"].shape[0]):
        def sc(name):
            return pack[name][i] if name in pack else None

        y = tnn.layer_norm(x, eps, pack["ln1s"][i], pack["ln1b"][i])
        qkv = mm_kernel(y, pack["wqkv"][i], sc("sqkv"), 1, f32) + pack["bqkv"][i]
        q, k, v = (tnn.split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
        attn = tnn.merge_heads(softmax_attend(q, k, v, rnd, logit_scale=hd ** -0.5))
        x = x + (mm_kernel(attn, pack["wout"][i], sc("sout"), sp_out, f32) + pack["bout"][i])
        y = tnn.layer_norm(x, eps, pack["ln2s"][i], pack["ln2b"][i])
        h = tnn.gelu_erf(mm_kernel(y, pack["wfc1"][i], sc("sfc1"), 1, f32) + pack["bfc1"][i])
        x = x + (mm_kernel(h, pack["wfc2"][i], sc("sfc2"), sp_fc2, f32) + pack["bfc2"][i])
    return x


def _layers(d: int, hidden: int, depth: int, seed: int) -> _Layers:
    gen = torch.Generator().manual_seed(seed)
    layers = _Layers(d, hidden, depth, 1e-5).requires_grad_(False)
    for lin in (layers.q, layers.k, layers.v, layers.out, layers.fc1, layers.fc2):
        tnn.linear_init(lin, gen)
    for norm in (layers.norm1, layers.norm2):
        norm.scale.copy_(1.0 + 0.1 * torch.randn(norm.scale.shape, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(norm.bias.shape, generator=gen))
    return layers


def _tokens(d: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((1, FRAMES, d)) * 0.5).astype(np.float32))


def test_tf32_split():
    """hi keeps 10 mantissa bits, rounded to nearest; hi + lo is x to 2^-22."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = tf32(x)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(hi, dtype=torch.int32))
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    lo = tf32(x - hi)
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all()
    assert tf32(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0 + 2.0 ** -10   # a tie rounds up
    assert tf32(torch.tensor([-3.0])).item() == -3.0


@pytest.mark.parametrize("mode", list(PACK_DTYPES))
@pytest.mark.parametrize("d,hidden,heads,depth", [(256, 1024, 4, 24), (1024, 4096, 16, 1)],
                         ids=["narrow-24", "production-1"])
def test_kernel_arithmetic_within_encoder_tol(mode, d, hidden, heads, depth):
    pack = teb.pack_encoder_weights(_layers(d, hidden, depth, seed=d + depth),
                                    dtype=PACK_DTYPES[mode])
    x = _tokens(d, seed=depth)
    want = teb.encoder_block_stack_plain(x, pack, num_heads=heads)
    got = emulated_stack(x, pack, heads)
    assert torch.isfinite(got).all()
    tol = ENCODER_TOL[mode]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    if mode == "f32":   # 3xTF32 is float32 arithmetic, far inside the limit
        assert (got - want).abs().max().item() < tol / 10


def test_splits_do_not_depend_on_the_batch():
    """The kernel's splits come from one window's frames: the same at any
    batch, a whole number of 64-deep steps, each within one int8 scale
    chunk, at most one item per SM."""
    for d, hidden in ((256, 1024), (1024, 4096)):
        sp_out, sp_fc2 = teb.encoder_splits(FRAMES, d, hidden, SMS)
        for k, s in ((d, sp_out), (hidden, sp_fc2)):
            assert k % (s * 64) == 0 and d % (k // s) == 0
            assert math.ceil(FRAMES / teb.TILE_M) * (d // teb.TILE_N) * s <= SMS
    assert teb.encoder_splits(FRAMES, 1024, 4096, SMS) == (8, 8)
    assert teb.encoder_splits(4 * FRAMES, 1024, 4096, SMS)[1] == 4   # one chunk a split at least
    # the tiles of the bf16 / int8 packs' engine come from the launch's rows
    # (ops/ar_block_stack.gemm_plan), the splits above from one window: at
    # one window every product narrow; at the stream's 140 windows every
    # product wide and the splits folded
    from artalk_tpu_torch.ops import ar_block_stack as tab
    sp_out, sp_fc2 = teb.encoder_splits(FRAMES, 1024, 4096, SMS)
    products = ((3072, 1024, 1), (1024, 1024, sp_out), (4096, 1024, 1), (1024, 4096, sp_fc2))
    wide, fold = tab.PLAN_WIDE, tab.PLAN_WIDE | tab.PLAN_FOLD
    for windows, want in ((1, [0, 0, 0, 0]), (140, [wide, fold, wide, fold])):
        assert [tab.gemm_plan(windows * FRAMES, n, k, s, 1024, SMS)
                for n, k, s in products] == want, windows
