"""The CUDA kernels against their plain versions, on the card: the
rasterizer, the AR block stack, the encoder block stack, the gaussian splat,
flash attention, the int32 key sort and the wav2vec2 conv front.

Marked ``cuda``: skipped without an NVIDIA GPU. This file imports neither jax
nor artalk_tpu, so it also runs on a GPU machine without them; there, skip
tests/conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The rasterizer evaluates the planes in the plain version's order without FMA
contraction, so face ids and depths must be bit-identical, also with its
per-face cull; its setup kernel must give the plain setup's planes and boxes
bit for bit. The block stacks
sum in another order than cuBLAS: float32 packs are held to 1e-4 (features)
and 1e-5 (keys and values), bf16 and int8 packs to 5e-2 (the AR stack) and to
tests/test_encoder_fused.py's 0.08 and 0.15 (the encoder stack); a batch row
must equal the same row run alone exactly, also four encoder windows in one
launch. The splat kernel and its plain
version composite the same instance lists in the same order, but sum in
another order (the plain version's transmittance is a cumprod, its colors a
matmul); a transmittance that rounds the other way at T_EPS moves the stop of
a pixel by one gaussian, at most T_EPS times its largest color (colors in
[0, 1] here), so they are held to 2e-4. Flash attention sums in another
order than the plain version's matmuls: float32 outputs are held to
tests/test_attention.py's 2e-5 and gradients to its 3e-5; bf16 outputs, a
float32 result rounded once on each side, to 1 bf16 ulp of the largest value.
The mesh renderer (its rasterizer kernel and its shading) must render the
same frames bit for bit twice. The sort kernel must equal both
sort_keys_plain and torch.sort exactly, and
the splat prepass through it must give the instance lists that torch.sort
gives. The TF32 probe (tests/tf32_probe.py) runs HuBERT in a fresh process
that imports only the HuBERT module: its outputs must not move when TF32 is
turned off afterwards. The conv front's kernels sum each convolution in
another order than cuDNN: per layer, fed the plain version's input, they are
held to the shares of equal elements and the ulps of CONV_LAYER_* below, the
whole front to CONV_FRONT_REL of its largest value; every row of 140 windows
must equal itself run alone exactly. The Whisper encoder in bfloat16 at its
published widths: each row of a batch of 4 within WHISPER_ROW_REL of the same
row encoded alone, and 32 flash-attention launches a window step. Each
product is one GEMM over every position, whose algorithm cuBLAS picks by the
number of rows: the rows read 1.6e-7-2.6e-7 on the card, but a rounding
flipped in one of 32 layers grows through the rest (1.5e-2-1.7e-2 when the
products ran as batched GEMMs whose algorithm changed with the batch), so the
limit lies under how far the bf16 encode lies from float32 in the Whisper
cell's runs (3.2e-2-3.6e-2) and far under rows that mix (order 1).
"""

import itertools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from artalk_tpu_torch.models import nn as tnn
from artalk_tpu_torch.models.ar_model import _Blocks
from artalk_tpu_torch.models.wav2vec import _Layers
from artalk_tpu_torch.ops import ar_block_stack as tab
from artalk_tpu_torch.ops import attention as tatt
from artalk_tpu_torch.ops import encoder_block_stack as teb
from artalk_tpu_torch.ops import gsplat as tgs
from artalk_tpu_torch.ops import rasterizer as tr
from artalk_tpu_torch.ops import sort as tsort
from artalk_tpu_torch.ops._nvcc import launches

PACK_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _added(before: dict) -> dict:
    """The launch counter's increase since ``before`` (``launches()``), by key."""
    return {k: n - before[k] for k, n in launches().items()}


def _scenes():
    """The four scenes of tests/test_rasterizer.py, plus a larger one."""
    def random_scene(rng, num_verts=300, num_faces=512, h=64, w=256):
        verts = np.zeros((num_verts, 3), np.float32)
        verts[:, 0] = rng.uniform(-10, w + 10, num_verts)
        verts[:, 1] = rng.uniform(-10, h + 10, num_verts)
        verts[:, 2] = rng.uniform(0.5, 5.0, num_verts)
        faces = rng.integers(0, num_verts, (num_faces, 3)).astype(np.int32)
        return verts, faces, h, w

    yield random_scene(np.random.default_rng(0))
    yield random_scene(np.random.default_rng(0), num_faces=200, w=128)
    yield np.zeros((3, 3), np.float32), np.array([[0, 1, 2]], np.int32), 32, 128
    yield (np.array([[10, 10, 2.0], [100, 10, 2.0], [10, 100, 2.0],
                     [10, 10, 3.0], [100, 10, 3.0], [10, 100, 3.0]], np.float32),
           np.array([[3, 4, 5], [0, 1, 2]], np.int32), 64, 128)
    yield random_scene(np.random.default_rng(1), num_verts=3000, num_faces=20000,
                       h=200, w=300)   # ragged tile edges, 157 chunks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full float32
    return torch.device("cuda")


def _blocks(depth=2, d=256, hidden=1024, heads=4, seed=0):
    """Mid-size AdaLN blocks with random weights and per-head scales."""
    gen = torch.Generator().manual_seed(seed)
    blocks = _Blocks(depth, d, 32, hidden, heads).requires_grad_(False)
    for lin in (blocks.ada_lin, blocks.q, blocks.k, blocks.v, blocks.proj, blocks.fc1,
                blocks.fc2):
        tnn.linear_init(lin, gen)
    blocks.scale_mul.copy_(math.log(4.0) + torch.rand(blocks.scale_mul.shape, generator=gen))
    return blocks


def _ar_inputs(b, pn, start, depth=2, d=256, cache_len=96, cache_dtype=torch.float32, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, pn, d), generator=g) * 0.3
    ada = torch.randn((depth, b, pn, 6 * d), generator=g) * 0.1
    kc = tnn.l2_normalize(torch.randn((depth, b, cache_len, d), generator=g).reshape(
        depth, b, cache_len, 4, d // 4)).reshape(depth, b, cache_len, d).to(cache_dtype)
    vc = (torch.randn((depth, b, cache_len, d), generator=g) * 0.2).to(cache_dtype)
    return x, ada, kc, vc


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_ar_block_stack_matches_plain(cuda, mode):
    pack = tab.pack_block_weights(_blocks().to(cuda), 4, dtype=PACK_DTYPES[mode])
    cache_dtype = torch.float32 if mode == "f32" else torch.bfloat16
    for pn, start in ((1, 40), (5, 41), (25, 46), (50, 46)):
        args = [t.to(cuda) for t in _ar_inputs(3, pn, start, cache_dtype=cache_dtype)]
        before = launches()
        got = tab.ar_block_stack(args[0], args[1], pack, args[2], args[3], start=start,
                                 num_heads=4)
        added = _added(before)
        assert added["ar_block_stack"] == added[f"ar_block_stack/{mode}"] == 1
        want = tab.ar_block_stack_plain(args[0], args[1], pack, args[2], args[3], start=start,
                                        num_heads=4)
        torch.cuda.synchronize()
        assert got[1].dtype == got[2].dtype == cache_dtype
        feats_tol, kv_tol = (1e-4, 1e-5) if mode == "f32" else (5e-2, 5e-2)
        torch.testing.assert_close(got[0], want[0], atol=feats_tol, rtol=feats_tol)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g.float(), w.float(), atol=kv_tol, rtol=kv_tol)
        row = tab.ar_block_stack(args[0][1:2], args[1][:, 1:2].contiguous(), pack,
                                 args[2][:, 1:2].contiguous(), args[3][:, 1:2].contiguous(),
                                 start=start, num_heads=4)
        for g, r in zip((got[0][1:2], got[1][:, 1:2], got[2][:, 1:2]), row):
            assert torch.equal(g, r), (mode, pn)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_ar_rows_equal_alone(cuda, mode):
    """At B = 1, 5 and 8 (up to 800 rows over 13 row tiles of 64 or 7 of 128;
    7 of 128 or 25 of 32 for the float32 pack), each batch row equals the same row run
    alone bit for bit: the splits come from pn, never from the batch, and the
    tile plan, which the launch's rows choose, changes no row's arithmetic."""
    pack = tab.pack_block_weights(_blocks().to(cuda), 4, dtype=PACK_DTYPES[mode])
    cache_dtype = torch.float32 if mode == "f32" else torch.bfloat16
    for pn, start in ((5, 41), (50, 60), (100, 60)):
        args = [t.to(cuda) for t in _ar_inputs(8, pn, start, cache_len=160,
                                               cache_dtype=cache_dtype)]
        alone = [tab.ar_block_stack(args[0][r:r + 1], args[1][:, r:r + 1].contiguous(), pack,
                                    args[2][:, r:r + 1].contiguous(),
                                    args[3][:, r:r + 1].contiguous(), start=start, num_heads=4)
                 for r in range(8)]
        for b in (1, 5, 8):
            got = tab.ar_block_stack(args[0][:b], args[1][:, :b].contiguous(), pack,
                                     args[2][:, :b].contiguous(), args[3][:, :b].contiguous(),
                                     start=start, num_heads=4)
            for r in range(b):
                for g, a in zip((got[0][r:r + 1], got[1][:, r:r + 1], got[2][:, r:r + 1]),
                                alone[r]):
                    assert torch.equal(g, a), (mode, pn, b, r)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_ar_folded_rows_equal_alone(cuda, mode):
    """At B = 96 and pn 100 (9,600 rows: 75 row tiles of 128 by 2 of 128
    columns fill the 132 SMs) the projection's and fc2's splits are added
    inside the CTA: the launch counts under its pack with 2 folded products
    a block, and each sampled row equals the same row run alone
    (its splits added by the row pass) bit for bit."""
    pack = tab.pack_block_weights(_blocks().to(cuda), 4, dtype=PACK_DTYPES[mode])
    args = [t.to(cuda) for t in _ar_inputs(96, 100, 60, cache_len=160,
                                           cache_dtype=torch.bfloat16)]
    before = launches()
    got = tab.ar_block_stack(args[0], args[1], pack, args[2], args[3], start=60, num_heads=4)
    added = _added(before)
    assert added[f"ar_block_stack/{mode}"] == 1
    assert added["ar_block_stack/folded"] == 2 * 2
    for r in (0, 47, 95):
        one = tab.ar_block_stack(args[0][r:r + 1], args[1][:, r:r + 1].contiguous(), pack,
                                 args[2][:, r:r + 1].contiguous(),
                                 args[3][:, r:r + 1].contiguous(), start=60, num_heads=4)
        for g, a in zip((got[0][r:r + 1], got[1][:, r:r + 1], got[2][:, r:r + 1]), one):
            assert torch.equal(g, a), (mode, r)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_encoder_folded_windows_equal_alone(cuda, mode):
    """48 windows in one launch (9,552 rows, 75 row tiles of 128): the split
    products are folded inside the CTA, and each sampled window equals the
    same window run alone bit for bit."""
    gen = torch.Generator().manual_seed(4)
    layers = _Layers(256, 1024, 2, 1e-5).requires_grad_(False)
    for lin in (layers.q, layers.k, layers.v, layers.out, layers.fc1, layers.fc2):
        tnn.linear_init(lin, gen)
    pack = teb.pack_encoder_weights(layers.to(cuda), dtype=PACK_DTYPES[mode])
    x = (torch.randn((48, 199, 256), generator=gen) * 0.5).to(cuda)
    before = launches()
    got = teb.encoder_block_stack(x, pack, num_heads=4)
    assert _added(before)["encoder_block_stack/folded"] == 2 * 2
    for r in (0, 23, 47):
        assert torch.equal(got[r:r + 1], teb.encoder_block_stack(x[r:r + 1], pack, num_heads=4))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tol", [("f32", 1e-4), ("bf16", 0.08), ("int8", 0.15)])
def test_encoder_block_stack_matches_plain(cuda, mode, tol):
    gen = torch.Generator().manual_seed(2)
    layers = _Layers(256, 1024, 2, 1e-5).requires_grad_(False)
    for lin in (layers.q, layers.k, layers.v, layers.out, layers.fc1, layers.fc2):
        tnn.linear_init(lin, gen)
    for norm in (layers.norm1, layers.norm2):
        norm.scale.copy_(1.0 + 0.1 * torch.randn(norm.scale.shape, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(norm.bias.shape, generator=gen))
    pack = teb.pack_encoder_weights(layers.to(cuda), dtype=PACK_DTYPES[mode])
    x = (torch.randn((2, 199, 256), generator=gen) * 0.5).to(cuda)
    before = launches()
    got = teb.encoder_block_stack(x, pack, num_heads=4)
    added = _added(before)
    assert added["encoder_block_stack"] == added[f"encoder_block_stack/{mode}"] == 1
    want = teb.encoder_block_stack_plain(x, pack, num_heads=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert torch.equal(got[1:], teb.encoder_block_stack(x[1:], pack, num_heads=4))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_encoder_rows_equal_alone_at_pool_capacity(cuda, mode):
    """Four windows in one launch (StreamPool's capacity, 796 rows over 13
    row tiles of 64): each equals the same window run alone bit for bit."""
    gen = torch.Generator().manual_seed(3)
    layers = _Layers(256, 1024, 2, 1e-5).requires_grad_(False)
    for lin in (layers.q, layers.k, layers.v, layers.out, layers.fc1, layers.fc2):
        tnn.linear_init(lin, gen)
    pack = teb.pack_encoder_weights(layers.to(cuda), dtype=PACK_DTYPES[mode])
    x = (torch.randn((4, 199, 256), generator=gen) * 0.5).to(cuda)
    got = teb.encoder_block_stack(x, pack, num_heads=4)
    for r in range(4):
        assert torch.equal(got[r:r + 1], teb.encoder_block_stack(x[r:r + 1], pack, num_heads=4))


@pytest.mark.cuda
def test_block_stacks_reject_bad_inputs(cuda):
    pack = tab.pack_block_weights(_blocks().to(cuda), 4)
    x, ada, kc, vc = (t.to(cuda) for t in _ar_inputs(1, 5, 41))
    with pytest.raises(ValueError, match="caches"):
        tab.ar_block_stack(x, ada, pack, kc.half(), vc.half(), start=41, num_heads=4)
    with pytest.raises(ValueError, match="exceed"):
        tab.ar_block_stack(x, ada, pack, kc, vc, start=94, num_heads=4)
    with pytest.raises(ValueError, match="head dim"):
        tab.ar_block_stack(x, ada, pack, kc, vc, start=41, num_heads=5)
    with pytest.raises(ValueError, match="contiguous"):
        tab.ar_block_stack(x, ada, {**pack, "wqkv": pack["wqkv"].cpu()}, kc, vc, start=41,
                           num_heads=4)
    with pytest.raises(ValueError, match="scales"):
        tab.ar_block_stack(x, ada, {**pack, "wqkv": pack["wqkv"].to(torch.int8)}, kc, vc,
                           start=41, num_heads=4)
    with pytest.raises(ValueError, match=r"\(B, T, d\)"):
        teb.encoder_block_stack(x[0], {}, num_heads=4)


@pytest.mark.cuda
def test_kernel_matches_plain(cuda):
    for verts, faces, h, w in _scenes():
        vs, fs = torch.from_numpy(verts).to(cuda), torch.from_numpy(faces).to(cuda)
        before = launches()
        zk, fk = tr.rasterize(vs, fs, height=h, width=w)
        assert _added(before)["rasterize"] == 1
        zp, fp = tr.rasterize_plain(vs, fs, height=h, width=w)
        torch.cuda.synchronize()
        assert torch.equal(fk, fp) and torch.equal(zk, zp), (h, w, len(faces))


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["adversarial", "flame"])
def test_kernel_culls_without_changing_the_output(cuda, scene):
    """The setup kernel's planes, cull boxes and chunk boxes equal
    kernel_inputs_plain's (face_planes and chunk_bboxes of the padded faces)
    bit for bit; the per-face culled kernel equals rasterize_plain, which
    evaluates every face of every chunk that overlaps a tile, on the
    adversarial scene of tests/raster_scenes.py (needles whose planes cover
    centres pixels beyond their vertices, slivers at the 1e-12 area cut,
    vertices on tile edges, faces behind the camera) and on the FLAME head."""
    from raster_scenes import adversarial_scene, flame_head

    verts, faces, h, w = adversarial_scene() if scene == "adversarial" else flame_head()
    want_inputs = tr.kernel_inputs_plain(verts, faces, height=h, width=w)
    want = tr.rasterize_plain(verts, faces, height=h, width=w)
    vs, fs = verts.to(cuda), faces.to(cuda)
    for index_type in (torch.int64, torch.int32):
        got_inputs = tr.kernel_inputs(vs, fs.to(index_type), height=h, width=w)
        got = tr.rasterize(vs, fs.to(index_type), height=h, width=w)
        torch.cuda.synchronize()
        for g, x in zip(got_inputs, want_inputs):
            assert torch.equal(g.cpu(), x)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    verts = torch.zeros((3, 3), dtype=torch.float64, device=cuda)
    faces = torch.zeros((1, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        tr.rasterize(verts, faces, height=8, width=32)
    with pytest.raises(ValueError, match="faces"):
        tr.rasterize(verts.float(), faces.cpu(), height=8, width=32)


def _splat_scenes():
    """tests/test_gsplat.py's scenes (random 400, empty, front to back, the
    oversized splat), and a denser one of 20,000 gaussians."""
    cam = np.array([[-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 5000.0 / 512]], np.float32)

    def random_scene(rng, n=400, spread=0.08):
        q = rng.normal(size=(n, 4))
        return (rng.normal(0, spread, (n, 3)), rng.random((n, 32)), rng.random((n, 1)),
                rng.random((n, 3)) * 0.03 + 0.005, q / np.linalg.norm(q, axis=1, keepdims=True))

    def single(xyz, colors, opac, scale):
        n = len(xyz)
        return xyz, colors, opac, np.full((n, 3), scale), np.tile([[1.0, 0, 0, 0]], (n, 1))

    scenes = [random_scene(np.random.default_rng(0)),
              random_scene(np.random.default_rng(1), n=20000, spread=0.15),
              single([[0.0, 0.0, 100.0]], np.ones((1, 32)), [[1.0]], 0.01),
              single([[0, 0, 0.5], [0, 0, -0.5]], np.stack([np.ones(32), np.zeros(32)]),
                     [[0.999], [0.999]], 0.02),
              single(np.zeros((1, 3)), np.ones((1, 32)), [[0.9]], 0.7)]
    for scene in scenes:
        yield [np.asarray(a, np.float32) for a in (*scene, cam)]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_colors", [False, True])
@pytest.mark.parametrize("size", [128, 512])
def test_splat_matches_plain(cuda, size, bf16_colors):
    for scene in _splat_scenes():
        args = [torch.from_numpy(a).to(cuda) for a in scene]
        before = launches()
        got = tgs.rasterize_gaussians(*args, size=size, bf16_colors=bf16_colors)
        assert _added(before)["gsplat"] == 1
        want = tgs.rasterize_gaussians_plain(*args, size=size, bf16_colors=bf16_colors)
        torch.cuda.synchronize()
        assert got.shape == (32, size, size) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_colors", [False, True])
def test_splat_dense_scene_matches_plain(cuda, bf16_colors):
    """bench.py's splat scene (seed 3: 5023 head-sized gaussians and two
    296^2 sheets, 180,255 in all; its densest tile lists about 25,000
    splats) at 512 x 512: the culling kernel against splat_tiles_plain
    within 2e-4 of the largest color."""
    n_head, n_plane = 5023, 296 * 296
    n = n_head + 2 * n_plane
    rng = np.random.default_rng(3)
    xyz = np.concatenate([rng.normal(0, 0.09, (n_head, 3)),
                          rng.normal(0, 0.12, (2 * n_plane, 3))]).astype(np.float32)
    colors = rng.random((n, 32)).astype(np.float32)
    opac = (rng.random((n, 1)) * 0.9 + 0.05).astype(np.float32)
    scales = (rng.random((n, 3)) * 0.004 + 0.001).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cam = np.array([[-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 5000.0 / 512]], np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (xyz, colors, opac, scales, q, cam)]
    geo, cols, inst, offsets = tgs.prepass(*args, size=512, bf16_colors=bf16_colors)
    got = tgs.splat_tiles(geo, cols, inst, offsets, 512)
    want = tgs.splat_tiles_plain(geo, cols, inst, offsets, 512)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_splat_rejects_bad_inputs(cuda):
    geo, colors, inst, offsets = tgs.prepass(
        *[torch.from_numpy(a).to(cuda) for a in next(_splat_scenes())], size=128)
    with pytest.raises(ValueError, match="geo"):
        tgs.splat_tiles(geo.double(), colors, inst, offsets, 128)
    with pytest.raises(ValueError, match="colors"):
        tgs.splat_tiles(geo, colors.half(), inst, offsets, 128)
    with pytest.raises(ValueError, match="offsets"):
        tgs.splat_tiles(geo, colors, inst, offsets[:-1], 128)
    with pytest.raises(ValueError, match="one device"):
        tgs.splat_tiles(geo, colors, inst.cpu(), offsets, 128)


def _flash_cases():
    """(q, k, v, bias, scale): the model sites, tests/test_attention.py's
    bias and padding cases, a wholly masked row, head dims of 16, 100 and 128,
    a bias broadcast over heads and queries, the 4096 sweep length, and cases
    with enough heads for the row-block kernel."""
    rng = np.random.default_rng(4)

    def qkv(b, h, lq, lk, hd):
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((b, h, lq, hd), (b, h, lk, hd), (b, h, lk, hd))]

    lvl = np.array([0, 1, 1, 2, 2, 2, 3, 3])
    var = np.concatenate([np.zeros((8, 8)), np.where(lvl[:, None] >= lvl[None], 0.0, -np.inf)],
                         axis=1).astype(np.float32)[None, None]
    masked = np.zeros((1, 1, 20, 70), np.float32)
    masked[..., 3, :] = -np.inf
    yield (*qkv(1, 16, 199, 199, 64), None, 0.125)
    yield (*qkv(1, 12, 199, 199, 64), None, 0.125)
    yield (*qkv(2, 3, 181, 362, 64), None, 0.125)
    yield (*qkv(2, 3, 8, 16, 64), torch.from_numpy(var), 1.0)
    for lq, lk in ((100, 100), (181, 362), (57, 300)):
        yield (*qkv(1, 2, lq, lk, 64), None, 0.2)
    yield (*qkv(1, 1, 256, 640, 32), None, 0.1)
    yield (*qkv(1, 2, 20, 70, 64), torch.from_numpy(masked), 0.125)
    yield (*qkv(1, 2, 33, 47, 16), torch.from_numpy(rng.standard_normal((1, 2, 33, 47)).astype(
        np.float32)), 0.25)
    yield (*qkv(2, 2, 65, 130, 100), torch.from_numpy(rng.standard_normal((2, 1, 1, 130)).astype(
        np.float32)), 0.1)
    yield (*qkv(1, 4, 70, 97, 128), None, 128 ** -0.5)
    yield (*qkv(1, 16, 4096, 4096, 64), None, 0.125)   # tools/bench_flash_attention.py's longest
    # grids of more than half a CTA per SM take the one-warp-per-16-rows kernel,
    # the smaller ones the split-keys kernel: the bias, the ragged tile, a
    # wholly masked row and head dims of 100 and 128 on the first as well
    many = rng.standard_normal((8, 1, 100, 130)).astype(np.float32)
    many[:, :, 3] = -np.inf
    yield (*qkv(8, 20, 100, 130, 64), torch.from_numpy(many), 0.125)
    yield (*qkv(4, 40, 65, 130, 100), torch.from_numpy(rng.standard_normal((4, 1, 1, 130)).astype(
        np.float32)), 0.1)
    yield (*qkv(4, 40, 70, 97, 128), None, 128 ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_matches_plain(cuda, dtype):
    for q, k, v, bias, scale in _flash_cases():
        q, k, v = (t.to(cuda, dtype) for t in (q, k, v))
        bias = None if bias is None else bias.to(cuda)
        before = launches()
        got = tatt.flash_attention(q, k, v, bias, scale=scale)
        assert _added(before)["flash_attention"] == 1
        want = tatt.flash_attention_plain(q, k, v, bias, scale=scale)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        assert torch.isfinite(got).all()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        else:
            ulp = 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)
            assert (got.float() - want.float()).abs().max().item() <= ulp, tuple(q.shape)


@pytest.mark.cuda
def test_flash_attention_launches_directly_without_grad(cuda):
    """Inputs that need a gradient go through the autograd Function; under
    no_grad, or without such inputs, the kernel is launched directly. Both
    give the same output, bit for bit, at both model sites."""
    sites = [case for case, _ in zip(_flash_cases(), range(2))]
    for (q, k, v, _, scale), dtype in itertools.product(sites, (torch.float32, torch.bfloat16)):
        q, k, v = (t.to(cuda, dtype).requires_grad_() for t in (q, k, v))
        before = launches()
        graph = tatt.flash_attention(q, k, v, scale=scale)
        with torch.no_grad():
            direct = tatt.flash_attention(q, k, v, scale=scale)
        plain = tatt.flash_attention(q.detach(), k.detach(), v.detach(), scale=scale)
        torch.cuda.synchronize()
        assert _added(before)["flash_attention"] == 3
        assert graph.grad_fn is not None and direct.grad_fn is None and plain.grad_fn is None
        assert torch.equal(graph, direct) and torch.equal(direct, plain)


@pytest.mark.cuda
def test_flash_attention_gradients_match_plain(cuda):
    """The autograd path (kernel forward, the float32 recompute backward)
    against autograd through the plain version; the bias gradient keeps the
    bias's broadcast shape."""
    rng = np.random.default_rng(5)
    shapes = ((1, 2, 32, 16), (1, 2, 48, 16), (1, 2, 48, 16), (1, 1, 32, 48))
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = []
    for fn in (tatt.flash_attention, tatt.flash_attention_plain):
        leaves = [torch.from_numpy(a).to(cuda).requires_grad_() for a in arrays]
        o = fn(*leaves[:3], leaves[3], scale=0.25)
        (o * torch.cos(o)).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=3e-5, rtol=0)


@pytest.mark.cuda
def test_flash_attention_rejects_bad_inputs(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_attention(*(torch.zeros((1, 2, 8, 129), device=cuda),) * 3)
    with pytest.raises(ValueError, match="one dtype"):
        tatt.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="do not fit"):
        tatt.flash_attention(q, q[..., :32], q)
    with pytest.raises(ValueError, match="bias"):
        tatt.flash_attention(q, q, q, torch.zeros((8, 8)))


def _sort_keys(rng, n):
    """Full-range int32 keys with duplicates and both ends."""
    keys = rng.integers(-(2 ** 31), 2 ** 31 - 1, size=n, dtype=np.int64, endpoint=True)
    if n >= 4:
        keys[: n // 4] = keys[n // 4: 2 * (n // 4)]
        keys[0], keys[-1] = -(2 ** 31), 2 ** 31 - 1
    return torch.from_numpy(keys.astype(np.int32))


@pytest.mark.cuda
def test_sort_matches_plain_and_torch_sort(cuda):
    """Also the CUDA launches the entry point reports: 6 for any n > 0 (init,
    histogram, one pass per 8-bit digit, a pass whose digit is constant
    returning on the device). Besides full-range keys: keys below 2^25 as the
    splat prepass builds them (the top digit constant), keys that differ only
    in their lowest digit, and all-equal keys (no pass runs: the input is
    copied)."""
    rng = np.random.default_rng(6)
    cases = [(n, _sort_keys(rng, n)) for n in (0, 1, 2, 3, 2047, 2048, 2049, 3839, 3840, 3841,
                                               5000, 1 << 16, 100_003, 1 << 19, 1 << 20,
                                               1 << 21)]
    cases += [(879_296, torch.from_numpy(rng.integers(0, 1 << 25, 879_296).astype(np.int32))),
              (70_000, torch.from_numpy(rng.integers(-7, 200, 70_000).astype(np.int32))),
              (10_000, torch.full((10_000,), -5, dtype=torch.int32))]
    for n, keys in cases:
        keys, want_launches = keys.to(cuda), 6 if n else 0
        before = launches()
        got = tsort.sort_keys(keys)
        added = _added(before)
        assert added["sort"] == (n > 0)
        assert added["sort/cuda"] == want_launches, n
        want = tsort.sort_keys_plain(keys)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (n,)
        assert torch.equal(got, want) and torch.equal(got, torch.sort(keys).values), n


@pytest.mark.cuda
def test_tf32_off_in_a_fresh_process(cuda):
    """tests/tf32_probe.py in a fresh process that imports only the HuBERT
    module: TF32 is on there after the import, the port's convolutions turn
    it off and restore it, and HuBERT's output and the conv frontend's equal
    the same calls after full_float32() to 1e-5 (TF32 convolutions differ by
    about 1e-3)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "tests", "tf32_probe.py")) as f:
        probe = f.read()
    proc = subprocess.run([sys.executable, "-c", probe], cwd=repo, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["tf32_after_import"][0] is True and not got["engine_imported"], got
    assert got["flags_after_calls"] == got["tf32_after_import"], got
    assert got["finite"] and got["shape"] == [1, 199, 768], got
    assert got["hubert_diff"] <= 1e-5 and got["frontend_diff"] <= 1e-5, got


@pytest.mark.cuda
def test_sort_rejects_bad_inputs(cuda):
    with pytest.raises(ValueError, match="int32"):
        tsort.sort_keys(torch.zeros(8, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="1-D"):
        tsort.sort_keys(torch.zeros((2, 4), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tsort.sort_keys(torch.zeros(16, dtype=torch.int32, device=cuda)[::2])


@pytest.mark.cuda
@pytest.mark.parametrize("size", [128, 512])
def test_prepass_sort_matches_torch_sort(cuda, size, monkeypatch):
    for scene in _splat_scenes():
        args = [torch.from_numpy(a).to(cuda) for a in scene]
        before = launches()
        _, _, inst, offsets = tgs.prepass(*args, size=size)
        assert _added(before)["sort"] == (inst.numel() > 0)
        with monkeypatch.context() as m:
            m.setattr(tgs, "sort_keys", lambda k: torch.sort(k).values)
            _, _, want_inst, want_offsets = tgs.prepass(*args, size=size)
        assert torch.equal(inst, want_inst) and torch.equal(offsets, want_offsets)


@pytest.mark.cuda
def test_mesh_renderer_is_deterministic(cuda):
    """Two renders of the same frames are equal bit for bit on the card (the
    vertex normals sum in a fixed order, not by an atomic scatter-add), as
    parallel.render_frames_dp's equality with the renderer needs."""
    from artalk_tpu_torch.models.flame import FlameModel
    from artalk_tpu_torch.models.renderer import MeshRenderer
    from artalk_tpu_torch.utils.assets import synthetic_flame

    data = synthetic_flame(num_verts=2000, num_faces=4000, seed=3)
    renderer = MeshRenderer(256, data["faces"], template_verts=data["v_template"], device=cuda)
    motion = torch.from_numpy(np.random.default_rng(0).normal(0, 0.3, (8, 106))
                              .astype(np.float32)).to(cuda)
    with torch.no_grad():
        verts = FlameModel(data).to(cuda).motion_to_verts(torch.zeros(8, 300, device=cuda),
                                                          motion)
        assert torch.equal(renderer(verts), renderer(verts))


# the conv front's kernels against the plain version fed the same input, per
# layer: the sums are taken in another order, so a bf16 rounding flips by one
# ulp in a few elements of each conv's sum; the LayerNorm then scales such a
# flip by its scale over the row's deviation, which can reach a few ulps of
# the layer's largest value (2 ulps read on the card, PERF.md §6)
CONV_LAYER_EQUAL = 0.999          # share of elements equal
CONV_LAYER_NEAR = 0.9995          # share within 1 ulp of their own magnitude
CONV_LAYER_ULPS_OF_MAX = 4        # max |got - want| in ulps of the largest |value|
# the whole front: the flips of seven layers carried through the later convs,
# LayerNorms and the projection (0.013 of the largest value read at B = 140)
CONV_FRONT_REL = 0.03


def _conv_front(cuda):
    """The production conv front in bf16 on the card (one encoder layer),
    seed-0 weights with conv biases and LayerNorm rows off their defaults."""
    from artalk_tpu_torch.config import Wav2VecConfig
    from artalk_tpu_torch.models.wav2vec import Wav2VecEncoder

    enc = Wav2VecEncoder(Wav2VecConfig(num_hidden_layers=1)).init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.endswith(("norm.scale", "norm.bias", "conv.b")):
                p.add_(torch.randn(p.shape, generator=g) * 0.3)
    return enc.to(cuda, torch.bfloat16).requires_grad_(False)


def _conv_audio(b, cuda, seed=5):
    from artalk_tpu_torch.models.wav2vec import normalize_audio

    g = torch.Generator().manual_seed(seed)
    return normalize_audio((torch.randn((b, 64000), generator=g) * 0.1).to(cuda, torch.bfloat16))


def _bf16_ulps(got, want):
    def ordered(t):
        u = t.contiguous().view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

    return (ordered(got) - ordered(want)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 140])
def test_conv_frontend_layers_match_plain(cuda, b):
    from artalk_tpu_torch.ops import conv_frontend as tcf

    enc = _conv_front(cuda)
    pack = enc.pack_frontend()
    x = _conv_audio(b, cuda)
    with torch.no_grad():
        for i in range(len(pack["stride"]) + 1):
            if i < len(pack["stride"]):
                got, want = tcf.conv_layer(x, pack, i), tcf.conv_layer_plain(x, pack, i)
            else:
                x = enc._project(x)
                got, want = tcf.pos_conv_residual(x, pack), tcf.pos_conv_residual_plain(x, pack)
            assert got.shape == want.shape and got.dtype == torch.bfloat16
            gaps = _bf16_ulps(got, want)
            top = want.float().abs().max().item()
            ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
            err = (got.float() - want.float()).abs().max().item()
            assert (gaps == 0).float().mean().item() >= CONV_LAYER_EQUAL, i
            assert (gaps <= 1).float().mean().item() >= CONV_LAYER_NEAR, i
            assert err <= CONV_LAYER_ULPS_OF_MAX * ulp, (i, err, ulp)
            x = want


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 140])
def test_conv_frontend_matches_plain(cuda, b):
    from artalk_tpu_torch.ops import conv_frontend as tcf

    enc = _conv_front(cuda)
    pack = enc.pack_frontend()
    a = _conv_audio(b, cuda, seed=6)
    with torch.no_grad():
        before = launches()
        got = tcf.conv_frontend(a, pack, enc._project)
        assert _added(before)["conv_frontend"] == tcf.launches_per_call(pack) == 8
        want = tcf.conv_frontend_plain(a, pack, enc._project)
    assert got.shape == want.shape == (b, 199, 1024) and got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err.item() <= CONV_FRONT_REL


@pytest.mark.cuda
def test_conv_frontend_rows_equal_alone(cuda):
    """Every row of the stream cell's 140 windows equals itself run alone,
    bit for bit."""
    from artalk_tpu_torch.ops import conv_frontend as tcf

    enc = _conv_front(cuda)
    pack = enc.pack_frontend()
    a = _conv_audio(140, cuda, seed=7)
    with torch.no_grad():
        got = tcf.conv_frontend(a, pack, enc._project)
        for r in range(140):
            assert torch.equal(got[r:r + 1], tcf.conv_frontend(a[r:r + 1], pack, enc._project)), r


@pytest.mark.cuda
def test_conv_frontend_launches_per_window(cuda):
    """The AR model's window encode launches the conv front's kernels once
    per conv in a bf16 mode, with the pack it built once, and never in the
    exact mode or with inputs that need a gradient."""
    import dataclasses

    from artalk_tpu_torch.config import ARConfig, ModelConfig, VAEConfig, Wav2VecConfig
    from artalk_tpu_torch.models.ar_model import BitwiseARModel

    cfg = ModelConfig(ar=ARConfig(depth=1, num_heads=2, embed_dim=64, style_dim=16),
                      vae=VAEConfig(motion_dim=8, code_dim=4, depth=1, num_heads=2,
                                    hidden_dim=16, patch_nums=(1, 5, 25, 50, 100)),
                      wav2vec=Wav2VecConfig(num_hidden_layers=1))
    model = BitwiseARModel(cfg).init(torch.Generator().manual_seed(0)).to(cuda)
    chunk = torch.randn((2, model.window_samples), generator=torch.Generator().manual_seed(1))
    chunk = chunk.to(cuda) * 0.1
    with torch.no_grad():
        before = launches()
        exact = model.audio_condition(chunk)
        assert _added(before)["conv_frontend"] == 0
        model.set_precision(dataclasses.replace(cfg, bf16_audio=True, bf16_ar=True))
        pack = model.frontend_pack()
        before = launches()
        for _ in range(3):
            fast = model.audio_condition(chunk)
        assert _added(before)["conv_frontend"] == 3 * 8
        assert model.frontend_pack() is pack
    assert fast.shape == exact.shape and torch.isfinite(fast).all()
    model.audio_encoder.requires_grad_(True)
    before = launches()
    model.audio_condition(chunk)
    assert _added(before)["conv_frontend"] == 0


WHISPER_ROW_REL = 4e-2


@pytest.mark.cuda
def test_whisper_window_step_rows_and_flash_launches(cuda):
    """One Whisper window step at B = 4 in bfloat16 (published widths, a
    small AR model): 32 flash-attention launches, each row's condition
    within WHISPER_ROW_REL of its own B = 1 encode, and the context rolled
    exactly."""
    from artalk_tpu_torch.config import ARConfig, ModelConfig, VAEConfig
    from artalk_tpu_torch.models.ar_model import BitwiseARModel

    cfg = ModelConfig(ar=ARConfig(depth=1, num_heads=2, audio_encoder="whisper", embed_dim=64,
                                  style_dim=16),
                      vae=VAEConfig(motion_dim=8, code_dim=4, depth=1, num_heads=2,
                                    hidden_dim=16, patch_nums=(1, 5, 25, 50, 100)),
                      bf16_audio=True, bf16_ar=True)
    model = BitwiseARModel(cfg).init(torch.Generator().manual_seed(0)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    style = model.encode_style(None)
    state = model.initial_state(style, batch_size=4)
    state = state._replace(audio_ctx=torch.randn(state.audio_ctx.shape, generator=gen,
                                                 device=cuda) * 0.1)
    chunk = torch.randn((4, model.window_samples), generator=gen, device=cuda) * 0.1
    with torch.no_grad():
        before = launches()
        new, motion = model.window_step(state, chunk, style)
        torch.cuda.synchronize()
        assert _added(before)["flash_attention"] == 32
        assert torch.isfinite(motion).all()
        assert torch.equal(new.audio_ctx, torch.cat([state.audio_ctx, chunk], 1)[:, 64000:])
        weights = model.audio_weights()
        together = model.audio_condition(chunk, state.audio_ctx)
        assert model.audio_weights() is weights
        for r in range(4):
            alone = model.audio_condition(chunk[r:r + 1], state.audio_ctx[r:r + 1])
            err = (together[r:r + 1] - alone).abs().max() / alone.abs().max()
            print(f"whisper row {r}: {err.item():.3e} of the largest value alone")
            assert err.item() <= WHISPER_ROW_REL, r
