"""The port's GAGAvatar path against the JAX one on the CPU, module by module
through the parameter bridge, then the whole slice: render_motion_sequence
over two calls (the forehead EMA resumed) within 1 uint8 LSB, and the
engine and CLI with --load_gaga.

The whole-slice, engine and CLI tests shrink both packages the same way, by
monkeypatching: a 128-px camera, a 4-block DINO on 56-px input (so a 32x32
gaussian plane), a 128-px StyleUNet. Everything else (5023 FLAME gaussians,
32 channels, the splat and its prepass) is at full width."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artalk_tpu.models.flame import FlameModel as JFlame
from artalk_tpu.models.gagavatar import avatar as javatar
from artalk_tpu.models.gagavatar import dino as jdino
from artalk_tpu.models.gagavatar import generators as jgen
from artalk_tpu.models.gagavatar import style_unet as junet
from artalk_tpu.models.gagavatar import watermark as jwm
from artalk_tpu.ops import resize2d as jresize
from artalk_tpu.utils.assets import synthetic_flame
from artalk_tpu.utils.checkpoint import _flatten

from artalk_tpu_torch import cli as tcli
from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.models.flame import FlameModel as TFlame
from artalk_tpu_torch.models.gagavatar import avatar as tavatar
from artalk_tpu_torch.models.gagavatar import dino as tdino
from artalk_tpu_torch.models.gagavatar import generators as tgen
from artalk_tpu_torch.models.gagavatar import style_unet as tunet
from artalk_tpu_torch.models.gagavatar import watermark as twm
from artalk_tpu_torch.ops import resize2d as tresize
from artalk_tpu_torch.utils import video as tvideo
from artalk_tpu_torch.utils.assets import load_or_synthesize_flame

from test_engine import CFG, _write_wav
from test_torch_params import torch_config, with_jax_params
from test_torch_params import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")
# the DPT taps the last 4 blocks, so 4 is the least depth
SMALL_DINO = dict(patch_size=14, hidden_size=64, depth=4, num_heads=4, image_size=56)
J_DINO, T_DINO = jdino.DinoConfig(**SMALL_DINO), tdino.DinoConfig(**SMALL_DINO)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ----------------------------------------------------------------- resize2d


@pytest.mark.parametrize("align", [False, True])
def test_resize_bilinear_matches_jax(rng, align):
    """Both layouts, up and down, to 1e-6; a bf16 input comes back float32."""
    for (h, w), (oh, ow) in (((19, 37), (74, 74)), ((16, 16), (8, 8))):
        x = rng.standard_normal((2, 3, h, w)).astype(np.float32)
        want = jresize.resize_bilinear(jnp.asarray(x), oh, ow, align_corners=align)
        got = tresize.resize_bilinear(_t(x), oh, ow, align_corners=align)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
        xh = x.transpose(0, 2, 3, 1)
        want = jresize.resize_bilinear_nhwc(jnp.asarray(xh), oh, ow, align_corners=align)
        got = tresize.resize_bilinear_nhwc(_t(xh), oh, ow, align_corners=align)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    assert tresize.resize_bilinear(_t(x).bfloat16(), 4, 4).dtype == torch.float32


def test_resize_antialias_matches_jax(rng):
    """F.interpolate(antialias=True) against jax.image.resize(antialias=True)
    at the DPT's sizes (518 -> 148/74/37/19) and the encoder's 512 -> 518, to
    5e-6 (readings 2.4e-7 and 1.8e-6)."""
    img = rng.random((1, 3, 518, 518)).astype(np.float32)
    for size in (148, 74, 37, 19):
        want = jresize.resize_antialias(jnp.asarray(img), size, size)
        got = tresize.resize_antialias(_t(img), size, size)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-6)
    src = img[:, :, :512, :512]
    want = jresize.resize_antialias(jnp.asarray(src), 518, 518)
    np.testing.assert_allclose(_np(tresize.resize_antialias(_t(src), 518, 518)),
                               np.asarray(want), atol=5e-6)


# --------------------------------------------------------------- generators


def test_generators_match_jax(rng):
    """Both generators (with the reference's quirks: the linear rotation
    normalised over the vertex axis, the conv colors' sigmoid over the first
    3 width columns) on the same weights, to 1e-5; the plane and camera
    geometry as well."""
    feats = rng.standard_normal((1, 10, 64)).astype(np.float32)
    direnc = rng.standard_normal((1, 27)).astype(np.float32)
    jg = jgen.LinearGSGenerator(in_dim=64)
    jp = jax.jit(jg.init)(jax.random.PRNGKey(0))
    want = jax.jit(jg.__call__)(jp, jnp.asarray(feats), jnp.asarray(direnc))
    got = with_jax_params(tgen.LinearGSGenerator(in_dim=64), jp)(_t(feats), _t(direnc))
    for k, w in want.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(np.linalg.norm(_np(got["rotations"]), axis=1), 1.0, atol=1e-5)

    fmap = rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
    jc = jgen.ConvGSGenerator(in_dim=16)
    jp = jax.jit(jc.init)(jax.random.PRNGKey(1))
    want = jax.jit(jc.__call__)(jp, jnp.asarray(fmap), jnp.asarray(direnc))
    got = with_jax_params(tgen.ConvGSGenerator(in_dim=16), jp)(_t(fmap), _t(direnc))
    for k, w in want.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=k)

    x = rng.standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tgen.harmonic_embedding(_t(x))),
                               np.asarray(jgen.harmonic_embedding(jnp.asarray(x))), atol=1e-6)
    transform = np.array([[-1, 0, 0, 0.1], [0, 1, 0, 0], [0, 0, -1, 5000.0 / 512]], np.float32)
    for key, w in jgen.build_points_planes(8, transform).items():
        np.testing.assert_array_equal(tgen.build_points_planes(8, transform)[key], w)
    rot = (rng.standard_normal((5, 3)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(_np(tgen.transform_emoca_to_p3d(_t(rot))),
                               np.asarray(jgen.transform_emoca_to_p3d(jnp.asarray(rot))),
                               atol=1e-6)


# --------------------------------------------------------------------- DINO


def test_dino_dpt_matches_jax(rng):
    """DinoDPT at 64 wide, 4 blocks, on the JAX init, dense map and global token to
    atol = rtol 1e-4 (float32 sums of a few thousand terms in other orders)."""
    jm = jdino.DinoDPT(output_dim=256, dino_cfg=J_DINO)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    images = rng.random((1, 3, 56, 56)).astype(np.float32)
    want_dense, want_global = jax.jit(jm.__call__)(jp, jnp.asarray(images))
    port = with_jax_params(tdino.DinoDPT(output_dim=256, dino_cfg=T_DINO), jp)
    dense, glob = port(_t(images))
    assert dense.shape == want_dense.shape == (1, 256, 32, 32)
    np.testing.assert_allclose(_np(dense), np.asarray(want_dense), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(glob), np.asarray(want_global), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- StyleUNet


@pytest.fixture(scope="module")
def unet64():
    ju = junet.StyleUNet(in_size=64, out_size=64, in_dim=8, out_dim=3)
    jp = jax.jit(ju.init)(jax.random.PRNGKey(0))
    x = np.random.default_rng(5).standard_normal((1, 8, 64, 64)).astype(np.float32)
    return ju, jp, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_style_unet_matches_jax(unet64, dtype):
    """StyleUNet at 64 px on the JAX init. float32 to 1e-5 (post-sigmoid);
    bf16 (parameters and activations rounded at the same points, products
    summed in float32 on both sides) to 1e-2, within the 2e-2 that JAX holds
    its bf16 path to against float32."""
    ju, jp, x = unet64
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    want = np.asarray(jax.jit(functools.partial(ju, compute_dtype=jdt))(jp, jnp.asarray(x)))
    port = with_jax_params(tunet.StyleUNet(in_size=64, out_size=64, in_dim=8, out_dim=3), jp)
    got = port(_t(x), compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (1, 3, 64, 64)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), want, atol=tol)


# ---------------------------------------------------------------- watermark


def test_watermark_matches_jax(rng, tmp_path):
    mark = rng.random((4, 4, 8)).astype(np.float32)
    image = rng.random((2, 3, 16, 16)).astype(np.float32)
    want = jwm.apply_watermark(jnp.asarray(image), jnp.asarray(mark))
    got = twm.apply_watermark(_t(image), _t(mark))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    assert twm.apply_watermark(_t(image), None) is not None
    assert twm.load_watermark(str(tmp_path)) is None
    np.savez(tmp_path / "gagavatar_logo.npz", rgba=rng.random((4, 41, 128)).astype(np.float32))
    got = twm.load_watermark(str(tmp_path))
    assert got.shape == (4,) + twm.WATERMARK_SIZE
    np.testing.assert_allclose(_np(got), np.asarray(jwm.load_watermark(str(tmp_path))),
                               atol=5e-6)


# -------------------------------------------------------- prep_frame_chunk


def test_prep_frame_chunk_matches_jax(rng):
    """Batched FLAME + forehead EMA + camera, two chunks of 8 (the second
    with 5 padding frames that must not move the carry), to 1e-5."""
    data = synthetic_flame(num_verts=5023, num_faces=600, seed=3)
    jflame = JFlame(data, n_shape=300, n_exp=100, scale=5.0)
    tflame = TFlame(data, n_shape=300, n_exp=100, scale=5.0)
    shapecode = (rng.standard_normal((1, 300)) * 0.1).astype(np.float32)
    base = rng.standard_normal((3, 4)).astype(np.float32)
    motions = (rng.standard_normal((16, 106)) * 0.1).astype(np.float32)
    jcarry = jnp.zeros((len(javatar.FOREHEAD_INDICES), 3), jnp.float32)
    tcarry = torch.zeros((len(tavatar.FOREHEAD_INDICES), 3))
    jprep = jax.jit(functools.partial(javatar.prep_frame_chunk, jflame))
    for i, valid in ((0, 8), (8, 3)):
        jp, jc, jcarry = jprep(jnp.asarray(shapecode), jnp.asarray(base),
                               jnp.asarray(motions[i:i + 8]), jcarry, jnp.float32(i == 0),
                               jnp.int32(valid))
        tp, tc, tcarry = tavatar.prep_frame_chunk(
            tflame, _t(shapecode), _t(base), _t(motions[i:i + 8]), tcarry, i == 0, valid)
        np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=1e-5)
        np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(_np(tcarry), np.asarray(jcarry), atol=1e-5)


# -------------------------------------------------------- the whole slice


def _shrink(monkeypatch, mod, dino_mod, gen_mod, unet_mod, resize, cfg):
    """One package's GAGAvatar at the test size (see the module docstring)."""
    monkeypatch.setitem(mod.CAM_PARAMS, "size", 128)
    monkeypatch.setattr(mod, "PLANE_SIZE", 32)
    monkeypatch.setattr(mod, "resize_antialias", lambda x, h, w: resize(x, 56, 56))
    monkeypatch.setattr(mod, "DinoDPT",
                        lambda output_dim: dino_mod.DinoDPT(output_dim, dino_cfg=cfg))
    monkeypatch.setattr(mod, "LinearGSGenerator",
                        lambda in_dim, dir_dim: gen_mod.LinearGSGenerator(256 + 64, dir_dim))
    monkeypatch.setattr(mod, "StyleUNet", lambda in_size, out_size, in_dim, out_dim:
                        unet_mod.StyleUNet(128, 128, in_dim, out_dim))


@pytest.fixture
def small_gaga(monkeypatch):
    monkeypatch.setenv("ARTALK_GAGA_PRECISION", "exact")
    monkeypatch.setenv("ARTALK_GSPLAT_MAX_INSTANCES", "0")   # JAX's exact splat path
    monkeypatch.delenv("ARTALK_BF16_SR", raising=False)
    _shrink(monkeypatch, javatar, jdino, jgen, junet, jresize.resize_antialias, J_DINO)
    _shrink(monkeypatch, tavatar, tdino, tgen, tunet, tresize.resize_antialias, T_DINO)


def test_render_motion_sequence_matches_jax(small_gaga, rng, monkeypatch):
    """The shrunk slice in exact mode on the same weights: 3 frames from the
    avatar (chunks of 2, so the last chunk is padded), then 2 more resuming
    the forehead EMA (avatar_id None). yuv420p frames within 1 uint8 LSB;
    then build_forward_batch / forward_expression for two more frames.

    The JAX chunk step scans its frames; XLA's CPU backend runs convolutions
    inside a loop body some 50 times slower than outside one, so the scans
    are unrolled here (the same values, about 30 s less per chunk)."""
    monkeypatch.setattr(jax.lax, "scan", functools.partial(jax.lax.scan, unroll=True))
    jg = javatar.GAGAvatar(assets_dir=ASSETS, params={}, interpret=True)
    jg.params = jax.jit(jg.init)(jax.random.PRNGKey(0))
    tg = tavatar.GAGAvatar(assets_dir=ASSETS, params=_flatten(jg.params), device="cpu")
    assert not tg.bf16
    flame_data = load_or_synthesize_flame(ASSETS)
    jflame = JFlame(flame_data, n_shape=300, n_exp=100, scale=5.0)
    tflame = TFlame(flame_data, n_shape=300, n_exp=100, scale=5.0)
    motions = (rng.standard_normal((5, 106)) * 0.1).astype(np.float32)
    got, want = [], []
    for avatar_id, part in (("synthetic_0", motions[:3]), (None, motions[3:])):
        want.append(jg.render_motion_sequence(avatar_id, jnp.asarray(part), jflame,
                                              transfer_chunk=2, colorspace="yuv420"))
        got.append(tg.render_motion_sequence(avatar_id, part, tflame, transfer_chunk=2,
                                             colorspace="yuv420"))
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape == (5, 192, 128) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, (diff.max(), (diff > 0).mean())
    assert got[:, :128].std() > 1.0   # not a blank frame
    np.testing.assert_allclose(_np(tg._upper_points), np.asarray(jg._upper_points), atol=1e-5)
    # the per-frame entry points, continuing the same EMA: float32 frames in
    # [0, 1] to 1e-5 (reading 4.5e-7)
    for m in motions[:2]:
        want = jg.forward_expression(jg.build_forward_batch(jnp.asarray(m[None]), jflame))
        got = tg.forward_expression(tg.build_forward_batch(_t(m[None]), tflame))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_engine_and_cli_render_gaga(small_gaga, tmp_path, monkeypatch):
    """ARTAvatarInferEngine(load_gaga=True, device="cpu").rendering with an
    avatar id, and the CLI's --load_gaga -i synthetic_0, give one frame per
    motion; an id outside the bank renders the mesh."""
    make = functools.partial(ARTAvatarInferEngine, config=torch_config(CFG),
                             output_dir=str(tmp_path), device="cpu", assets_dir=ASSETS)
    engine = make(load_gaga=True)
    audio = (np.random.default_rng(3).standard_normal(1600) * 0.1).astype(np.float32)
    motions = engine.inference(audio)
    out = engine.rendering(audio, motions, shape_id="synthetic_0", save_name="gaga")
    if out.endswith(".y4m"):
        assert tvideo.read_y4m(out)[0].shape == (len(motions), 192, 128)
    elif out.endswith(".npz"):
        with np.load(out) as z:
            assert z["frames"].shape == (len(motions), 192, 128)
    assert os.path.getsize(out) > 0
    with pytest.raises(RuntimeError, match="load_gaga=True"):
        make(load_gaga=False, image_size=64).rendering(audio, motions, shape_id="synthetic_0")

    monkeypatch.setattr(tcli, "ARTAvatarInferEngine", make)
    wav = _write_wav(tmp_path / "clip.wav", seconds=0.1)
    out = tcli.main(["-a", wav, "--load_gaga", "-i", "synthetic_0"])
    assert os.path.basename(out).startswith("clip_default_synthetic_0")
    if out.endswith(".y4m"):
        assert tvideo.read_y4m(out)[0].shape == (3, 192, 128)
    elif out.endswith(".npz"):
        with np.load(out) as z:
            assert z["frames"].shape == (3, 192, 128)
    assert tcli.resolve_shape_id(engine, "nope.jpg", load_gaga=True) == "mesh"
