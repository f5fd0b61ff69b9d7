"""The port's gaussian splat (artalk_tpu_torch/ops/gsplat.py) against the JAX
one, on the CPU: the projection to rtol 1e-6, the instance lists exactly,
and the plain compositing against the Pallas kernel in interpret mode to atol
1e-4 (the tolerance tests/test_gsplat.py holds the Pallas kernel to) on the
scenes of tests/test_gsplat.py. The two stop differently (JAX a whole tile
after a 512-gaussian chunk, the port each pixel), which moves a pixel by at
most T_EPS = 1e-4 times its largest color, colors here being in [0, 1]."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artalk_tpu.ops import gsplat as jgs

from artalk_tpu_torch.ops import gsplat as tgs

from test_gsplat import CAM, _scene
from test_torch_params import torch_threads  # noqa: F401 (autouse)

SIZE = 128


def _torch(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _single(xyz, colors, opac, scale, q=(1.0, 0, 0, 0)):
    """Scenes of identity-rotation gaussians, as tests/test_gsplat.py builds them."""
    n = len(xyz)
    return [jnp.asarray(np.asarray(a, np.float32)) for a in (
        xyz, colors, opac, np.full((n, 3), scale), np.tile(np.array([q]), (n, 1)), CAM)]


def _scenes():
    rng = np.random.default_rng(0)
    yield "random", _scene(rng), False
    yield "bf16_colors", _scene(np.random.default_rng(0)), True
    yield "empty", _single([[0.0, 0.0, 100.0]], np.ones((1, 32)), [[1.0]], 0.01), False
    yield "front_to_back", _single([[0, 0, 0.5], [0, 0, -0.5]],
                                   np.stack([np.ones(32), np.zeros(32)]),
                                   [[0.999], [0.999]], 0.02), False
    yield "oversized", _single(np.zeros((1, 3)), np.ones((1, 32)), [[0.9]], 0.7), False


SCENES = {name: (args, bf16) for name, args, bf16 in _scenes()}


def test_projection_matches_jax():
    """rtol 1e-6; where a component's sum cancels (the conic's cb, a few
    values near 0) the rounding of XLA's contracted products shows, so the
    error is also allowed 1e-6 of the component's largest magnitude."""
    xyz, _, _, scales, q, cam = SCENES["random"][0]
    for size in (SIZE, 512):
        want = jgs._project_components(xyz, scales, q, cam, 12.0, size)
        got = tgs._project_components(*_torch((xyz, scales, q, cam)), 12.0, size)
        for key, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(), err_msg=key)
        np.testing.assert_array_equal(got["radius"].numpy(), np.asarray(want["radius"]))


@pytest.mark.parametrize("size", [SIZE, 512])
def test_prepass_matches_jax(size):
    """Offsets and each tile's ordered gaussians equal JAX's _build_instances
    (max_instances=None, slot_cap=DUP) exactly, from the same projection. JAX
    carries each instance's colors along, so a color column holding the
    gaussian's index names its source."""
    xyz, _, opac, scales, q, cam = SCENES["random"][0]
    n = xyz.shape[0]
    comp = jgs._project_components(xyz, scales, q, cam, 12.0, size)
    op = jnp.where(comp["in_front"], opac[..., 0], 0.0)
    ids = jnp.tile(jnp.arange(n, dtype=jnp.float32)[:, None], (1, 32))
    _, cols, offsets = jgs._build_instances(comp, op, ids, size, None, slot_cap=jgs.DUP)
    # undo the kernel's in-chunk interleave: stored lane m*GGROUPS + i holds
    # sorted position i*GMEMBERS + m
    src = np.asarray(cols[0]).reshape(-1, jgs.GMEMBERS, jgs.GGROUPS).swapaxes(1, 2).reshape(-1)
    offsets = np.asarray(offsets)

    tcomp = {k: torch.from_numpy(np.array(v)) for k, v in comp.items()}
    inst, toffsets = tgs._build_instances(tcomp, torch.from_numpy(np.array(op)), size)
    np.testing.assert_array_equal(toffsets.numpy(), offsets)
    assert inst.shape[0] == offsets[-1] > 0
    np.testing.assert_array_equal(inst.numpy(), src[:offsets[-1]].astype(np.int32))


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_matches_pallas_interpret(name):
    args, bf16 = SCENES[name]
    want = np.asarray(jgs.rasterize_gaussians(*args, focal=12.0, size=SIZE, interpret=True,
                                              bf16_colors=bf16))
    got = tgs.rasterize_gaussians(*_torch(args), focal=12.0, size=SIZE, bf16_colors=bf16)
    assert got.shape == (32, SIZE, SIZE) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if name in ("random", "bf16_colors"):
        assert (want[0] > 0.01).mean() > 0.02  # the scene hits pixels
    if name == "empty":
        assert not got.any()
    if name == "oversized":   # the MAX_RY clamp crops the far rows, as in JAX
        assert not got[:, 0, 64].any() and got[0, 64, 64] > 0.5


def test_key_overflow_raises():
    """The int32 key tile << rank_bits | rank must fit: at 8192 px (32,768
    tiles) 2^15 gaussians fit and one more does not, where the JAX prepass's
    own check fails too."""
    size, n = 8192, 1 << 15
    with pytest.raises(AssertionError, match="key overflow"):
        jgs._build_instances({"depth": jnp.zeros(n + 1)}, None, None, size)
    with pytest.raises(ValueError, match="overflow"):
        tgs._build_instances({"depth": torch.zeros(n + 1)}, None, size)
    zeros = torch.zeros(n)
    comp = {"depth": zeros, "mx": zeros, "my": zeros, "radius": zeros}
    inst, offsets = tgs._build_instances(comp, zeros, size)   # nothing valid, no overflow
    assert inst.numel() == 0 and offsets.shape == ((size // 128) * (size // 16) + 1,)


def test_plain_counts_pairs():
    """composite_plain counts the (pixel, instance) pairs it evaluates and
    composites (chip_smoke.py's operations bound): every pixel of a listed
    tile is evaluated until it stops."""
    args = _torch(SCENES["random"][0])
    geo, colors, inst, offsets = tgs.prepass(*args, size=SIZE)
    image, evaluated, composited = tgs.composite_plain(geo, colors, inst, offsets, SIZE)
    counts = torch.diff(offsets.long())
    assert 0 < composited <= evaluated <= int(counts.sum()) * tgs.GTILE_H * tgs.GTILE_W
    assert torch.equal(image, tgs.rasterize_gaussians_plain(*args, size=SIZE))


def _splats_8px():
    """A seeded scene of about 8 px splats (radius 3 sigma), as the
    random-init avatar has them, many to a tile."""
    rng = np.random.default_rng(7)
    n = 3000
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return [jnp.asarray(np.asarray(a, np.float32)) for a in (
        rng.normal(0, 0.1, (n, 3)), rng.random((n, 32)), rng.random((n, 1)),
        rng.random((n, 3)) * 0.002 + 0.0015, q, CAM)]


CULL_SCENES = {**{name: args for name, (args, _) in SCENES.items()}, "splats_8px": _splats_8px()}


def _culled(name, shrink=0.0, bf16=False):
    """(full lists, each block's culled list, keep), each list's result
    composite_plain's (image, evaluated, composited)."""
    geo, colors, inst, offsets = tgs.prepass(*_torch(CULL_SCENES[name]), size=SIZE,
                                             bf16_colors=bf16)
    keep = tgs.block_culling(geo, inst, offsets, SIZE, shrink=shrink)
    return (tgs.composite_plain(geo, colors, inst, offsets, SIZE),
            tgs.composite_plain(geo, colors, inst, offsets, SIZE, keep=keep), keep)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CULL_SCENES))
def test_culled_blocks_equal_full_lists(name, bf16):
    """Each 16x16 block composited from its culled list equals the whole
    lists bit for bit: the rule culls only instances that add nothing to any
    pixel of the block, so the composites are the same and fewer pairs are
    evaluated. On the dense scenes it culls most instances."""
    full, culled, keep = _culled(name, bf16=bf16)
    assert torch.equal(full[0], culled[0])
    assert culled[2] == full[2] and culled[1] <= full[1]
    if name in ("random", "splats_8px"):
        assert keep.float().mean() < 0.3 and culled[1] < full[1] / 2


def test_shrunk_culling_changes_an_image():
    """The same rule with its box one pixel narrower culls instances that
    do add to a pixel, so the comparison above can fail."""
    worst = {name: (culled[0] - full[0]).abs().max().item()
             for name in ("random", "splats_8px")
             for full, culled, _ in [_culled(name, shrink=1.0)]}
    assert max(worst.values()) > 1e-3, worst


def test_culling_keeps_degenerate_and_drops_faint():
    """Conics that are not finite or not positive definite are kept
    wherever they lie; instances with opacity below 1/255 are culled even
    at the block's centre; a sound conic is kept near the block and culled
    far from it."""
    rows = [  # mx, my, ca, cb, cc, opacity
        (300.0, 300.0, 1.0, 2.0, 1.0, 0.9),       # det < 0
        (300.0, 300.0, -1.0, 0.0, -1.0, 0.9),     # negative definite
        (300.0, 300.0, float("nan"), 0.0, 1.0, 0.9),
        (300.0, 300.0, 1.0, 0.0, float("inf"), 0.9),
        (8.0, 8.0, 1.0, 0.0, 1.0, 1.0 / 256.0),   # faint, at the centre
        (8.0, 8.0, 1.0, 0.0, 1.0, 0.9),           # sound, at the centre
        (300.0, 8.0, 1.0, 0.0, 1.0, 0.9),         # sound, far off in x
    ]
    geo = torch.tensor([[*r, 0.0, 0.0] for r in rows], dtype=torch.float32)
    num_tiles = (SIZE // tgs.GTILE_W) * (SIZE // tgs.GTILE_H)
    offsets = torch.full((num_tiles + 1,), len(rows), dtype=torch.int32)
    offsets[0] = 0
    keep = tgs.block_culling(geo, torch.arange(len(rows), dtype=torch.int32), offsets, SIZE)
    assert keep[:4].all()
    assert not keep[4].any()
    assert keep[5, 0] and not keep[5, 1:].any()
    assert not keep[6].any()
