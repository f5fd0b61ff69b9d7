"""The port's debug renderers (artalk_tpu_torch/models/renderer_extras.py)
against the JAX ones on the CPU.

The camera, the SH lights and the bilinear sampler agree to float32 rounding.
``TextureRenderer`` goes through the z-buffer, whose plain version evaluates
the planes uncontracted where XLA's CPU backend contracts the JAX kernel's
interpret-mode evaluation into an FMA (tests/test_torch_rasterizer.py): a
pixel centre lying exactly on a face edge may be covered by one and not the
other. So masks may differ only at such edge ties (``ops/rasterizer.edge_ties``,
as in tests/test_torch_rasterizer.py), and the images agree to 1e-4 on every
other pixel: texture values lie in [0, 1], but the head's random 64-texel
texture changes by up to 63 per unit of UV and its SH lights scale that again,
so the float32 rounding of the perspective-corrected UVs (contracted in one,
not in the other) moves a value by up to about 3e-5.
``PointRenderer.render_points`` is fed the subsample and colors that JAX's
``PointRenderer`` draws from its key, and agrees with the Pallas splat kernel
in interpret mode to 1e-4 x 255 (the splat's tolerance in
tests/test_torch_gsplat.py, on the x 255 scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artalk_tpu.models import renderer_extras as jre
from artalk_tpu.models.flame import FlameModel as JaxFlame
from artalk_tpu.utils.assets import synthetic_flame

from artalk_tpu_torch.models import renderer_extras as tre
from artalk_tpu_torch.ops.rasterizer import edge_ties

from test_torch_params import torch_threads  # noqa: F401 (autouse)

CAM = np.concatenate([np.diag([-1.0, 1.0, -1.0]),
                      np.array([[0.0], [0.0], [2.0]])], axis=1).astype(np.float32)
SIZE = 128


def test_look_at_camera_matches_jax():
    for d, e, a in ((3.0, 15.0, 30.0), (8.0, 30.0, 30.0), (4.0, -20.0, 135.0)):
        np.testing.assert_array_equal(tre.look_at_camera(d, e, a), jre.look_at_camera(d, e, a))


def test_add_sh_light_matches_jax(rng):
    images = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    sh = rng.standard_normal((2, 9, 3)).astype(np.float32)
    want = np.asarray(jre.add_sh_light(jnp.asarray(images), jnp.asarray(sh)))
    got = tre.add_sh_light(torch.from_numpy(images), torch.from_numpy(sh))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_bilinear_sample_matches_jax(rng):
    tex = rng.random((7, 9, 3)).astype(np.float32)
    uv = np.concatenate([rng.random((50, 2)), rng.uniform(-0.2, 1.2, (10, 2)),
                         [[0, 0], [1, 1], [0, 1], [1, 0]]]).astype(np.float32)
    want = np.asarray(jre._bilinear_sample(jnp.asarray(tex), jnp.asarray(uv)))
    got = tre._bilinear_sample(torch.from_numpy(tex), torch.from_numpy(uv))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _quad():
    """tests/test_renderer_extras.py's quad: two triangles over [-0.4, 0.4]^2."""
    verts = np.array([[-0.4, -0.4, 0.0], [0.4, -0.4, 0.0],
                      [0.4, 0.4, 0.0], [-0.4, 0.4, 0.0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uvs = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], np.float32)
    return verts[None], {"verts_uvs": uvs, "textures_idx": faces, "verts_idx": faces}


def _head(rng):
    """The synthetic FLAME head in two poses, UVs by a planar projection of
    the template, the front of the face as the flame mask."""
    data = synthetic_flame(num_verts=5023, seed=0)
    motion = (rng.standard_normal((2, 106)) * 0.5).astype(np.float32)
    motion[:, 100:] *= 0.2
    verts = np.array(JaxFlame(data).motion_to_verts(jnp.zeros((2, 300)), jnp.asarray(motion)))
    v = data["v_template"]
    lo, hi = v[:, :2].min(0), v[:, :2].max(0)
    tuv = {"verts_uvs": ((v[:, :2] - lo) / (hi - lo)).astype(np.float32),
           "textures_idx": data["faces"], "verts_idx": data["faces"]}
    mask = np.nonzero(v[:, 2] > np.quantile(v[:, 2], 0.6))[0]
    return verts, tuv, mask


def _cases():
    rng = np.random.default_rng(0)
    verts, tuv = _quad()
    flat = np.full((3, 8, 8), 0.7, np.float32)
    sh = np.zeros((1, 9, 3), np.float32)
    sh[:, 0] = 2.0
    yield "quad flat", verts, tuv, None, flat, None, CAM, 2.0
    yield "quad mask lights", verts, tuv, [0, 1, 2], np.ones((3, 8, 8), np.float32), sh, CAM, 2.0
    yield "quad default camera", verts, tuv, None, np.full((3, 4, 4), 0.5, np.float32), None, \
        None, 2.0
    verts, tuv, mask = _head(rng)
    tex = rng.random((3, 64, 64)).astype(np.float32)
    lights = (rng.standard_normal((2, 9, 3)) * 0.3).astype(np.float32)
    yield "head", verts, tuv, mask, tex, lights, CAM, 12.0


CASES = {c[0]: c[1:] for c in _cases()}


def _ties(verts, faces, cam, focal, differ):
    """Whether each pixel where ``differ`` holds has its centre on a face edge."""
    cam = torch.from_numpy(CAM if cam is None else cam)
    vs = tre.TextureRenderer._project(torch.from_numpy(verts), cam, focal, torch.zeros(2), SIZE)
    return edge_ties(vs, torch.from_numpy(np.asarray(faces)), np.argwhere(differ)).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_texture_renderer_matches_jax(name):
    verts, tuv, mask, tex, lights, cam, focal = CASES[name]
    kwargs = dict(image_size=SIZE, focal_length=focal)
    if cam is not None:
        kwargs["transform_matrix"] = cam
    want = jre.TextureRenderer(tuv, flame_mask=mask, interpret=True)(
        jnp.asarray(verts), jnp.asarray(tex), None if lights is None else jnp.asarray(lights),
        **kwargs)
    want = [None if w is None else np.asarray(w) for w in want]
    renderer = tre.TextureRenderer(tuv, flame_mask=mask, device="cpu")
    got = renderer(verts, tex, lights, **kwargs)
    assert got[0].shape == (len(verts), 3, SIZE, SIZE) and got[1].dtype == torch.bool
    assert (got[2] is None) == (mask is None)
    faces = tuv["verts_idx"]
    sub = None if mask is None else np.where(renderer.flame_mask.numpy()[:, None], faces,
                                             faces[:, :1])
    ties = 0
    for b in range(len(verts)):
        differ = got[1][b, 0].numpy() != want[1][b, 0]
        assert _ties(verts[b], faces, cam, focal, differ).all(), name
        ties += differ.sum()
        if mask is not None:
            face_differ = got[2][b, 0].numpy() != want[2][b, 0]
            assert _ties(verts[b], sub, cam, focal, face_differ).all(), name
            assert not (got[2][b] & ~got[1][b]).any()      # the face inside masks_all
            assert got[2][b].any()
        keep = ~differ
        np.testing.assert_allclose(got[0][b][:, keep].numpy(), want[0][b][:, keep], atol=1e-4)
        assert got[1][b].float().mean() > 0.1
    assert ties <= 1e-3 * got[1].numel()


def _points(rng):
    return rng.normal(0, 0.2, (2, 500, 3)).astype(np.float32)


def _jax_draws(points, key, coords, ex_points):
    """The subsample and colors jax's PointRenderer draws from ``key``."""
    k_perm, k_col = jax.random.split(key)
    n = points.shape[1]
    sel = np.array(jax.random.permutation(k_perm, n)[:min(n, jre.PointRenderer.MAX_POINTS)])
    num = len(sel) + (0 if ex_points is None else ex_points.shape[-2])
    num += 3 * (num // 10) if coords else 0
    return sel, np.array(jax.random.uniform(k_col, (num, 3)))


@pytest.mark.parametrize("coords,extra", [(True, False), (False, True)])
def test_point_renderer_matches_jax(rng, coords, extra):
    pts = _points(rng)
    ex = pts[0, :10] if extra else None
    key = jax.random.PRNGKey(3)
    want = np.asarray(jre.PointRenderer(image_size=SIZE, interpret=True)(
        jnp.asarray(pts), coords=coords, ex_points=None if ex is None else jnp.asarray(ex),
        key=key))
    sel, colors = _jax_draws(pts, key, coords, ex)
    renderer = tre.PointRenderer(image_size=SIZE, device="cpu")
    selected = renderer.select_points(pts, torch.from_numpy(sel), ex, coords)
    assert selected.shape[1] == len(colors)
    got = renderer.render_points(selected, torch.from_numpy(colors))
    assert got.shape == want.shape == (2, 3, SIZE, SIZE)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * 255)
    assert torch.isfinite(got).all() and got.max() <= 255.0 + 1e-3
    assert (got.amax(dim=1) > 1.0).float().mean() > 0.005      # points hit pixels


def test_point_renderer_call_draws_from_a_generator(rng):
    pts = _points(rng)
    renderer = tre.PointRenderer(image_size=SIZE, device="cpu")
    one = renderer(pts, generator=torch.Generator().manual_seed(1))
    assert one.shape == (2, 3, SIZE, SIZE)
    assert torch.equal(one, renderer(pts, generator=torch.Generator().manual_seed(1)))
    assert (one.amax(dim=1) > 1.0).float().mean() > 0.005
    two = renderer(pts[:1], coords=False, ex_points=pts[0, :10])
    assert two.shape == (1, 3, SIZE, SIZE)
    with pytest.raises(ValueError, match="128"):
        tre.PointRenderer(image_size=100, device="cpu")
