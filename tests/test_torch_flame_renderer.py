"""FLAME LBS and the mesh renderer of artalk_tpu_torch against JAX.

FLAME vertices agree to atol 1e-5. Rendered 128x128 yuv420p frames agree
within 1 on >= 99.9 % of samples: shading is float32 in both, a byte can land
on the other side of a rounding edge, and a pixel on a shared triangle edge
may take the neighbouring face (see tests/test_torch_rasterizer.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artalk_tpu.models.flame import FlameModel as JaxFlame
from artalk_tpu.models.flame import batch_rodrigues as jax_rodrigues
from artalk_tpu.models.renderer import MeshRenderer as JaxRenderer
from artalk_tpu.utils.assets import synthetic_flame

from artalk_tpu_torch.models.flame import FlameModel, batch_rodrigues
from artalk_tpu_torch.models.renderer import MeshRenderer
from artalk_tpu_torch.utils import assets as tassets

from test_torch_params import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def flame_data():
    return synthetic_flame(num_verts=400, num_faces=512, seed=2)


def _motions(rng, t):
    m = (rng.standard_normal((t, 106)) * 0.5).astype(np.float32)
    m[:, 100:] *= 0.2
    return m


def test_synthetic_asset_is_the_jax_one():
    a, b = synthetic_flame(num_verts=300, seed=4), tassets.synthetic_flame(num_verts=300, seed=4)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_flame_verts_match_jax(rng, flame_data):
    rot = (rng.standard_normal((5, 3)) * 0.7).astype(np.float32)
    np.testing.assert_allclose(batch_rodrigues(torch.from_numpy(rot)).numpy(),
                               np.asarray(jax_rodrigues(jnp.asarray(rot))), atol=1e-6)
    motion = _motions(rng, 6)
    shape = (rng.standard_normal((6, 300)) * 0.5).astype(np.float32)
    want = JaxFlame(flame_data).motion_to_verts(jnp.asarray(shape), jnp.asarray(motion))
    got = FlameModel(flame_data).motion_to_verts(torch.from_numpy(shape),
                                                 torch.from_numpy(motion))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mesh_frames_match_jax(rng, flame_data):
    size = 128
    jren = JaxRenderer(size, flame_data["faces"], template_verts=flame_data["v_template"],
                       interpret=True)
    tren = MeshRenderer(size, flame_data["faces"], template_verts=flame_data["v_template"])
    # the Morton face order is reproduced exactly: face ids and ties depend on it
    np.testing.assert_array_equal(tren.faces.numpy(), np.asarray(jren.faces))
    verts = np.array(JaxFlame(flame_data).motion_to_verts(
        jnp.zeros((3, 300)), jnp.asarray(_motions(rng, 3))))
    np.testing.assert_allclose(tren.vertex_normals(torch.from_numpy(verts)).numpy(),
                               np.asarray(jren.vertex_normals(jnp.asarray(verts))), atol=1e-5)
    want = jren.render_frames(jnp.asarray(verts), chunk=2, colorspace="yuv420")
    got = tren.render_frames(torch.from_numpy(verts), chunk=2)
    assert got.shape == want.shape == (3, size * 3 // 2, size) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999, (diff > 1).mean()
    assert (got[:, :size] < 250).mean() > 0.05  # the head covers part of the white frame
