"""Z-buffer rasterizer of artalk_tpu_torch against the JAX Pallas kernel run
in interpret mode, on the four scenes of tests/test_rasterizer.py.

The plain version (the CPU path of ``rasterize``) keeps the kernel's
truncated-key semantics and evaluates each plane as ((px * ax) + (py * ay)) + c
without contraction, the order the CUDA kernel reproduces bit for bit. XLA's
CPU backend contracts the JAX kernel's interpret-mode evaluation into
fma(px, ax, py * ay) + c, so a pixel centre lying exactly on an edge (the
z-order scene's hypotenuse) can flip. Hence: face ids differ on < 1e-3 of
pixels, zbuf to rtol 1e-4 where both hit, background exactly -- except at
pixel centres that lie on a face edge (checked in float64), where the two
roundings may decide either way. The CUDA kernel itself is checked against
the plain version on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artalk_tpu.ops import rasterizer as jr

from artalk_tpu_torch.ops import rasterizer as tr

from test_rasterizer import _random_scene
from test_torch_params import torch_threads  # noqa: F401 (autouse)


def _scene(name):
    rng = np.random.default_rng(0)
    if name == "random":
        v, f = _random_scene(rng)
        return np.array(v), np.array(f), 64, 256
    if name == "padding":
        v, f = _random_scene(rng, num_faces=200)
        return np.array(v), np.array(f), 64, 128
    if name == "empty":
        return np.zeros((3, 3), np.float32), np.array([[0, 1, 2]], np.int32), 32, 128
    verts = np.array([
        [10, 10, 2.0], [100, 10, 2.0], [10, 100, 2.0],   # near
        [10, 10, 3.0], [100, 10, 3.0], [10, 100, 3.0],   # far
    ], np.float32)
    return verts, np.array([[3, 4, 5], [0, 1, 2]], np.int32), 64, 128


def _edge_ties(verts, faces, pix, tol=1e-6):
    """For pixels ``pix`` (N, 2) of (y, x): does the centre lie on an edge of
    a face (one barycentric within ``tol`` of 0 in float64, none below)?"""
    a0, a1, _ = tr.face_planes(torch.from_numpy(verts).double(), torch.from_numpy(faces))
    p = torch.from_numpy(pix[:, ::-1] + 0.5)                # (N, 2) x, y
    w0 = p[:, 0:1] * a0[:, 0] + p[:, 1:2] * a0[:, 1] + a0[:, 2]
    w1 = p[:, 0:1] * a1[:, 0] + p[:, 1:2] * a1[:, 1] + a1[:, 2]
    ws = torch.stack([w0, w1, 1.0 - w0 - w1], dim=-1)       # (N, F, 3)
    on_edge = (ws.amin(-1).abs() <= tol) & (ws >= -tol).all(-1)
    return on_edge.any(-1).numpy()


@pytest.mark.parametrize("name", ["random", "padding", "empty", "z_order"])
def test_plain_matches_jax_kernel(name):
    verts, faces, h, w = _scene(name)
    zj, fj = (np.asarray(a) for a in jr.rasterize(jnp.asarray(verts), jnp.asarray(faces),
                                                   height=h, width=w, interpret=True))
    zt, ft = tr.rasterize(torch.from_numpy(verts), torch.from_numpy(faces), height=h, width=w)
    zt, ft = zt.numpy(), ft.numpy()
    assert ft.dtype == np.int32 and zt.dtype == np.float32 and ft.shape == (h, w)
    differ = ft != fj
    tie = np.zeros_like(differ)
    tie[differ] = _edge_ties(verts, faces, np.argwhere(differ))
    np.testing.assert_array_equal((ft == -1)[~tie], (fj == -1)[~tie])
    assert (differ & ~tie).mean() < 1e-3
    if name != "z_order":  # no pixel centre on an edge: the stated tolerances hold everywhere
        assert not tie.any()
    both = (ft >= 0) & (fj >= 0)
    np.testing.assert_allclose(zt[both], zj[both], rtol=1e-4)
    np.testing.assert_array_equal(zt[ft < 0], np.float32(tr.BIG))
    if name == "random":
        assert (ft >= 0).mean() > 0.3
    if name == "padding":
        assert ft.max() < 200
    if name == "empty":
        assert (ft == -1).all()
    if name == "z_order":
        assert (ft[ft >= 0] == 1).all() and (ft >= 0).mean() > 0.3


def test_setup_matches_jax():
    verts, faces, _, _ = _scene("random")
    for t, j in zip(tr.face_planes(torch.from_numpy(verts), torch.from_numpy(faces)),
                    jr.face_planes(jnp.asarray(verts), jnp.asarray(faces))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tr.chunk_bboxes(torch.from_numpy(verts), torch.from_numpy(faces), 4).numpy(),
        np.asarray(jr.chunk_bboxes(jnp.asarray(verts), jnp.asarray(faces), 4)))
