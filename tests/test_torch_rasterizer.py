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
    tie[differ] = tr.edge_ties(torch.from_numpy(verts), torch.from_numpy(faces),
                               np.argwhere(differ)).numpy()
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


# ---------------------------------------------------------------------------
# The kernel's setup and per-face culling rule (csrc/rasterizer.cu), in plain
# torch: the culled face lists of every 32x8 tile must give what every face of
# every chunk overlapping the tile gives, bit for bit.
# ---------------------------------------------------------------------------

from raster_scenes import adversarial_scene, culled_raster, flame_head, vertex_boxes  # noqa: E402

CULL_SCENES = {"flame": flame_head, "adversarial": adversarial_scene}


@pytest.fixture(scope="module", params=sorted(CULL_SCENES))
def cull_scene(request):
    verts, faces, h, w = CULL_SCENES[request.param]()
    planes, boxes, chunks = tr.kernel_inputs_plain(verts, faces, height=h, width=w)
    want = tr.rasterize_plain(verts, faces, height=h, width=w)
    return request.param, verts, faces, h, w, planes, boxes, chunks, want


def test_face_culling_keeps_the_output(cull_scene):
    name, verts, faces, h, w, planes, boxes, chunks, want = cull_scene
    keep = tr.face_culling(boxes, chunks, height=h, width=w)
    got = culled_raster(planes, keep, h, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    chunk_pairs = int(tr.tile_hits(chunks, height=h, width=w).sum()) * tr.FACE_CHUNK
    assert int(keep.sum()) * 8 < chunk_pairs, "the cull should drop most (tile, face) pairs"
    assert (want[1] >= 0).float().mean() > (0.25 if name == "flame" else 0.99)


@pytest.mark.parametrize("fault", ["vertex boxes", "one pixel narrower"])
def test_culling_faults_change_the_adversarial_scene(fault):
    verts, faces, h, w = adversarial_scene()
    planes, boxes, chunks = tr.kernel_inputs_plain(verts, faces, height=h, width=w)
    if fault == "vertex boxes":    # the rule without its near-degenerate safeguard
        bad = vertex_boxes(verts, faces, planes.shape[0])
    else:
        bad = boxes + torch.tensor([1.0, -1.0, 1.0, -1.0])
    want = tr.rasterize_plain(verts, faces, height=h, width=w)
    got = culled_raster(planes, tr.face_culling(bad, chunks, height=h, width=w), h, w)
    assert not torch.equal(got[1], want[1])


def test_cull_boxes_of_special_faces():
    verts, faces, h, w = adversarial_scene()
    planes, boxes, _ = tr.kernel_inputs_plain(verts, faces, height=h, width=w)
    degenerate = (planes[:, :6] == torch.tensor([0.0, 0.0, -1.0, 0.0, 0.0, 0.0])).all(1)
    assert degenerate.sum() > planes.shape[0] - faces.shape[0]   # padding and sub-cut slivers
    assert torch.equal(boxes[degenerate], torch.tensor(
        [[float("inf"), -float("inf")] * 2]).expand(int(degenerate.sum()), 4))
    vb = vertex_boxes(verts, faces, planes.shape[0])
    off = (boxes - vb).abs().amax(1)[~degenerate]
    assert (off > 0.5).any() and off.median() < 1e-2   # slivers reach out; most hug


def test_kernel_inputs_plain_match_face_planes_and_jax():
    for verts, faces, h, w in (_scene("random")[:2] + _scene("random")[2:],
                               _scene("padding")):
        verts, faces = torch.from_numpy(verts), torch.from_numpy(faces)
        planes, boxes, chunks = tr.kernel_inputs_plain(verts, faces, height=h, width=w)
        num_chunks = chunks.shape[0]
        padded = torch.cat([faces.long(), faces.new_zeros(
            (num_chunks * tr.FACE_CHUNK - len(faces), 3)).long()])
        assert torch.equal(planes, torch.cat(tr.face_planes(verts, padded), dim=1))
        assert torch.equal(chunks, tr.chunk_bboxes(verts, padded, num_chunks))
        assert boxes.shape == (num_chunks * tr.FACE_CHUNK, 4) and boxes.dtype == torch.float32
        for t, j in zip(planes[:len(faces)].split(3, dim=1),
                        jr.face_planes(jnp.asarray(verts.numpy()), jnp.asarray(faces.numpy()))):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            chunks.numpy(), np.asarray(jr.chunk_bboxes(jnp.asarray(verts.numpy()),
                                                       jnp.asarray(padded.int().numpy()),
                                                       num_chunks)))
