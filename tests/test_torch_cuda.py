"""The CUDA rasterizer kernel against its plain version, on the card.

Marked ``cuda``: skipped without an NVIDIA GPU. This file imports neither jax
nor artalk_tpu, so it also runs on a GPU machine without them; there, skip
tests/conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The kernel evaluates the planes in the plain version's order without FMA
contraction, so face ids and depths must be bit-identical.
"""

import numpy as np
import pytest
import torch

from artalk_tpu_torch.ops import rasterizer as tr


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
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain(cuda):
    for verts, faces, h, w in _scenes():
        vs, fs = torch.from_numpy(verts).to(cuda), torch.from_numpy(faces).to(cuda)
        before = tr.LAUNCHES
        zk, fk = tr.rasterize(vs, fs, height=h, width=w)
        assert tr.LAUNCHES == before + 1
        zp, fp = tr.rasterize_plain(vs, fs, height=h, width=w)
        torch.cuda.synchronize()
        assert torch.equal(fk, fp) and torch.equal(zk, zp), (h, w, len(faces))


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    verts = torch.zeros((3, 3), dtype=torch.float64, device=cuda)
    faces = torch.zeros((1, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        tr.rasterize(verts, faces, height=8, width=32)
    with pytest.raises(ValueError, match="faces"):
        tr.rasterize(verts.float(), faces.cpu(), height=8, width=32)
