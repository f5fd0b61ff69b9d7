"""Gaussian-parameter generators + camera/plane geometry for GAGAvatar.

Counterpart of ``artalk_tpu/models/gagavatar/generators.py``
(LinearGSGenerator / ConvGSGenerator / build_points_planes /
transform_emoca_to_p3d; reference: app/GAGAvatar/models.py:141-264), with
both of the reference's quirks kept for checkpoint parity.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from .. import nn as tnn
from ..flame import batch_rodrigues


def harmonic_embedding(x: torch.Tensor, n_harmonic: int = 4) -> torch.Tensor:
    """PyTorch3D HarmonicEmbedding(n, append_input=True): sin/cos of
    2^k-scaled inputs, input appended. (..., 3) -> (..., n*2*3 + 3)."""
    freqs = 2.0 ** torch.arange(n_harmonic, dtype=torch.float32, device=x.device)
    # pytorch3d layout: coordinate-major ((..., 3, n) flattened)
    flat = (x[..., :, None] * freqs).reshape(x.shape[:-1] + (x.shape[-1] * n_harmonic,))
    return torch.cat([torch.sin(flat), torch.cos(flat), x], dim=-1)


def _mlp(dims: List[int]) -> nn.ModuleList:
    return nn.ModuleList(tnn.Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1))


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, lin in enumerate(layers):
        x = lin(x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class LinearGSGenerator(nn.Module):
    """Per-FLAME-vertex gaussian head (models.py:141-193)."""

    def __init__(self, in_dim: int = 1024, dir_dim: int = 27):
        super().__init__()
        quarter = in_dim // 4
        mid = quarter + dir_dim
        self.features = _mlp([in_dim, quarter, quarter, quarter, quarter])
        self.color = _mlp([mid, 128, 32])
        self.opacity = _mlp([mid, 128, 1])
        self.scale = _mlp([mid, 128, 3])
        self.rotation = _mlp([mid, 128, 4])

    def init(self, gen: torch.Generator) -> "LinearGSGenerator":
        for lin in self.modules():
            if isinstance(lin, tnn.Linear):
                tnn.linear_init(lin, gen)
        return self

    def forward(self, features: torch.Tensor,
                plane_direnc: torch.Tensor) -> Dict[str, torch.Tensor]:
        feat = _mlp_apply(self.features, features)
        direnc = plane_direnc[:, None].expand(feat.shape[0], feat.shape[1],
                                              plane_direnc.shape[-1])
        feat = torch.cat([feat, direnc], dim=-1)
        colors = _mlp_apply(self.color, feat)
        colors = torch.cat([torch.sigmoid(colors[..., :3]), colors[..., 3:]], dim=-1)
        opacities = torch.sigmoid(_mlp_apply(self.opacity, feat))
        scales = torch.sigmoid(_mlp_apply(self.scale, feat)) * 0.05
        # Reference quirk (models.py:191-192): F.normalize with its default
        # dim=1 on a (B, N, 4) tensor normalizes over the N vertex axis.
        rotations = tnn.l2_normalize(_mlp_apply(self.rotation, feat), dim=1)
        return {"colors": colors, "opacities": opacities, "scales": scales,
                "rotations": rotations}


class ConvGSGenerator(nn.Module):
    """Dense-plane gaussian head over the DPT map (models.py:196-233)."""

    OUT = 32 + 1 + 3 + 4 + 1

    def __init__(self, in_dim: int = 256, dir_dim: int = 27):
        super().__init__()
        cin = in_dim + dir_dim
        half = in_dim // 2
        self.conv1 = tnn.Conv2d(cin, half, 3)
        self.conv2 = tnn.Conv2d(half, half, 3)
        self.conv3 = tnn.Conv2d(half, half, 3)
        self.conv4 = tnn.Conv2d(half, self.OUT, 1)

    def init(self, gen: torch.Generator) -> "ConvGSGenerator":
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            conv.init(gen)
        return self

    def forward(self, features: torch.Tensor,
                plane_direnc: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, _, h, w = features.shape
        direnc = plane_direnc[:, :, None, None].expand(b, plane_direnc.shape[-1], h, w)
        x = torch.cat([features, direnc], dim=1)
        x = torch.relu(self.conv1(x, padding=1))
        x = torch.relu(self.conv2(x, padding=1))
        x = torch.relu(self.conv3(x, padding=1))
        g = self.conv4(x)                                    # (B, 41, H, W)

        colors = g[:, :32]
        # Reference quirk (models.py:215-216): ``colors[..., :3] = sigmoid(..)``
        # on this NCHW map squashes the first 3 *width columns* (all 32
        # channels), not the first 3 channels.
        colors = torch.cat([torch.sigmoid(colors[..., :3]), colors[..., 3:]], dim=-1)

        def to_points(t):
            return t.permute(0, 2, 3, 1).reshape(b, h * w, t.shape[1])

        return {
            "colors": to_points(colors),
            "opacities": to_points(torch.sigmoid(g[:, 32:33])),
            "scales": to_points(torch.sigmoid(g[:, 33:36]) * 0.05),
            "rotations": tnn.l2_normalize(to_points(g[:, 36:40])),
            "positions": to_points(torch.sigmoid(g[:, 40:41])),
        }


def build_points_planes(plane_size: int, transform: np.ndarray) -> Dict[str, np.ndarray]:
    """Camera-ray plane through the scene (models.py:236-252).

    transform: (3, 4) or (4, 4) world->view matrix of the tracked source
    image. Returns plane_points (plane_size^2, 3) and plane_dirs (3,).
    """
    t = np.asarray(transform, np.float64)
    x, y = np.meshgrid(
        np.linspace(1, -1, plane_size), np.linspace(1, -1, plane_size), indexing="xy")
    r = t[:3, :3]
    tr = t[:3, 3:]
    cam_dir = (r @ np.array([0.0, 0.0, 1.0]))
    ray = np.stack([x / 12.0, y / 12.0, np.ones_like(x)], axis=-1).reshape(-1, 3)
    ray_dirs = ray @ r.T
    origin = -(r @ tr)[:, 0]
    distance = abs(np.dot(origin, cam_dir))
    plane_points = origin[None] + distance * ray_dirs
    return {
        "plane_points": plane_points.astype(np.float32),
        "plane_dirs": cam_dir.astype(np.float32),
    }


def transform_emoca_to_p3d(global_rotation: torch.Tensor) -> torch.Tensor:
    """EMOCA head rotation (axis-angle, (B, 3)) -> (B, 3, 4) camera matrix
    (models.py:255-264): the head rotation is folded into the camera so the
    gaussians never move for global rotation."""
    rot = global_rotation * global_rotation.new_tensor([-1.0, 1.0, -1.0])
    flip = global_rotation.new_tensor([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]])
    inv = torch.linalg.inv(batch_rodrigues(rot) @ flip)
    t = global_rotation.new_tensor([0.0, 0.0, 5000.0 / 512])
    return torch.cat([inv, t[None, :, None].expand(rot.shape[0], 3, 1)], dim=-1)
