"""Mesh preview renderer: camera, vertex normals, Phong shading, batched frames.

Counterpart of ``artalk_tpu/models/renderer.py``, with the reference's fixed
setup: perspective camera (R = diag(-1, 1, -1), T = (0, 0, 2*scale), focal 12
NDC units), uniform vertex color (142, 179, 247)/255, point light at
(0, 1, 3), hard Phong shading, white background.

Visibility comes from the z-buffer rasterizer (``ops/rasterizer.py``, a CUDA
kernel on the card); normals and shading are plain torch, as they are XLA in
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.colorspace import rgb_to_yuv420p
from ..ops.rasterizer import face_planes, rasterize
from .nn import l2_normalize

AMBIENT = 0.5
DIFFUSE = 0.3
SPECULAR = 0.2
MAT_SPECULAR = 0.6
SHININESS = 10.0
LIGHT_LOC = (0.0, 1.0, 3.0)
VERT_COLOR = (142 / 255.0, 179 / 255.0, 247 / 255.0)
FOCAL = 12.0


def _morton2(v: np.ndarray) -> np.ndarray:
    """Interleave the low 10 bits of ``v`` with zeros (Morton/Z-order)."""
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    v = (v | (v << 1)) & 0x5555555555555555
    return v


class MeshRenderer:
    """Batched mesh renderer with the reference's fixed-camera setup."""

    def __init__(self, image_size: int = 512, faces: np.ndarray | None = None,
                 scale: float = 1.0, template_verts: np.ndarray | None = None,
                 device: torch.device | str = "cpu"):
        assert faces is not None, "faces required"
        self.image_size = int(image_size)
        self.scale = scale
        self.device = torch.device(device)
        faces = np.asarray(faces, np.int32)
        if template_verts is not None:
            # Morton order of the template face centroids (x, y), exactly as
            # the JAX renderer: face ids and tie-breaks depend on it, and it
            # keeps each 128-face chunk compact so the rasterizer's chunk
            # culling skips most of them.
            cxy = np.asarray(template_verts)[faces].mean(axis=1)
            gx = ((cxy[:, 0] - cxy[:, 0].min())
                  / (np.ptp(cxy[:, 0]) + 1e-9) * 1023).astype(np.int64)
            gy = ((cxy[:, 1] - cxy[:, 1].min())
                  / (np.ptp(cxy[:, 1]) + 1e-9) * 1023).astype(np.int64)
            faces = faces[np.argsort(_morton2(gx) | (_morton2(gy) << 1))]
        self.faces = torch.from_numpy(faces.astype(np.int64)).to(self.device)
        s = self.image_size
        px = torch.arange(s, dtype=torch.float32, device=self.device) + 0.5
        self._py, self._px = torch.meshgrid(px, px, indexing="ij")  # (H, W)

    # -- geometry ------------------------------------------------------------

    def camera_transform(self, verts: torch.Tensor) -> torch.Tensor:
        """World -> screen-space verts (..., V, 3) = (x_pix, y_pix, z_cam)."""
        s = self.image_size
        x = -verts[..., 0]
        y = verts[..., 1]
        z = -verts[..., 2] + 2.0 * self.scale
        px = (s / 2.0) * (1.0 - FOCAL * x / z)
        py = (s / 2.0) * (1.0 - FOCAL * y / z)
        return torch.stack([px, py, z], dim=-1)

    def vertex_normals(self, verts: torch.Tensor) -> torch.Tensor:
        """Area-weighted vertex normals (B, V, 3). On the card the scatter-add
        is atomic, so its sums vary in the last bits from run to run."""
        f = self.faces
        v0, v1, v2 = verts[:, f[:, 0]], verts[:, f[:, 1]], verts[:, f[:, 2]]
        fn = torch.linalg.cross(v1 - v0, v2 - v0)
        acc = torch.zeros_like(verts)
        for i in range(3):
            acc.index_add_(1, f[:, i], fn)
        return l2_normalize(acc)

    # -- shading -------------------------------------------------------------

    def _shade_points(self, pos: torch.Tensor, nrm: torch.Tensor,
                      fid: torch.Tensor) -> torch.Tensor:
        """Phong shading of interpolated surface points/normals (H, W, 3)."""
        light = pos.new_tensor(LIGHT_LOC)
        cam = pos.new_tensor([0.0, 0.0, 2.0 * self.scale])
        l_dir = l2_normalize(light - pos)
        v_dir = l2_normalize(cam - pos)
        ndl_raw = torch.sum(nrm * l_dir, dim=-1, keepdim=True)
        ndl = torch.clamp(ndl_raw, min=0.0)
        r_dir = 2.0 * ndl_raw * nrm - l_dir
        rdv = torch.clamp(torch.sum(r_dir * v_dir, dim=-1, keepdim=True), min=0.0)
        spec = SPECULAR * MAT_SPECULAR * torch.pow(rdv, SHININESS)
        color = (AMBIENT + DIFFUSE * ndl) * pos.new_tensor(VERT_COLOR) + spec
        covered = (fid >= 0)[..., None]
        return torch.where(covered, torch.clamp(color, 0.0, 1.0), 1.0)

    # -- public API ----------------------------------------------------------

    def _render_one(self, verts: torch.Tensor) -> torch.Tensor:
        """One frame (V, 3) -> (H, W, 3): rasterize, then shade with one
        gather of a packed (F, 27) per-face table (planes, vertex depths,
        positions, normals)."""
        vs = self.camera_transform(verts)
        s = self.image_size
        _, fid = rasterize(vs, self.faces, height=s, width=s)
        f = self.faces
        normals = self.vertex_normals(verts[None])[0]
        a0, a1, _ = face_planes(vs, f)
        table = torch.cat([
            a0, a1,                                                  # 6: bary planes
            vs[f[:, 0], 2:3], vs[f[:, 1], 2:3], vs[f[:, 2], 2:3],    # 3: depths
            verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]],          # 9: positions
            normals[f[:, 0]], normals[f[:, 1]], normals[f[:, 2]],    # 9: normals
        ], dim=-1)
        d = table[torch.clamp(fid, min=0).long()]                    # (H, W, 27)
        px, py = self._px, self._py
        w0 = d[..., 0] * px + d[..., 1] * py + d[..., 2]
        w1 = d[..., 3] * px + d[..., 4] * py + d[..., 5]
        bary = torch.stack([w0, w1, 1.0 - w0 - w1], dim=-1)
        bw = bary / torch.clamp(d[..., 6:9], min=1e-12)              # perspective correction
        bary = bw / torch.clamp(bw.sum(dim=-1, keepdim=True), min=1e-12)
        pos = torch.einsum("hwk,hwkc->hwc", bary, d[..., 9:18].reshape(s, s, 3, 3))
        nrm = l2_normalize(torch.einsum("hwk,hwkc->hwc", bary, d[..., 18:27].reshape(s, s, 3, 3)))
        return self._shade_points(pos, nrm, fid)

    def __call__(self, verts: torch.Tensor) -> torch.Tensor:
        """(B, V, 3) world-space verts -> (B, H, W, 3) float RGB in [0, 1]."""
        return torch.stack([self._render_one(v) for v in verts])

    def render_frames(self, verts: torch.Tensor, chunk: int = 25) -> np.ndarray:
        """Render a clip in fixed ``chunk``-frame batches (the last one padded
        by repeating its final frame, so every batch has one shape), returning
        uint8 yuv420p planes (T, H * 3 // 2, W) on the host: half the bytes of
        RGB, and what the video writer takes."""
        t = verts.shape[0]
        out = []
        for start in range(0, t, chunk):
            batch = verts[start : start + chunk]
            n = batch.shape[0]
            if n < chunk:
                batch = torch.cat([batch, batch[-1:].expand(chunk - n, -1, -1)])
            frames = rgb_to_yuv420p(torch.clamp(self(batch), 0.0, 1.0), channel_axis=-1)
            out.append(frames[:n].cpu().numpy())
        return np.concatenate(out, axis=0)
