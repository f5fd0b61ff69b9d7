"""Debug renderers: point clouds and UV-textured meshes.

Counterpart of ``artalk_tpu/models/renderer_extras.py`` (the reference's
PointRenderer and TextureRenderer; no inference path uses them):

- ``PointRenderer``: an orbiting look-at camera (dist / elev / azim), a
  10k-point subsample, optional extra points and RGB coordinate-axis ticks,
  random colors, small isotropic gaussian splats through
  ``ops/gsplat.rasterize_gaussians`` (on the card: the prepass with the sort
  kernel, then the splat kernel). ``__call__`` draws the subsample and the
  colors from a ``torch.Generator``; ``render_points`` renders given points
  and colors.
- ``TextureRenderer``: a UV-textured mesh under a pytorch3d
  PerspectiveCameras-style camera (R | T, focal, principal point), z-buffer
  through ``ops/rasterizer.rasterize`` (on the card: the z-buffer kernel),
  perspective-corrected barycentric UVs, bilinear texture sampling, optional
  DECA spherical-harmonics relighting applied to the rendered images as the
  reference does, and full-mesh and face-region silhouette masks.

Both run on ``device`` ("cuda" unless the caller passes another).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.gsplat import rasterize_gaussians
from ..ops.rasterizer import face_planes, rasterize


def look_at_camera(dist: float, elev_deg: float, azim_deg: float) -> np.ndarray:
    """(dist, elev, azim) orbit camera looking at the origin (+Y up) -> (3, 4)
    matrix in the splat's convention (p_view = p @ R + t, with the splat's
    (-1, -1, 1) view flip folded in). Angles as in
    pytorch3d.look_at_view_transform."""
    elev = math.radians(elev_deg)
    azim = math.radians(azim_deg)
    eye = np.array([
        dist * math.cos(elev) * math.sin(azim),
        dist * math.sin(elev),
        dist * math.cos(elev) * math.cos(azim),
    ])
    z = -eye / np.linalg.norm(eye)                       # toward the origin
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x = x / max(np.linalg.norm(x), 1e-9)
    y = np.cross(z, x)
    r_cols = np.stack([x, y, z], axis=1)                 # world -> view columns
    flip = np.array([-1.0, -1.0, 1.0])
    r = r_cols * flip[None, :]
    t = -(eye @ r_cols) * flip
    return np.concatenate([r, t[:, None]], axis=1).astype(np.float32)


class PointRenderer:
    """Debug point-cloud renderer: subsample 10k points, optionally append
    extra points and RGB coordinate-axis ticks, splat them with random colors
    from an orbiting camera."""

    POINT_FOV_FOCAL = 1.0 / math.tan(math.radians(30.0))  # FoV 60 degrees
    MAX_POINTS = 10000
    POINT_RADIUS = 0.005                                   # NDC, as pytorch3d's

    def __init__(self, image_size: int = 256, device="cuda"):
        if image_size % 128:
            raise ValueError(f"image_size {image_size}: the splat's tiles are 128 px wide")
        self.image_size = int(image_size)
        self.device = torch.device(device)

    def select_points(self, points, sel: torch.Tensor, ex_points=None,
                      coords: bool = True) -> torch.Tensor:
        """(B, N, 3) points -> (B, M, 3): the rows ``sel``, then the extra
        points, then N'/10 ticks along each unit axis (N' the count so far)."""
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        pts = pts[:, sel.to(self.device)]
        b = pts.shape[0]
        if ex_points is not None:
            ex = torch.as_tensor(ex_points, dtype=torch.float32, device=self.device)
            pts = torch.cat([pts, ex.expand((b,) + ex.shape[-2:])], dim=1)
        if coords:
            cs = pts.shape[1] // 10
            li = torch.linspace(0.0, 1.0, cs, device=self.device)
            cod = torch.zeros((cs * 3, 3), device=self.device)
            for axis in range(3):
                cod[axis * cs:(axis + 1) * cs, axis] = li
            pts = torch.cat([pts, cod.expand(b, -1, -1)], dim=1)
        return pts

    def render_points(self, pts: torch.Tensor, colors: torch.Tensor, d: float = 3.0,
                      e: float = 15.0, a: float = 30.0) -> torch.Tensor:
        """pts (B, M, 3), colors (M, 3) in [0, 1] -> (B, 3, H, W) in [0, 255]."""
        num = pts.shape[1]
        dev = self.device
        pts = pts.to(dev, torch.float32)
        cam = torch.from_numpy(look_at_camera(d, e, a)).to(dev)
        colors32 = torch.zeros((num, 32), device=dev)
        colors32[:, :3] = colors.to(dev)
        opac = torch.full((num, 1), 0.9, device=dev)
        # world radius that projects to about POINT_RADIUS in NDC at the orbit distance
        scales = torch.full((num, 3), self.POINT_RADIUS * d / self.POINT_FOV_FOCAL, device=dev)
        quats = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).expand(num, 4)
        frames = [rasterize_gaussians(p, colors32, opac, scales, quats, cam,
                                      focal=self.POINT_FOV_FOCAL, size=self.image_size)[:3]
                  for p in pts]
        return torch.stack(frames) * 255.0

    def __call__(self, points, d: float = 3.0, e: float = 15.0, a: float = 30.0,
                 coords: bool = True, ex_points=None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """points (B, N, 3) -> (B, 3, H, W) in [0, 255]; the subsample and
        the colors are drawn from ``generator`` (seed 0 when None)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        n = pts.shape[1]
        sel = torch.randperm(n, generator=generator)[:min(n, self.MAX_POINTS)]
        pts = self.select_points(pts, sel, ex_points, coords)
        colors = torch.rand((pts.shape[1], 3), generator=generator)
        return self.render_points(pts, colors, d, e, a)


# DECA's spherical-harmonics constants
_SH_CONST = np.array([
    1 / np.sqrt(4 * np.pi),
    ((2 * np.pi) / 3) * (np.sqrt(3 / (4 * np.pi))),
    ((2 * np.pi) / 3) * (np.sqrt(3 / (4 * np.pi))),
    ((2 * np.pi) / 3) * (np.sqrt(3 / (4 * np.pi))),
    (np.pi / 4) * 3 * (np.sqrt(5 / (12 * np.pi))),
    (np.pi / 4) * 3 * (np.sqrt(5 / (12 * np.pi))),
    (np.pi / 4) * 3 * (np.sqrt(5 / (12 * np.pi))),
    (np.pi / 4) * (3 / 2) * (np.sqrt(5 / (12 * np.pi))),
    (np.pi / 4) * (1 / 2) * (np.sqrt(5 / (4 * np.pi))),
], dtype=np.float32)


def add_sh_light(images: torch.Tensor, sh_coeff: torch.Tensor) -> torch.Tensor:
    """DECA-style SH shading applied, as the reference does, to the rendered
    images. images (B, 3, H, W), sh_coeff (B, 9, 3) -> (B, 3, H, W)."""
    n = images
    sh = torch.stack([
        n[:, 0] * 0.0 + 1.0, n[:, 0], n[:, 1],
        n[:, 2], n[:, 0] * n[:, 1], n[:, 0] * n[:, 2],
        n[:, 1] * n[:, 2], n[:, 0] ** 2 - n[:, 1] ** 2,
        3.0 * (n[:, 2] ** 2) - 1.0,
    ], dim=1)                                             # (B, 9, H, W)
    sh = sh * torch.from_numpy(_SH_CONST).to(images.device)[None, :, None, None]
    return torch.sum(sh_coeff[:, :, :, None, None] * sh[:, :, None, :, :], dim=1)


def _bilinear_sample(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """tex (Ht, Wt, 3), uv (..., 2) in [0, 1] with (0, 0) the bottom-left
    corner (pytorch3d TexturesUV: align_corners=True, border padding)."""
    ht, wt = tex.shape[0], tex.shape[1]
    x = torch.clamp(uv[..., 0], 0.0, 1.0) * (wt - 1)
    y = (1.0 - torch.clamp(uv[..., 1], 0.0, 1.0)) * (ht - 1)
    x0 = torch.clamp(torch.floor(x), 0, wt - 1).long()
    y0 = torch.clamp(torch.floor(y), 0, ht - 1).long()
    x1 = torch.clamp(x0 + 1, max=wt - 1)
    y1 = torch.clamp(y0 + 1, max=ht - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    c00, c01 = tex[y0, x0], tex[y0, x1]
    c10, c11 = tex[y1, x0], tex[y1, x1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


class TextureRenderer:
    """UV-textured mesh renderer.

    tuv: ``verts_uvs`` (Vt, 2), ``textures_idx`` (F, 3), ``verts_idx`` (F, 3),
    the fields the reference loads from an .obj. flame_mask: optional vertex
    ids; the faces whose three vertices are all in it form the face-region
    silhouette."""

    def __init__(self, tuv: Dict[str, np.ndarray], flame_mask=None, device="cuda"):
        self.device = torch.device(device)
        uvverts = torch.from_numpy(np.asarray(tuv["verts_uvs"], np.float32))
        uvfaces = torch.from_numpy(np.asarray(tuv["textures_idx"], np.int64))
        faces = np.asarray(tuv["verts_idx"], np.int64)
        self.faces = torch.from_numpy(faces).to(self.device)
        self.face_uv = uvverts[uvfaces].reshape(-1, 6).to(self.device)   # (F, 6)
        self.flame_mask = None
        if flame_mask is not None:
            mask = np.zeros(int(faces.max()) + 1, bool)
            ids = np.asarray(list(flame_mask), np.int64)
            mask[ids[ids < len(mask)]] = True
            self.flame_mask = torch.from_numpy(mask[faces].all(axis=1)).to(self.device)

    @staticmethod
    def _project(verts: torch.Tensor, transform: torch.Tensor, focal: float,
                 principal_point: torch.Tensor, size: int) -> torch.Tensor:
        """(V, 3) world -> (V, 3) screen (x_pix, y_pix, z_cam), pytorch3d
        PerspectiveCameras semantics (row vectors X @ R + T, NDC +X left,
        pixel 0 at NDC +1)."""
        pv = verts @ transform[:3, :3] + transform[:3, 3]
        z = pv[:, 2]
        zs = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
        x_ndc = focal * pv[:, 0] / zs + principal_point[0]
        y_ndc = focal * pv[:, 1] / zs + principal_point[1]
        return torch.stack([(size / 2.0) * (1.0 - x_ndc), (size / 2.0) * (1.0 - y_ndc), z],
                           dim=-1)

    def __call__(self, vertices_world, texture_images, lights=None, image_size: int = 512,
                 transform_matrix=None, focal_length: float = 12.0,
                 principal_point=(0.0, 0.0)
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """vertices_world (B, V, 3), texture_images (3, Ht, Wt) or
        (B, 3, Ht, Wt) -> (images (B, 3, H, W), masks_all (B, 1, H, W) bool,
        masks_face (B, 1, H, W) bool or None)."""
        dev = self.device
        verts = torch.as_tensor(vertices_world, dtype=torch.float32, device=dev)
        b = verts.shape[0]
        pp = torch.as_tensor(principal_point, dtype=torch.float32, device=dev).reshape(-1)
        tex = torch.as_tensor(texture_images, dtype=torch.float32, device=dev)
        if tex.ndim == 3:
            tex = tex[None].expand((b,) + tex.shape)
        if transform_matrix is None:
            # the reference's fixed default camera: R = diag(-1, 1, -1), T = (0, 0, 2)
            transform_matrix = [[-1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                                [0.0, 0.0, -1.0, 2.0]]
        transform = torch.as_tensor(transform_matrix, dtype=torch.float32, device=dev)
        if transform.ndim == 2:
            transform = transform[None].expand(b, 3, 4)

        ys = torch.arange(image_size, dtype=torch.float32, device=dev) + 0.5
        py, px = torch.meshgrid(ys, ys, indexing="ij")
        images, masks_all, masks_face = [], [], []
        for i in range(b):
            vs = self._project(verts[i], transform[i], focal_length, pp, image_size)
            _, fid = rasterize(vs, self.faces, height=image_size, width=image_size)
            covered = fid >= 0
            a0, a1, _ = face_planes(vs, self.faces)
            # perspective-corrected barycentrics (the MeshRenderer's recipe)
            table = torch.cat([a0, a1, vs[self.faces, 2], self.face_uv], dim=-1)   # (F, 15)
            d = table[torch.clamp(fid, min=0).long()]                              # (H, W, 15)
            w0 = d[..., 0] * px + d[..., 1] * py + d[..., 2]
            w1 = d[..., 3] * px + d[..., 4] * py + d[..., 5]
            bary = torch.stack([w0, w1, 1.0 - w0 - w1], dim=-1)
            bw = bary / torch.clamp(d[..., 6:9], min=1e-12)
            bary = bw / torch.clamp(bw.sum(dim=-1, keepdim=True), min=1e-12)
            uv = torch.einsum("hwk,hwkc->hwc", bary,
                              d[..., 9:15].reshape(image_size, image_size, 3, 2))
            rgb = _bilinear_sample(tex[i].permute(1, 2, 0), uv)
            rgb = torch.where(covered[..., None], rgb, 0.0)
            images.append(rgb.permute(2, 0, 1))
            masks_all.append(covered[None])
            if self.flame_mask is not None:
                # faces outside the mask collapse to a degenerate (v0, v0, v0)
                # triangle: zero area, never covers a pixel
                sub = torch.where(self.flame_mask[:, None], self.faces, self.faces[:, :1])
                _, fid_m = rasterize(vs, sub, height=image_size, width=image_size)
                masks_face.append((fid_m >= 0)[None])
        out_images = torch.stack(images)
        masks = torch.stack(masks_all)
        if lights is not None:
            out_images = add_sh_light(out_images, torch.as_tensor(lights, dtype=torch.float32,
                                                                  device=dev))
            out_images = torch.where(masks, out_images, 0.0)
        return out_images, masks, torch.stack(masks_face) if masks_face else None
