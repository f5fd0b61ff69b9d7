"""Plain PyTorch reference of the mesh path: FLAME linear blend skinning
(Li et al. 2017) and ARTalk's Phong-shaded 512x512 mesh render, to yuv420.

The FLAME asset is synthetic, as the repository holds no licensed FLAME
model: ``synthetic_flame`` makes a FLAME-shaped head (5,023 vertices, the
5-joint kinematic tree, 300 shape and 100 expression components, 36 pose
correctives) from a fixed seed. The benchmark writes it to a file that the
program and the reference both read.

The render: the fixed camera of ARTalk's renderer (focal 12, the head 2 units
in front), a z-buffer in which a face covers a pixel centre where both
barycentrics and their sum's complement are >= 0 and the depth > 0, the
nearest face winning (depth compared with its 8 low mantissa bits dropped,
ties to the lower face id, faces in the Z order of their template
centroids), perspective-correct interpolation of positions and area-weighted
vertex normals, Phong shading with one point light, then RGB -> yuv420p
(BT.601, full range, 2x2 chroma means). The rasterizer tests each face
against the pixel centres of its own bounding box and keeps the minimum key
per pixel with a scatter.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

AMBIENT, DIFFUSE, SPECULAR, MAT_SPECULAR, SHININESS = 0.5, 0.3, 0.2, 0.6, 10.0
LIGHT = (0.0, 1.0, 3.0)
COLOR = (142 / 255.0, 179 / 255.0, 247 / 255.0)
FOCAL = 12.0
PARENTS = np.array([0, 0, 1, 1, 1], dtype=np.int32)


def synthetic_flame(num_verts: int = 5023, seed: int = 0) -> Dict[str, np.ndarray]:
    """A procedural FLAME-shaped asset: a fibonacci-sphere ellipsoid head,
    smooth random blendshape and pose-corrective bases, distance-softmax
    joint regressor and skinning weights, the convex hull as faces."""
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(seed)
    phi = np.arccos(1 - 2 * (np.arange(num_verts) + 0.5) / num_verts)
    theta = np.pi * (1 + 5 ** 0.5) * np.arange(num_verts)
    v_template = np.stack([0.085 * np.sin(phi) * np.cos(theta), 0.11 * np.cos(phi),
                           0.095 * np.sin(phi) * np.sin(theta)], axis=1).astype(np.float32)

    def smooth_basis(n_basis, scale):
        freqs = rng.standard_normal((8, 3, n_basis)) * scale
        phases = rng.uniform(0, 2 * np.pi, (8, n_basis))
        basis = np.zeros((num_verts, 3, n_basis), np.float32)
        for i in range(8):
            wave = np.sin((i + 1) * phi[:, None] + phases[i][None, :])
            for c in range(3):
                basis[:, c, :] += wave * freqs[i, c][None, :]
        return basis / 8.0

    shapedirs = smooth_basis(400, 0.01)
    posedirs = smooth_basis(36, 0.002)
    joints = np.array([[0.0, 0.0, 0.0], [0.0, -0.08, -0.01], [0.0, -0.03, 0.04],
                       [-0.03, 0.03, 0.07], [0.03, 0.03, 0.07]], np.float32)
    d2 = ((v_template[None] - joints[:, None]) ** 2).sum(-1)
    j_regressor = np.exp(-d2 / 0.001)
    j_regressor /= j_regressor.sum(axis=1, keepdims=True)
    w = np.exp(-d2.T / 0.004)
    hull = ConvexHull(np.stack([np.sin(phi) * np.cos(theta), np.cos(phi),
                                np.sin(phi) * np.sin(theta)], axis=1))
    faces = hull.simplices.astype(np.int32)
    tri = v_template[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = (n * tri.mean(axis=1)).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]
    return {"v_template": v_template, "shapedirs": shapedirs,
            "posedirs": posedirs.reshape(num_verts * 3, 36).T.copy(),
            "J_regressor": j_regressor.astype(np.float32), "parents": PARENTS,
            "lbs_weights": (w / w.sum(axis=1, keepdims=True)).astype(np.float32),
            "faces": faces}


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    angle = torch.linalg.norm(r + 1e-8, dim=-1, keepdim=True)
    d = r / angle
    cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    o = torch.zeros_like(x)
    k = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(r.shape[:-1] + (3, 3))
    return torch.eye(3, dtype=r.dtype, device=r.device) + sin * k + (1.0 - cos) * (k @ k)


class Flame:
    """FLAME with ``n_shape`` shape and ``n_exp`` expression components."""

    def __init__(self, data: Dict[str, np.ndarray], n_shape: int, n_exp: int,
                 device: torch.device, scale: float = 1.0):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        sd = np.asarray(data["shapedirs"], np.float32)
        self.shapedirs = t(np.concatenate([sd[:, :, :n_shape], sd[:, :, 300:300 + n_exp]], 2))
        self.v_template = t(data["v_template"])
        self.posedirs = t(data["posedirs"])
        self.j_regressor = t(data["J_regressor"])
        self.lbs_weights = t(data["lbs_weights"])
        self.parents = np.asarray(data["parents"], np.int64)
        self.scale = scale

    def verts(self, motion: torch.Tensor) -> torch.Tensor:
        """(B, 106) motion ([0:100] expression, [100:103] global rotation,
        [103:106] jaw), zero shape -> (B, V, 3) vertices."""
        b = motion.shape[0]
        shape = motion.new_zeros(b, self.shapedirs.shape[-1] - 100)
        return self.forward(shape, motion[:, :100], motion[:, 100:103], motion[:, 103:106])

    def forward(self, shape: torch.Tensor, expr: torch.Tensor, rot: torch.Tensor,
                jaw: torch.Tensor) -> torch.Tensor:
        """Shape and expression coefficients, global rotation and jaw
        (axis-angle); neck and eyes at rest -> (B, V, 3) vertices."""
        b = shape.shape[0]
        betas = torch.cat([shape, expr], 1)
        z3 = shape.new_zeros(b, 3)
        pose = torch.cat([rot, z3, jaw, z3, z3], 1)
        v_shaped = self.v_template[None] + torch.einsum("bl,mkl->bmk", betas, self.shapedirs)
        joints = torch.einsum("bik,ji->bjk", v_shaped, self.j_regressor)
        rot = rodrigues(pose.reshape(b, -1, 3))
        eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
        v_posed = v_shaped + ((rot[:, 1:] - eye).reshape(b, -1) @ self.posedirs).reshape(b, -1, 3)
        rel = joints.clone()
        rel[:, 1:] -= joints[:, self.parents[1:]]
        top = torch.cat([rot, rel[..., None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=top.device).expand(b, top.shape[1], 1, 4)
        mats = torch.cat([top, bottom], dim=-2)
        chain = [mats[:, 0]]
        for i in range(1, mats.shape[1]):
            chain.append(chain[int(self.parents[i])] @ mats[:, i])
        tr = torch.stack(chain, dim=1)
        homo = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
        tr = tr.clone()
        tr[:, :, :, 3] -= torch.einsum("bjmn,bjn->bjm", tr, homo)
        t = torch.einsum("vj,bjmn->bvmn", self.lbs_weights, tr)
        vh = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
        return torch.einsum("bvmn,bvn->bvm", t, vh)[..., :3] * self.scale


def _morton(v: np.ndarray) -> np.ndarray:
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    return (v | (v << 1)) & 0x5555555555555555


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(x.square().sum(dim=-1, keepdim=True)).clamp(min=1e-12)


def rgb_to_yuv420(rgb: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) float RGB in [0, 1] -> (T, 3H/2, W) uint8 yuv420p."""
    t, h, w, _ = rgb.shape
    q = torch.floor(torch.clamp(rgb * 255.0, 0.0, 255.0))
    y = 0.299 * q[..., 0] + 0.587 * q[..., 1] + 0.114 * q[..., 2]
    blk = 0.25 * (q[:, 0::2, 0::2] + q[:, 0::2, 1::2] + q[:, 1::2, 0::2] + q[:, 1::2, 1::2])
    u = -0.168736 * blk[..., 0] - 0.331264 * blk[..., 1] + 0.5 * blk[..., 2] + 128.0
    v = 0.5 * blk[..., 0] - 0.418688 * blk[..., 1] - 0.081312 * blk[..., 2] + 128.0
    u8 = lambda x: torch.floor(torch.clamp(x, 0.0, 255.0) + 0.5).to(torch.uint8)
    return torch.cat([u8(y), u8(u).reshape(t, h // 4, w), u8(v).reshape(t, h // 4, w)], 1)


class MeshRender:
    def __init__(self, faces: np.ndarray, template: np.ndarray, size: int,
                 device: torch.device):
        faces = np.asarray(faces, np.int64)
        cxy = np.asarray(template)[faces].mean(axis=1)
        g = [((c - c.min()) / (np.ptp(c) + 1e-9) * 1023).astype(np.int64)
             for c in (cxy[:, 0], cxy[:, 1])]
        faces = faces[np.argsort(_morton(g[0]) | (_morton(g[1]) << 1))]
        self.faces = torch.from_numpy(faces).to(device)
        self.size = size
        self.device = device

    def screen(self, verts: torch.Tensor) -> torch.Tensor:
        s = self.size
        z = verts[..., 2].neg() + 2.0
        px = (s / 2.0) * (1.0 - FOCAL * verts[..., 0].neg() / z)
        py = (s / 2.0) * (1.0 - FOCAL * verts[..., 1] / z)
        return torch.stack([px, py, z], dim=-1)

    def planes(self, vs: torch.Tensor):
        """Per-face planes of w0, w1 and depth over (x, y, 1): (B, F, 3) each."""
        f = self.faces
        (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = (vs[:, f[:, i]].unbind(-1) for i in range(3))
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        ok = area.abs() > 1e-12
        inv = torch.where(ok, 1.0 / torch.where(ok, area, torch.ones_like(area)), 0.0)
        a0 = torch.stack([(y1 - y2) * inv, (x2 - x1) * inv, (x1 * y2 - x2 * y1) * inv], -1)
        a1 = torch.stack([(y2 - y0) * inv, (x0 - x2) * inv, (x2 * y0 - x0 * y2) * inv], -1)
        dz0, dz1 = (z0 - z2)[..., None], (z1 - z2)[..., None]
        az = a0 * dz0 + a1 * dz1
        az = torch.cat([az[..., :2], az[..., 2:] + z2[..., None]], -1)
        a0 = torch.where(ok[..., None], a0, a0.new_tensor([0.0, 0.0, -1.0]))
        a1 = torch.where(ok[..., None], a1, 0.0)
        return a0, a1, az

    def rasterize(self, vs: torch.Tensor, a0, a1, az) -> torch.Tensor:
        """(B, V, 3) screen verts -> (B, H, W) face id (-1: background)."""
        b, s = vs.shape[0], self.size
        nf = self.faces.shape[0]
        tri = vs[:, self.faces][..., :2]                                    # (B, F, 3, 2)
        lo = torch.ceil(tri.amin(2) - 0.5).clamp(min=0)
        hi = torch.minimum(torch.floor(tri.amax(2) - 0.5), tri.new_tensor(s - 1.0))
        ext = (hi - lo + 1).clamp(min=0).long()                             # (B, F, 2)
        count = (ext[..., 0] * ext[..., 1]).reshape(-1)
        owner = torch.repeat_interleave(torch.arange(b * nf, device=vs.device), count)
        start = torch.cumsum(count, 0) - count
        k = torch.arange(owner.shape[0], device=vs.device) - start[owner]
        wx = ext.reshape(-1, 2)[owner, 0]
        lo_f = lo.reshape(-1, 2)[owner].long()
        x = lo_f[:, 0] + k % wx.clamp(min=1)
        y = lo_f[:, 1] + k // wx.clamp(min=1)
        px, py = x.float() + 0.5, y.float() + 0.5
        pl0, pl1, plz = (p.reshape(-1, 3)[owner] for p in (a0, a1, az))
        w0 = px * pl0[:, 0] + py * pl0[:, 1] + pl0[:, 2]
        w1 = px * pl1[:, 0] + py * pl1[:, 1] + pl1[:, 2]
        z = px * plz[:, 0] + py * plz[:, 1] + plz[:, 2]
        hit = (w0 >= 0) & (w1 >= 0) & (w0 + w1 <= 1.0) & (z > 0)
        fid = owner % nf
        key = ((z.view(torch.int32) & ~0xFF).long() << 32) | fid
        none = torch.iinfo(torch.int64).max
        pix = (owner // nf) * s * s + y * s + x
        best = torch.full((b * s * s,), none, dtype=torch.int64, device=vs.device)
        best.scatter_reduce_(0, pix[hit], key[hit], reduce="amin")
        return torch.where(best == none, -1, best & 0xFFFFFFFF).reshape(b, s, s)

    def normals(self, verts: torch.Tensor) -> torch.Tensor:
        f = self.faces
        v0, v1, v2 = verts[:, f[:, 0]], verts[:, f[:, 1]], verts[:, f[:, 2]]
        fn = torch.linalg.cross(v1 - v0, v2 - v0).double()
        acc = torch.zeros(verts.shape, dtype=torch.float64, device=verts.device)
        for i in range(3):
            acc.index_add_(1, f[:, i], fn)
        return l2n(acc.float())

    @torch.no_grad()
    def frames(self, verts: torch.Tensor) -> torch.Tensor:
        """(B, V, 3) world vertices -> (B, 3H/2, W) uint8 yuv420p."""
        s = self.size
        vs = self.screen(verts)
        a0, a1, az = self.planes(vs)
        fid = self.rasterize(vs, a0, a1, az)
        nrm = self.normals(verts)
        f = self.faces
        bidx = torch.arange(verts.shape[0], device=verts.device)[:, None, None]
        g = fid.clamp(min=0).long()
        coord = torch.arange(s, device=verts.device, dtype=torch.float32) + 0.5
        py, px = torch.meshgrid(coord, coord, indexing="ij")
        p0, p1 = a0[bidx, g], a1[bidx, g]
        w0 = p0[..., 0] * px + p0[..., 1] * py + p0[..., 2]
        w1 = p1[..., 0] * px + p1[..., 1] * py + p1[..., 2]
        bary = torch.stack([w0, w1, 1.0 - w0 - w1], -1)
        corner = f[g]                                                        # (B, H, W, 3)
        b4 = bidx[..., None]
        depth = vs[..., 2][b4, corner]
        bw = bary / depth.clamp(min=1e-12)
        bary = bw / bw.sum(-1, keepdim=True).clamp(min=1e-12)
        pos = torch.einsum("bhwk,bhwkc->bhwc", bary, verts[b4, corner])
        n = l2n(torch.einsum("bhwk,bhwkc->bhwc", bary, nrm[b4, corner]))
        l_dir = l2n(pos.new_tensor(LIGHT) - pos)
        v_dir = l2n(pos.new_tensor([0.0, 0.0, 2.0]) - pos)
        ndl_raw = (n * l_dir).sum(-1, keepdim=True)
        r_dir = 2.0 * ndl_raw * n - l_dir
        rdv = (r_dir * v_dir).sum(-1, keepdim=True).clamp(min=0.0)
        color = ((AMBIENT + DIFFUSE * ndl_raw.clamp(min=0.0)) * pos.new_tensor(COLOR)
                 + SPECULAR * MAT_SPECULAR * torch.pow(rdv, SHININESS))
        rgb = torch.where((fid >= 0)[..., None], color.clamp(0.0, 1.0), 1.0)
        return rgb_to_yuv420(rgb)
