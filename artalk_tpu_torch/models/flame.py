"""FLAME 3DMM head model: blendshapes + linear blend skinning, batched.

Counterpart of ``artalk_tpu/models/flame.py``: shape/expression
blendshapes, axis-angle joint rotations (Rodrigues), pose correctives, the
5-joint kinematic chain and LBS skinning, batched over all frames at once;
the 70-point landmarks (with the eye refinement) and the yaw-dependent
17-point face contour from the asset's optional landmark tables.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    angle = torch.linalg.norm(rot_vecs + 1e-8, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    k = torch.stack([
        zeros, -rz, ry,
        rz, zeros, -rx,
        -ry, rx, zeros,
    ], dim=-1).reshape(rot_vecs.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * k + (1.0 - cos) * (k @ k)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """(B, L) x (V, 3, L) -> (B, V, 3)."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(j_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("bik,ji->bjk", vertices, j_regressor)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kinematic-chain composition. rot_mats (B, J, 3, 3), joints (B, J, 3).
    Returns (posed_joints (B, J, 3), rel_transforms (B, J, 4, 4))."""
    num_joints = joints.shape[1]
    rel_joints = joints.clone()
    rel_joints[:, 1:] -= joints[:, parents[1:]]
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)      # (B, J, 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    transforms_mat = torch.cat([top, bottom], dim=-2)                # (B, J, 4, 4)
    chain = [transforms_mat[:, 0]]
    for i in range(1, num_joints):
        chain.append(chain[parents[i]] @ transforms_mat[:, i])
    transforms = torch.stack(chain, dim=1)
    posed_joints = transforms[:, :, :3, 3]
    # subtract the rest-pose joint position rotated into the posed frame
    joints_homo = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    correction = torch.einsum("bjmn,bjn->bjm", transforms, joints_homo)
    rel_transforms = transforms.clone()
    rel_transforms[:, :, :, 3] -= correction
    return posed_joints, rel_transforms


def lbs(betas: torch.Tensor, pose: torch.Tensor, v_template: torch.Tensor,
        shapedirs: torch.Tensor, posedirs: torch.Tensor, j_regressor: torch.Tensor,
        parents: np.ndarray, lbs_weights: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear blend skinning. betas (B, n_betas), pose (B, J*3) axis-angle.
    Returns (verts (B, V, 3), posed_joints (B, J, 3))."""
    batch = betas.shape[0]
    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    joints = vertices2joints(j_regressor, v_shaped)
    rot_mats = batch_rodrigues(pose.reshape(batch, -1, 3))
    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(batch, -1)
    v_posed = v_shaped + (pose_feature @ posedirs).reshape(batch, -1, 3)
    posed_joints, rel_transforms = batch_rigid_transform(rot_mats, joints, parents)
    t = torch.einsum("vj,bjmn->bvmn", lbs_weights, rel_transforms)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvmn,bvn->bvm", t, v_homo)[..., :3]
    return verts, posed_joints


def _table(data: Dict[str, np.ndarray], key: str, dtype) -> Optional[torch.Tensor]:
    """An optional table of the asset as a tensor, None when it is absent."""
    table = data.get(key)
    return None if table is None else torch.from_numpy(np.asarray(table, dtype).copy())


class FlameModel(nn.Module):
    """FLAME with n_shape shape + n_exp expression components.

    ``data`` holds v_template (V,3), shapedirs (V,3,300+E), posedirs
    (P, V*3), J_regressor (J,V), parents (J,), lbs_weights (V,J), faces (F,3).
    """

    NUM_SHAPE_TOTAL = 300

    def __init__(self, data: Dict[str, np.ndarray], n_shape: int = 300,
                 n_exp: int = 100, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.n_shape, self.n_exp = n_shape, n_exp
        shapedirs = np.asarray(data["shapedirs"], np.float32)
        n_exp_avail = shapedirs.shape[-1] - self.NUM_SHAPE_TOTAL
        assert n_shape <= self.NUM_SHAPE_TOTAL and n_exp <= n_exp_avail, (
            f"requested {n_shape}+{n_exp}, available {self.NUM_SHAPE_TOTAL}+{n_exp_avail}")
        self.register_buffer("shapedirs", torch.from_numpy(np.concatenate([
            shapedirs[:, :, :n_shape],
            shapedirs[:, :, self.NUM_SHAPE_TOTAL : self.NUM_SHAPE_TOTAL + n_exp],
        ], axis=2)))
        self.register_buffer("v_template", torch.from_numpy(
            np.asarray(data["v_template"], np.float32).copy()))
        posedirs = np.asarray(data["posedirs"], np.float32)
        if posedirs.ndim == 3:  # (V, 3, P) raw layout -> (P, V*3)
            posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
        self.register_buffer("posedirs", torch.from_numpy(np.ascontiguousarray(posedirs)))
        self.register_buffer("j_regressor", torch.from_numpy(
            np.asarray(data["J_regressor"], np.float32).copy()))
        self.parents = np.asarray(data["parents"], np.int64).copy()
        self.parents[0] = 0  # root composes with itself; chain uses index 0 directly
        self.register_buffer("lbs_weights", torch.from_numpy(
            np.asarray(data["lbs_weights"], np.float32).copy()))
        self.faces = np.asarray(data["faces"], np.int32)
        # optional landmark tables (converted from the FLAME checkpoint's
        # lmk_embeddings): the 70 static landmarks, and the dynamic contour,
        # 79 yaw-indexed variants of the 17-point jaw contour
        lmk_faces = data.get("full_lmk_faces_idx")
        self.lmk_faces_idx = None if lmk_faces is None else np.asarray(lmk_faces, np.int64)
        self.register_buffer("lmk_bary_coords", _table(data, "full_lmk_bary_coords", np.float32))
        self.register_buffer("dynamic_lmk_faces_idx",
                             _table(data, "dynamic_lmk_faces_idx", np.int64))
        self.register_buffer("dynamic_lmk_bary_coords",
                             _table(data, "dynamic_lmk_bary_coords", np.float32))
        # neck -> root joint chain for the relative yaw
        parents_orig = np.asarray(data["parents"], np.int64)
        chain, cur = [], 1  # the neck joint
        while True:
            chain.append(cur)
            if cur == 0:
                break
            cur = int(parents_orig[cur])
        self.neck_kin_chain = np.asarray(chain, np.int64)

    def landmarks(self, vertices: torch.Tensor, refine_eyes: bool = True) -> torch.Tensor:
        """(B, V, 3) verts -> (B, 70, 3) landmarks; with ``refine_eyes`` on
        the 5023-vertex topology the eye landmarks become eyeball vertices.
        Requires the asset's landmark tables."""
        if self.lmk_faces_idx is None:
            raise ValueError("the FLAME asset has no landmark tables (full_lmk_faces_idx)")
        lmks = vertices2landmarks(vertices, self.faces, self.lmk_faces_idx, self.lmk_bary_coords)
        if refine_eyes and vertices.shape[1] == 5023:
            lmks = reselect_eyes(vertices, lmks)
        return lmks

    def dynamic_landmarks(self, vertices: torch.Tensor,
                          pose_params: torch.Tensor) -> torch.Tensor:
        """Pose-dependent 17-point face contour: the relative y-rotation of
        the neck kinematic chain selects one of 79 contour tables (yaw -39 to
        +39 degrees in 1-degree steps, extremes clamped), interpolated
        barycentrically on the selected faces.

        vertices (B, V, 3); pose_params (B, 6 | 3) as [global(3), jaw(3)] (3-d
        means jaw-only). Returns (B, 17, 3), unscaled like ``landmarks``."""
        if self.dynamic_lmk_faces_idx is None:
            raise ValueError("the FLAME asset has no dynamic landmark tables")
        batch = vertices.shape[0]
        if pose_params.shape[-1] == 3:
            pose_params = torch.cat([pose_params.new_zeros((batch, 3)), pose_params], dim=-1)
        full_pose = torch.cat([pose_params[:, :3], pose_params.new_zeros((batch, 3)),
                               pose_params[:, 3:], pose_params.new_zeros((batch, 6))], dim=1)
        fidx, bary = find_dynamic_lmk_idx_and_bcoords(
            full_pose, self.dynamic_lmk_faces_idx, self.dynamic_lmk_bary_coords,
            self.neck_kin_chain)
        return vertices2landmarks_batched(vertices, self.faces, fidx, bary)

    def forward(self, shape_params: torch.Tensor, expression_params: torch.Tensor,
                pose_params: Optional[torch.Tensor] = None,
                eye_pose_params: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, n_shape), (B, n_exp), (B, 6 | 3) -> verts (B, V, 3) * scale.

        pose = [global(3), jaw(3)], zero when None; a 3-d pose is jaw-only.
        The neck stays at zero, the eyes too unless ``eye_pose_params`` (B, 6)
        is given."""
        batch = shape_params.shape[0]
        if pose_params is None:
            pose_params = shape_params.new_zeros((batch, 6))
        if pose_params.shape[-1] == 3:
            pose_params = torch.cat([pose_params.new_zeros((batch, 3)), pose_params], dim=-1)
        if eye_pose_params is None:
            eye_pose_params = shape_params.new_zeros((batch, 6))
        betas = torch.cat([shape_params, expression_params], dim=1)
        full_pose = torch.cat([pose_params[:, :3], pose_params.new_zeros((batch, 3)),
                               pose_params[:, 3:], eye_pose_params], dim=1)
        verts, _ = lbs(betas, full_pose, self.v_template, self.shapedirs,
                       self.posedirs, self.j_regressor, self.parents, self.lbs_weights)
        return verts * self.scale

    def motion_to_verts(self, shape_params: torch.Tensor, motion: torch.Tensor,
                        with_global: bool = True) -> torch.Tensor:
        """106-d motion -> verts: [0:100] expression, [100:103] global
        rotation (zeroed unless ``with_global``), [103:106] jaw."""
        pose = motion[..., 100:]
        if not with_global:
            pose = torch.cat([torch.zeros_like(pose[..., :3]), pose[..., 3:]], dim=-1)
        return self(shape_params, motion[..., :100], pose)


def vertices2landmarks(vertices: torch.Tensor, faces: np.ndarray, lmk_faces_idx: np.ndarray,
                       lmk_bary_coords: torch.Tensor) -> torch.Tensor:
    """Barycentric landmark interpolation. vertices (B, V, 3); faces (F, 3);
    lmk_faces_idx (L,); bary (L, 3) -> (B, L, 3)."""
    tri = torch.from_numpy(faces[lmk_faces_idx].astype(np.int64)).to(vertices.device)
    return torch.einsum("blfi,lf->bli", vertices[:, tri], lmk_bary_coords)


def vertices2landmarks_batched(vertices: torch.Tensor, faces: np.ndarray,
                               lmk_faces_idx: torch.Tensor,
                               lmk_bary_coords: torch.Tensor) -> torch.Tensor:
    """Barycentric landmark interpolation with per-batch face indices.
    vertices (B, V, 3); faces (F, 3); lmk_faces_idx (B, L); bary (B, L, 3)."""
    tri = torch.from_numpy(faces.astype(np.int64)).to(vertices.device)[lmk_faces_idx]
    lmk_verts = torch.gather(vertices, 1, tri.reshape(tri.shape[0], -1, 1).expand(-1, -1, 3))
    return torch.einsum("blfi,blf->bli", lmk_verts.reshape(tri.shape + (3,)), lmk_bary_coords)


def find_dynamic_lmk_idx_and_bcoords(full_pose: torch.Tensor, dynamic_lmk_faces_idx: torch.Tensor,
                                     dynamic_lmk_bary_coords: torch.Tensor,
                                     neck_kin_chain: np.ndarray
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the yaw-dependent face contour table.

    full_pose (B, J*3) axis-angle; the chain joints' rotations compose into a
    relative rotation whose y-euler angle (degrees, rounded half to even,
    clamped to at most 39; negatives map to 40..78, below -39 to 78) indexes
    the 79-entry tables. Returns (faces_idx (B, L), bary (B, L, 3))."""
    b = full_pose.shape[0]
    rots = batch_rodrigues(full_pose.reshape(b, -1, 3)[:, torch.from_numpy(neck_kin_chain)])
    rel = torch.eye(3, dtype=full_pose.dtype, device=full_pose.device).expand(b, 3, 3)
    for i in range(len(neck_kin_chain)):
        rel = torch.matmul(rots[:, i], rel)
    sy = torch.sqrt(rel[:, 0, 0] ** 2 + rel[:, 1, 0] ** 2)
    deg = torch.atan2(-rel[:, 2, 0], sy) * (180.0 / np.pi)
    angle = torch.round(torch.clamp(deg, max=39.0)).to(torch.int64)
    idx = torch.where(angle < 0, torch.where(angle < -39, 78, 39 - angle), angle)
    return dynamic_lmk_faces_idx[idx], dynamic_lmk_bary_coords[idx]


# 70-landmark eye refinement: specific eyeball vertices replace the coarse eye
# landmarks
_EYE_IN_SHAPE = np.array([2422, 2422, 2452, 2454, 2471, 3638, 2276, 2360, 3835,
                          1292, 1217, 1146, 1146, 999, 827], np.int64)
_EYE_REDUCE = np.array([0, 2, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14], np.int64)
_EYE_TARGET = np.array([37, 38, 40, 41, 43, 44, 46, 47], np.int64)
_EYE_SOURCE = np.array([1, 2, 4, 5, 7, 8, 10, 11], np.int64)


def reselect_eyes(vertices: torch.Tensor, lmks70: torch.Tensor) -> torch.Tensor:
    """Replace the eye landmarks with eyeball-vertex positions (the full
    5023-vertex FLAME topology)."""
    eye = vertices[:, torch.from_numpy(_EYE_IN_SHAPE)]
    for a in (0, 2, 11):
        eye[:, a] = (eye[:, a] + eye[:, a + 1]) * 0.5
    out = lmks70.clone()
    out[:, torch.from_numpy(_EYE_TARGET)] = eye[:, torch.from_numpy(_EYE_REDUCE[_EYE_SOURCE])]
    return out
