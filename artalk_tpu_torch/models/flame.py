"""FLAME 3DMM head model: blendshapes + linear blend skinning, batched.

Counterpart of ``artalk_tpu/models/flame.py`` on the rendering path:
shape/expression blendshapes, axis-angle joint rotations (Rodrigues), pose
correctives, the 5-joint kinematic chain and LBS skinning, batched over all
frames at once. Landmarks and the dynamic contour are not ported yet
(ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

from typing import Dict, Tuple

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

    def forward(self, shape_params: torch.Tensor, expression_params: torch.Tensor,
                pose_params: torch.Tensor) -> torch.Tensor:
        """(B, n_shape), (B, n_exp), (B, 6) -> verts (B, V, 3) * scale.

        pose = [global(3), jaw(3)]; neck and eyes stay at zero."""
        batch = shape_params.shape[0]
        zeros3 = shape_params.new_zeros((batch, 3))
        betas = torch.cat([shape_params, expression_params], dim=1)
        full_pose = torch.cat([pose_params[:, :3], zeros3, pose_params[:, 3:],
                               shape_params.new_zeros((batch, 6))], dim=1)
        verts, _ = lbs(betas, full_pose, self.v_template, self.shapedirs,
                       self.posedirs, self.j_regressor, self.parents, self.lbs_weights)
        return verts * self.scale

    def motion_to_verts(self, shape_params: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
        """106-d motion -> verts: [0:100] expression, [100:103] global
        rotation, [103:106] jaw."""
        return self(shape_params, motion[..., :100], motion[..., 100:])
