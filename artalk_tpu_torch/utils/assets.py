"""FLAME and avatar-bank assets: loading and synthetic generation (numpy only).

Copied from ``artalk_tpu/utils/assets.py`` (which cannot be imported without
jax). The real FLAME data is license-gated; without a converted
``assets/flame.npz`` the engine uses a *synthetic* FLAME-compatible asset
(same shapes, same kinematic tree, procedural head geometry), generated once
from a fixed seed and cached as ``assets/flame_synthetic.npz``. The cache is
not committed, so a fresh checkout synthesizes it at first use; the generator
matches the JAX package's, so both packages render the same head. The
GAGAvatar bank (``assets/avatars/synthetic_{0,1}.npz``) is synthesized the
same way when absent.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

# FLAME constants: 5023 vertices, 5 joints (global, neck, jaw, eye_l, eye_r),
# 300 shape + 100 expression basis vectors, 4*9 pose-corrective basis.
NUM_VERTS = 5023
NUM_JOINTS = 5
NUM_SHAPE = 300
NUM_EXPR = 100
POSE_BASIS = (NUM_JOINTS - 1) * 9
PARENTS = np.array([0, 0, 1, 1, 1], dtype=np.int32)  # root's parent unused


def synthetic_flame(num_verts: int = NUM_VERTS, num_faces: int = 9976,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Procedural FLAME-shaped asset: an ellipsoid head with smooth random
    blendshape bases. Statistically sane (small displacements, normalized
    skinning weights, valid kinematic chain) so renders and benchmarks are
    representative; NOT the licensed FLAME model."""
    rng = np.random.default_rng(seed)
    # ellipsoid point cloud as the template head
    phi = np.arccos(1 - 2 * (np.arange(num_verts) + 0.5) / num_verts)
    theta = np.pi * (1 + 5 ** 0.5) * np.arange(num_verts)  # fibonacci sphere
    v_template = np.stack([
        0.085 * np.sin(phi) * np.cos(theta),
        0.11 * np.cos(phi),
        0.095 * np.sin(phi) * np.sin(theta),
    ], axis=1).astype(np.float32)

    def smooth_basis(n_basis, scale):
        # smooth low-frequency displacement fields over the sphere
        freqs = rng.standard_normal((8, 3, n_basis)) * scale
        phases = rng.uniform(0, 2 * np.pi, (8, n_basis))
        basis = np.zeros((num_verts, 3, n_basis), np.float32)
        for i in range(8):
            wave = np.sin((i + 1) * phi[:, None] + phases[i][None, :])
            for c in range(3):
                basis[:, c, :] += wave * freqs[i, c][None, :]
        return basis / 8.0

    shapedirs = smooth_basis(NUM_SHAPE + NUM_EXPR, 0.01)
    posedirs_raw = smooth_basis(POSE_BASIS, 0.002)  # (V, 3, P)

    # joints roughly at head center / neck / jaw / eyes
    joint_targets = np.array([
        [0.0, 0.0, 0.0], [0.0, -0.08, -0.01], [0.0, -0.03, 0.04],
        [-0.03, 0.03, 0.07], [0.03, 0.03, 0.07],
    ], np.float32)
    # regressor: softmax over inverse distances -> rows sum to 1
    d2 = ((v_template[None] - joint_targets[:, None]) ** 2).sum(-1)
    j_regressor = np.exp(-d2 / 0.001)
    j_regressor /= j_regressor.sum(axis=1, keepdims=True)

    # skinning weights: distance-based soft assignment, rows sum to 1
    w = np.exp(-d2.T / 0.004)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    # faces: proper closed triangulation of the point cloud (convex hull of
    # the sphere samples); num_faces is advisory -- the hull determines it
    from scipy.spatial import ConvexHull

    hull = ConvexHull(np.stack([
        np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)
    ], axis=1))
    faces = hull.simplices.astype(np.int32)
    # orient faces outward (positive dot of face normal with centroid dir)
    tri = v_template[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    c = tri.mean(axis=1)
    flip = (n * c).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]

    # dynamic contour tables: 79 yaw-indexed variants of a 17-point contour
    # (same shapes as the reference's lmk_embeddings, FLAME.py:52-53)
    dyn_faces = rng.integers(0, len(faces), (79, 17)).astype(np.int64)
    dyn_bary = rng.random((79, 17, 3)).astype(np.float32)
    dyn_bary /= dyn_bary.sum(axis=-1, keepdims=True)

    return {
        "v_template": v_template,
        "shapedirs": shapedirs.astype(np.float32),
        "posedirs": posedirs_raw.reshape(num_verts * 3, POSE_BASIS).T.copy(),
        "J_regressor": j_regressor.astype(np.float32),
        "parents": PARENTS,
        "lbs_weights": lbs_weights,
        "faces": faces,
        "dynamic_lmk_faces_idx": dyn_faces,
        "dynamic_lmk_bary_coords": dyn_bary,
    }


def save_flame_npz(data: Dict[str, np.ndarray], path: str) -> None:
    np.savez_compressed(path, **data)


def load_flame_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_or_synthesize_flame(assets_dir: str) -> Dict[str, np.ndarray]:
    """Prefer a converted real FLAME asset; fall back to the synthetic one
    (generated once and cached on disk)."""
    real = os.path.join(assets_dir, "flame.npz")
    if os.path.exists(real):
        return load_flame_npz(real)
    synth = os.path.join(assets_dir, "flame_synthetic.npz")
    if not os.path.exists(synth):
        os.makedirs(assets_dir, exist_ok=True)
        save_flame_npz(synthetic_flame(), synth)
    return load_flame_npz(synth)


def synthetic_avatar(seed: int = 0, size: int = 512) -> Dict[str, np.ndarray]:
    """Synthetic tracked-avatar entry (image + camera + shape code), matching
    the schema of the reference's tracked.pt entries (GAGAvatar/models.py:50-54)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.stack([
        0.5 + 0.3 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.05),
        0.4 + 0.25 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.05),
        0.35 + 0.2 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.05),
    ])
    noise = rng.normal(0, 0.02, base.shape).astype(np.float32)
    image = np.clip(base + noise, 0, 1).astype(np.float32)
    transform = np.array(
        [[-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 5000.0 / 512]], np.float32)
    shapecode = (rng.standard_normal(300) * 0.3).astype(np.float32)
    return {"image": image, "transform_matrix": transform, "shapecode": shapecode}


def ensure_synthetic_avatars(assets_dir: str, count: int = 2) -> None:
    """Create a synthetic avatar bank under assets/avatars/ if none exists."""
    bank = os.path.join(assets_dir, "avatars")
    if os.path.isdir(bank) and any(f.endswith(".npz") for f in os.listdir(bank)):
        return
    os.makedirs(bank, exist_ok=True)
    for i in range(count):
        np.savez_compressed(os.path.join(bank, f"synthetic_{i}.npz"),
                            **synthetic_avatar(seed=i))
