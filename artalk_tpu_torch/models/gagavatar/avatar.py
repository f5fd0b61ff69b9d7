"""GAGAvatar: one-shot gaussian-splat head avatar (engine-facing wrapper).

Counterpart of ``artalk_tpu/models/gagavatar/avatar.py`` (reference:
app/GAGAvatar/models.py:16-138). On avatar selection the source image is
encoded once (DINOv2 + DPT -> global and dense features -> gaussian
generators) and cached; per frame only the 5023 FLAME-vertex gaussians are
re-posed, the head rotation is folded into the camera
(``transform_emoca_to_p3d``), the 32-channel splat (``ops/gsplat.py``, a CUDA
kernel on the card) is super-resolved by StyleUNet, clipped, watermarked and
packed to uint8 on the device, one 25-frame chunk at a time.

``render_motion_sequence`` records spans (``utils/metrics.GLOBAL_METRICS``;
each times the host): ``gaga.avatar`` once a call (selecting the avatar and
its encode, which a new avatar id repeats), per chunk ``gaga.prep`` (FLAME,
the forehead EMA, the cameras) and ``gaga.download`` (yuv420 or uint8, the
copy to the host, which waits for the device), and per frame ``gaga.splat``
and ``gaga.upsample`` (StyleUNet, clip, watermark).

Precision, read from the environment at construction as in JAX:
``ARTALK_GAGA_PRECISION=fast`` (default: bf16 StyleUNet and bf16 splat
colors, both feeding 8-bit video) or ``exact`` (float32 throughout).
Construction turns TF32 off, as the engine does.

Not ported: the JAX package's static splat-instance budget (its
``_instance_budget`` / ``_select_budget`` / ``_check_instance_budget`` and
``ARTALK_GSPLAT_MAX_INSTANCES``). The prepass counts instances per frame, so
every frame takes the JAX package's exact (unbudgeted) path.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ...ops.colorspace import rgb_to_yuv420p
from ...ops.gsplat import rasterize_gaussians
from ...ops.resize2d import resize_antialias
from ...utils.assets import ensure_synthetic_avatars
from ...utils.metrics import GLOBAL_METRICS
from ...utils.params import gagavatar_from_flat, load_params_npz
from ..nn import full_float32
from .dino import DinoDPT
from .generators import (ConvGSGenerator, LinearGSGenerator, build_points_planes,
                         harmonic_embedding, transform_emoca_to_p3d)
from .style_unet import StyleUNet
from .watermark import apply_watermark, load_watermark

# FLAME forehead vertex indices smoothed with an EMA (models.py:326-331)
FOREHEAD_INDICES = np.array([
    2168, 2165, 3068, 2199, 2196, 3720, 2091, 2088, 3524, 625, 628, 3871, 705,
    708, 2030, 667, 670, 3708, 3706, 3729, 3721, 3773, 3789, 3735, 3732, 3786,
    3876, 3878, 3913, 3899, 3872, 3874, 3864, 3865, 3158, 3157, 336, 335, 3153,
    3705, 2177, 2176, 3540, 671, 672, 3863, 2134, 16, 17, 2138, 2139, 2567,
    2566, 337, 338, 3154, 3712, 2178, 2179, 3495, 674, 673, 3868, 2135, 27, 18,
    1429, 1430,
], dtype=np.int64)

NUM_FLAME_VERTS = 5023
PLANE_SIZE = 296
CAM_PARAMS = {"focal": 12.0, "size": 512}


def resolve_precision() -> bool:
    """Whether the SR and the splat colors run in bf16: ``ARTALK_GAGA_PRECISION``
    is ``fast`` (the default) or ``exact``."""
    precision = os.environ.get("ARTALK_GAGA_PRECISION", "fast")
    if precision not in ("fast", "exact"):
        raise ValueError(f"ARTALK_GAGA_PRECISION={precision!r}: expected 'fast' or 'exact'")
    return precision == "fast"


def prep_frame_chunk(flame_model, shapecode: torch.Tensor, base_transform: torch.Tensor,
                     motions_k: torch.Tensor, carry: torch.Tensor, is_first: bool,
                     valid: int):
    """FLAME, forehead EMA and camera for a K-frame chunk (models.py:98-128).

    motions_k: (K, 106). carry: (F, 3) forehead EMA state; with ``is_first``
    the EMA seeds from frame 0 instead. Frames from ``valid`` on are computed
    but leave the carry untouched (clip padding must not leak into the state
    carried across calls).

    Returns (t_points (K, 5023, 3), cams (K, 3, 4), carry_out (F, 3))."""
    k = motions_k.shape[0]
    jaw = torch.cat([motions_k.new_zeros((k, 3)), motions_k[:, 103:106]], dim=-1)
    # (K, V, 3), a fresh tensor: the forehead rows are overwritten in place
    t_points = flame_model(shapecode.expand(k, -1), motions_k[:, :100], jaw)
    idx = torch.as_tensor(FOREHEAD_INDICES, device=t_points.device)
    cur = t_points[:, idx]
    state = cur[0] if is_first else carry
    smoothed = []
    for i in range(k):
        if i < valid:
            state = 0.98 * state + 0.02 * cur[i]
        smoothed.append(state)
    t_points[:, idx] = torch.stack(smoothed)
    # head rotation folded into the camera; translation from the avatar's
    # base transform (models.py:127, :255-264)
    cams = transform_emoca_to_p3d(motions_k[:, 100:103])
    cams = torch.cat([cams[:, :, :3], base_transform[None, :, 3:4].expand(k, 3, 1)], dim=-1)
    return t_points, cams, state


class GAGAvatarNets(nn.Module):
    """The networks of the JAX ``GAGAvatar.init`` tree, named as its keys."""

    def __init__(self):
        super().__init__()
        self.base_model = DinoDPT(output_dim=256)
        self.head_base = nn.Parameter(torch.empty(NUM_FLAME_VERTS, 256))
        self.gs_generator_g = LinearGSGenerator(in_dim=1024, dir_dim=27)
        self.gs_generator_l0 = ConvGSGenerator(in_dim=256, dir_dim=27)
        self.gs_generator_l1 = ConvGSGenerator(in_dim=256, dir_dim=27)
        self.upsampler = StyleUNet(in_size=512, out_size=512, in_dim=32, out_dim=3)

    def init(self, gen: torch.Generator) -> "GAGAvatarNets":
        """Random weights from the JAX init's distributions."""
        self.base_model.init(gen)
        self.head_base.data.normal_(generator=gen)
        for m in (self.gs_generator_g, self.gs_generator_l0, self.gs_generator_l1,
                  self.upsampler):
            m.init(gen)
        return self


class GAGAvatar:
    def __init__(self, assets_dir: str = "assets",
                 params: Optional[Dict[str, np.ndarray]] = None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        """``params`` is a flat ``//``-keyed JAX ``GAGAvatar.init`` tree; without
        it ``<assets_dir>/gagavatar_params.npz`` is loaded when present, else the
        weights are random from ``seed``."""
        full_float32()
        self.assets_dir = assets_dir
        self.device = torch.device(device)
        self.bf16 = resolve_precision()

        if params is None:
            ckpt = os.path.join(assets_dir, "gagavatar_params.npz")
            if os.path.exists(ckpt):
                params = load_params_npz(ckpt)
            else:
                print(f"[artalk_tpu_torch] no GAGAvatar checkpoint at {ckpt}; "
                      "initializing random weights")
        nets = (GAGAvatarNets().init(torch.Generator().manual_seed(seed)) if params is None
                else gagavatar_from_flat(params))
        self.nets = nets.to(self.device).requires_grad_(False)
        # the bf16 SR runs on a copy cast once here
        self._upsampler = (copy.deepcopy(self.nets.upsampler).to(torch.bfloat16)
                           if self.bf16 else self.nets.upsampler)

        self.all_gagavatar_id = self._load_avatar_bank()
        # logo watermark, blended into every frame when the asset exists
        self._watermark = load_watermark(assets_dir, self.device)
        self._tracked: Optional[Dict[str, np.ndarray]] = None
        self._gs_params: Optional[Dict[str, torch.Tensor]] = None
        self._feature_cache: Optional[Dict[str, torch.Tensor]] = None
        self._upper_points: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ avatar bank

    def _load_avatar_bank(self) -> Dict[str, str]:
        """Map avatar id -> npz path (converted from the reference's
        tracked.pt, or synthetic)."""
        ensure_synthetic_avatars(self.assets_dir)
        bank_dir = os.path.join(self.assets_dir, "avatars")
        return {os.path.splitext(f)[0]: os.path.join(bank_dir, f)
                for f in sorted(os.listdir(bank_dir)) if f.endswith(".npz")}

    def set_avatar_id(self, avatar_id: str) -> None:
        path = self.all_gagavatar_id.get(avatar_id)
        if path is None:
            raise KeyError(
                f"unknown avatar {avatar_id!r}; available: {sorted(self.all_gagavatar_id)}")
        with np.load(path) as z:
            self._tracked = {k: z[k].astype(np.float32) for k in z.files}
        self._gs_params = None
        self._feature_cache = None
        self._upper_points = None

    # ------------------------------------------------------------- build once

    @torch.no_grad()
    def _gs_params_compute(self, image: torch.Tensor, plane_dirs: torch.Tensor,
                           plane_points: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The one-time avatar encode (models.py:65-87)."""
        nets = self.nets
        f_feature0, f_feature1 = nets.base_model(resize_antialias(image, 518, 518))
        direnc = harmonic_embedding(plane_dirs)
        head = torch.cat([
            nets.head_base[None].expand(1, NUM_FLAME_VERTS, -1),
            f_feature1[:, None].expand(1, NUM_FLAME_VERTS, f_feature1.shape[-1]),
        ], dim=-1)
        gs_g = nets.gs_generator_g(head, direnc)
        gs_g["xyz"] = head.new_zeros((1, NUM_FLAME_VERTS, 3))
        gs_l0 = nets.gs_generator_l0(f_feature0, direnc)
        gs_l1 = nets.gs_generator_l1(f_feature0, direnc)
        gs_l0["xyz"] = plane_points + gs_l0.pop("positions") * plane_dirs[:, None]
        gs_l1["xyz"] = plane_points - gs_l1.pop("positions") * plane_dirs[:, None]
        return {k: torch.cat([gs_g[k], gs_l0[k], gs_l1[k]], dim=1) for k in gs_g}

    def _build_gs_params(self) -> None:
        """Encode the source image once -> cached gaussian parameters."""
        tracked = self._tracked
        if tracked is None:
            raise RuntimeError("call set_avatar_id first")
        dev = self.device
        transform = tracked["transform_matrix"]
        planes = build_points_planes(PLANE_SIZE, transform)
        self._gs_params = self._gs_params_compute(
            torch.from_numpy(tracked["image"])[None].to(dev),
            torch.from_numpy(planes["plane_dirs"])[None].to(dev),
            torch.from_numpy(planes["plane_points"])[None].to(dev))
        self._feature_cache = {
            "transform": torch.from_numpy(transform[:3]).to(dev),
            "shapecode": torch.from_numpy(tracked["shapecode"]).reshape(1, -1).to(dev),
        }

    # -------------------------------------------------------------- per frame

    @torch.no_grad()
    def _frame(self, t_points: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
        """Re-posed gaussians -> splat -> SR -> clip -> watermark: (1, 3, S, S)."""
        gs = self._gs_params
        with GLOBAL_METRICS.span("gaga.splat"):
            xyz = torch.cat([t_points, gs["xyz"][0, NUM_FLAME_VERTS:]])
            render = rasterize_gaussians(
                xyz, gs["colors"][0], gs["opacities"][0], gs["scales"][0], gs["rotations"][0],
                cam, focal=CAM_PARAMS["focal"], size=CAM_PARAMS["size"],
                bf16_colors=self.bf16)
        with GLOBAL_METRICS.span("gaga.upsample"):
            sr = self._upsampler(render[None],
                                 compute_dtype=torch.bfloat16 if self.bf16 else None)
            return apply_watermark(torch.clamp(sr, 0.0, 1.0), self._watermark)

    def _ensure_avatar(self) -> None:
        if self._tracked is None:
            self.set_avatar_id(sorted(self.all_gagavatar_id)[0])
        if self._gs_params is None:
            self._build_gs_params()

    @torch.no_grad()
    def build_forward_batch(self, motion: torch.Tensor, flame_model) -> Dict[str, torch.Tensor]:
        """(1, 106) motion -> dict for ``forward_expression`` (models.py:98-128).

        flame_model: a FlameModel with scale=5.0 (the GAGAvatar world scale)."""
        self._ensure_avatar()
        cache = self._feature_cache
        jaw = torch.cat([motion.new_zeros((1, 3)), motion[:, 103:106]], dim=-1)
        t_points = flame_model(cache["shapecode"], motion[:, :100], jaw)
        idx = torch.as_tensor(FOREHEAD_INDICES, device=t_points.device)
        current = t_points[:, idx]
        if self._upper_points is None:
            self._upper_points = current
        else:
            self._upper_points = 0.98 * self._upper_points + 0.02 * current
            t_points[:, idx] = self._upper_points
        cam = transform_emoca_to_p3d(motion[:, 100:103])[0]
        cam = torch.cat([cam[:, :3], cache["transform"][:, 3:4]], dim=-1)
        return {"t_points": t_points, "t_transform": cam}

    def forward_expression(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One frame: re-posed gaussians -> splat -> SR (models.py:64-95)."""
        self._ensure_avatar()
        return self._frame(batch["t_points"][0], batch["t_transform"])

    # ------------------------------------------------------------- per chunk

    @torch.no_grad()
    def render_motion_sequence(self, avatar_id: Optional[str],
                               motions: Union[np.ndarray, torch.Tensor], flame_model,
                               transfer_chunk: int = 25, colorspace: str = "rgb") -> np.ndarray:
        """(T, 106) motions -> uint8 frames: (T, S, S, 3) RGB, or (T, 3S/2, S)
        yuv420p planes when ``colorspace == "yuv420"``.

        A non-empty ``avatar_id`` selects that avatar and restarts the forehead
        EMA; ``None`` or "" continues the current avatar's EMA from the last
        call. Frames go ``transfer_chunk`` at a time: FLAME batched over the
        chunk, then one splat and one SR per frame, and the chunk leaves the
        card as uint8. As in the JAX package the last chunk is padded with the
        last motion, so FLAME always runs at one batch size, and the padding
        leaves the EMA carry alone; the padded frames are not rendered (JAX
        renders and drops them)."""
        with GLOBAL_METRICS.span("gaga.avatar"):
            if self._tracked is None or avatar_id not in (None, ""):
                self.set_avatar_id(avatar_id)
            self._ensure_avatar()
        motions = torch.as_tensor(motions, dtype=torch.float32).to(self.device)
        t_total = motions.shape[0]
        pad = (-t_total) % transfer_chunk
        if pad:
            motions = torch.cat([motions, motions[-1:].expand(pad, -1)])
        first = self._upper_points is None
        carry = (motions.new_zeros((len(FOREHEAD_INDICES), 3)) if first
                 else self._upper_points[0])
        cache = self._feature_cache
        outs = []
        for i in range(0, motions.shape[0], transfer_chunk):
            valid = min(transfer_chunk, t_total - i)
            with GLOBAL_METRICS.span("gaga.prep"):
                t_points, cams, carry = prep_frame_chunk(
                    flame_model, cache["shapecode"], cache["transform"],
                    motions[i:i + transfer_chunk], carry, first, valid)
            first = False
            sr = torch.cat([self._frame(tp, cam)
                            for tp, cam in zip(t_points[:valid], cams[:valid])])
            with GLOBAL_METRICS.span("gaga.download"):
                if colorspace == "yuv420":
                    frames = rgb_to_yuv420p(sr, channel_axis=1)
                else:
                    frames = torch.clamp(sr.permute(0, 2, 3, 1) * 255.0, 0.0,
                                         255.0).to(torch.uint8)
                outs.append(frames.cpu().numpy())
        self._upper_points = carry[None]
        return np.concatenate(outs, axis=0)
