"""GAGAvatar watermark overlay.

Counterpart of ``artalk_tpu/models/gagavatar/watermark.py`` (reference:
app/GAGAvatar/models.py:37-47 load, :95 apply, :131-138 blend): an RGBA logo
is resized to 82x256 once at load time and alpha-blended at 0.8 strength into
the bottom-right corner of every rendered frame, on the device.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ...ops.resize2d import resize_antialias

WATERMARK_SIZE = (82, 256)


def load_watermark(assets_dir: str, device: Union[str, torch.device] = "cpu"
                   ) -> Optional[torch.Tensor]:
    """RGBA (4, 82, 256) float32 in [0, 1] on ``device``, or None when no logo
    asset exists.

    Accepts the reference asset layout (``GAGAvatar/gagavatar_logo.png``,
    read with PIL) or a converted ``gagavatar_logo.npz`` holding an ``rgba``
    (4, H, W) float array.
    """
    png = os.path.join(assets_dir, "GAGAvatar", "gagavatar_logo.png")
    npz = os.path.join(assets_dir, "gagavatar_logo.npz")
    if os.path.exists(png):
        from PIL import Image

        with Image.open(png) as img:
            arr = np.asarray(img.convert("RGBA"), np.float32).transpose(2, 0, 1) / 255.0
    elif os.path.exists(npz):
        with np.load(npz) as z:
            arr = np.asarray(z["rgba"], np.float32)
        if arr.ndim != 3 or arr.shape[0] != 4:
            raise ValueError(f"{npz}: rgba must be (4, H, W), got {arr.shape}")
    else:
        return None
    mark = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return resize_antialias(mark, *WATERMARK_SIZE)


def apply_watermark(image: torch.Tensor, mark: Optional[torch.Tensor]) -> torch.Tensor:
    """Alpha-blend ``mark`` (4, h, w) into the bottom-right corner of
    (..., 3, H, W) frames at 0.8 strength; returns a new tensor. No-op when
    ``mark`` is None (logo asset absent)."""
    if mark is None:
        return image
    # frames smaller than the logo keep only its bottom-right crop
    h = min(mark.shape[-2], image.shape[-2])
    w = min(mark.shape[-1], image.shape[-1])
    mark = mark[..., -h:, -w:]
    alpha = mark[3:4] * 0.8
    out = image.clone()
    out[..., -h:, -w:] = image[..., -h:, -w:] * (1.0 - alpha) + mark[:3] * alpha
    return out
