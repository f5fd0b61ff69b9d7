"""BT.601 full-range RGB -> planar YUV 4:2:0 on the device.

Counterpart of ``artalk_tpu/ops/colorspace.py``: uint8 quantization first
(what the RGB path would ship), 2x2 block mean for chroma, round half up with
clamp. Frames leave the card as yuv420p, half the bytes of RGB.
"""

from __future__ import annotations

import torch


def _quant_u8(v: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 255] then round half up."""
    return torch.floor(torch.clamp(v, 0.0, 255.0) + 0.5).to(torch.uint8)


def rgb_to_yuv420p(rgb: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
    """float RGB in [0, 1] -> uint8 (T, H * 3 // 2, W) yuv420p planes.

    rgb: (T, 3, H, W) when channel_axis is 1, or (T, H, W, 3) when -1. Rows
    [0, H) are Y, then U then V at quarter resolution (H % 4 == 0)."""
    x = rgb.permute(0, 2, 3, 1) if channel_axis in (1, -3) else rgb
    t, h, w, _ = x.shape
    assert h % 4 == 0 and w % 2 == 0, (h, w)
    q = torch.floor(torch.clamp(x * 255.0, 0.0, 255.0))
    r, g, b = q[..., 0], q[..., 1], q[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    blocks = 0.25 * (q[:, 0::2, 0::2] + q[:, 0::2, 1::2]
                     + q[:, 1::2, 0::2] + q[:, 1::2, 1::2])
    rb, gb, bb = blocks[..., 0], blocks[..., 1], blocks[..., 2]
    u = -0.168736 * rb - 0.331264 * gb + 0.5 * bb + 128.0
    v = 0.5 * rb - 0.418688 * gb - 0.081312 * bb + 128.0
    return torch.cat([_quant_u8(y), _quant_u8(u).reshape(t, h // 4, w),
                      _quant_u8(v).reshape(t, h // 4, w)], dim=1)
