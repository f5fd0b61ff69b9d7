"""DINOv2 ViT-B/14 backbone + DPT feature pyramid.

Counterpart of ``artalk_tpu/models/gagavatar/dino.py`` (reference:
app/GAGAvatar/modules/dino_base.py:8-87): a DINOv2 vision transformer whose
last four blocks feed a DPT-style pyramid (1x1 projections, resize layers,
image concat, fusion blocks) producing a dense 256-channel map plus a global
token. The blocks are stacked along a leading depth axis as in the JAX tree
(``blocks//qkv//w`` is ``(depth, d, 3d)``).

Kept quirk: torch-hub ``get_intermediate_layers`` strips the CLS token, so
the reference's "global" feature (dino_base.py:86) is the first *patch*
token of the last layer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize2d import resize_antialias, resize_bilinear
from .. import nn as tnn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    patch_size: int = 14
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    image_size: int = 518           # pos embed pretrained at 37x37 patches
    layer_norm_eps: float = 1e-6


class _Blocks(nn.Module):
    """The ``depth`` pre-LN ViT blocks with LayerScale, parameters stacked."""

    def __init__(self, cfg: DinoConfig):
        super().__init__()
        d, depth = cfg.hidden_size, cfg.depth
        hidden = int(d * cfg.mlp_ratio)
        eps = cfg.layer_norm_eps
        self.norm1 = tnn.LayerNorm(d, eps, stack=(depth,))
        self.qkv = tnn.Linear(d, 3 * d, stack=(depth,))
        self.proj = tnn.Linear(d, d, stack=(depth,))
        self.ls1 = nn.Parameter(torch.ones(depth, d))
        self.norm2 = tnn.LayerNorm(d, eps, stack=(depth,))
        self.fc1 = tnn.Linear(d, hidden, stack=(depth,))
        self.fc2 = tnn.Linear(hidden, d, stack=(depth,))
        self.ls2 = nn.Parameter(torch.ones(depth, d))


class DinoViT(nn.Module):
    def __init__(self, cfg: DinoConfig = DinoConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        num_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = tnn.Conv2d(3, d, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, num_patches + 1, d))
        self.blocks = _Blocks(cfg)
        self.norm = tnn.LayerNorm(d, cfg.layer_norm_eps)

    def init(self, gen: torch.Generator) -> "DinoViT":
        b = self.blocks
        for i in range(self.cfg.depth):
            for lin in (b.qkv, b.proj, b.fc1, b.fc2):
                tnn.kaiming_uniform(lin.w.data[i], lin.in_dim, gen)
                tnn.uniform_init(lin.b.data[i], lin.in_dim ** -0.5, gen)
        self.patch_embed.init(gen)
        tnn.trunc_normal(self.pos_embed.data, gen, std=0.02)
        return self

    def _embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 1 + N, d) with cls + pos embeddings."""
        pe = self.patch_embed
        with tnn.no_tf32():
            x = F.conv2d(images, pe.w, stride=self.cfg.patch_size)
        b, d, gh, gw = x.shape
        x = x.reshape(b, d, gh * gw).transpose(1, 2) + pe.b
        x = torch.cat([self.cls_token.expand(b, 1, d), x], dim=1)
        return x + self.pos_embed

    def _block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        p = self.blocks
        h = p.norm1(x, i)
        q, k, v = p.qkv(h, i).chunk(3, dim=-1)
        q, k, v = (tnn.split_heads(t, self.cfg.num_heads) for t in (q, k, v))
        attn = tnn.merge_heads(tnn.sdpa(q, k, v, scale=q.shape[-1] ** -0.5))
        x = x + p.proj(attn, i) * p.ls1[i]
        h = p.norm2(x, i)
        return x + p.fc2(tnn.gelu_erf(p.fc1(h, i)), i) * p.ls2[i]

    def intermediate_layers(self, images: torch.Tensor, n: int = 4) -> List[torch.Tensor]:
        """Last-n block outputs, final norm applied, CLS stripped
        (torch-hub get_intermediate_layers(norm=True) semantics)."""
        x = self._embed(images)
        outs = []
        for i in range(self.cfg.depth):
            x = self._block(i, x)
            if i >= self.cfg.depth - n:
                outs.append(x)
        return [self.norm(o)[:, 1:] for o in outs]


class _Residual(nn.Module):
    def __init__(self, hid: int):
        super().__init__()
        self.conv1 = tnn.Conv2d(hid, hid, 3)
        self.conv2 = tnn.Conv2d(hid, hid, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(torch.relu(x), padding=1)
        return self.conv2(torch.relu(out), padding=1) + x


class _Fusion(nn.Module):
    def __init__(self, hid: int):
        super().__init__()
        self.res1 = _Residual(hid)
        self.res2 = _Residual(hid)
        self.out = tnn.Conv2d(hid, hid, 1)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.res1(skip)
        x = self.res2(x)
        if size is None:
            size = (x.shape[-2] * 2, x.shape[-1] * 2)
        x = resize_bilinear(x, size[0], size[1], align_corners=True)
        return self.out(x)


class DinoDPT(nn.Module):
    """DINOBase: DINOv2 + DPT pyramid -> (dense 256-ch map, global token)."""

    OUT_DIMS = (256, 512, 1024, 1024)
    HIDDEN = 256

    def __init__(self, output_dim: int = 256, dino_cfg: DinoConfig = DinoConfig()):
        super().__init__()
        self.dino = DinoViT(dino_cfg)
        d, hid = dino_cfg.hidden_size, self.HIDDEN
        od = self.OUT_DIMS
        self.projects = nn.ModuleList(tnn.Conv2d(d, o, 1) for o in od)
        # torch ConvTranspose2d weights, (in, out, k, k): in == out here
        self.resize0 = tnn.Conv2d(od[0], od[0], 4)
        self.resize1 = tnn.Conv2d(od[1], od[1], 2)
        self.resize3 = tnn.Conv2d(od[3], od[3], 3)
        self.layer_rn = nn.ModuleList(tnn.Conv2d(o + 3, hid, 3, bias=False) for o in od)
        self.refine = nn.ModuleList(_Fusion(hid) for _ in range(4))
        self.output_conv = tnn.Conv2d(hid, output_dim, 3)

    def init(self, gen: torch.Generator) -> "DinoDPT":
        self.dino.init(gen)
        for m in self.modules():
            if isinstance(m, tnn.Conv2d) and m is not self.dino.patch_embed:
                m.init(gen)
        return self

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3, 518, 518) in [0, 1] -> (dense (B, 256, H, W), global (B, d))."""
        mean = images.new_tensor(IMAGENET_MEAN)[None, :, None, None]
        std = images.new_tensor(IMAGENET_STD)[None, :, None, None]
        normed = (images - mean) / std
        ph = images.shape[-2] // self.dino.cfg.patch_size
        pw = images.shape[-1] // self.dino.cfg.patch_size

        feats = self.dino.intermediate_layers(normed, n=4)
        out_feats = []
        for i, f in enumerate(feats):
            b, _, d = f.shape
            fmap = self.projects[i](f.transpose(1, 2).reshape(b, d, ph, pw))
            if i == 0:
                with tnn.no_tf32():
                    fmap = F.conv_transpose2d(fmap, self.resize0.w, self.resize0.b, stride=4)
            elif i == 1:
                with tnn.no_tf32():
                    fmap = F.conv_transpose2d(fmap, self.resize1.w, self.resize1.b, stride=2)
            elif i == 3:
                fmap = self.resize3(fmap, stride=2, padding=1)
            img_small = resize_antialias(normed, fmap.shape[-2], fmap.shape[-1])
            out_feats.append(self.layer_rn[i](torch.cat([img_small, fmap], dim=1), padding=1))

        r = self.refine
        path4 = r[0](out_feats[3], size=out_feats[2].shape[-2:])
        path3 = r[1](path4, out_feats[2], size=out_feats[1].shape[-2:])
        path2 = r[2](path3, out_feats[1], size=out_feats[0].shape[-2:])
        path1 = r[3](path2, out_feats[0])
        dense = self.output_conv(path1, padding=1)
        # reference quirk: "global" = first *patch* token of the last layer
        return dense, feats[-1][:, 0]
