"""Plain PyTorch reference of the GAGAvatar renderer (Chu & Harada, NeurIPS
2024, arXiv:2410.07971) as ARTalk drives it: the one-shot avatar encode
(DINOv2 ViT-B/14 with a DPT pyramid, the global and the two local gaussian
generators over the FLAME vertices and the camera-ray planes), then per
frame FLAME at GAGAvatar's world scale with the forehead EMA, the head
rotation folded into the camera, the EWA projection and front-to-back
32-channel splat, the 512x512 StyleUNet super-resolution, and yuv420.

A frozen plain path: the modules keep the checkpoint's parameter names, so
the benchmark hands the same flat dict to the program and here; the sort is
``torch.sort``, the compositing a loop over tiles. Everything is float32.
``Lowp.on`` rounds every convolution's inputs and weights of the StyleUNet to
fp8 (e4m3, one scale per tensor) and its splat colors too: the control one
step below the program's bfloat16 super-resolution and colors.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .mesh import rgb_to_yuv420, rodrigues

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FOREHEAD = np.array([
    2168, 2165, 3068, 2199, 2196, 3720, 2091, 2088, 3524, 625, 628, 3871, 705,
    708, 2030, 667, 670, 3708, 3706, 3729, 3721, 3773, 3789, 3735, 3732, 3786,
    3876, 3878, 3913, 3899, 3872, 3874, 3864, 3865, 3158, 3157, 336, 335, 3153,
    3705, 2177, 2176, 3540, 671, 672, 3863, 2134, 16, 17, 2138, 2139, 2567,
    2566, 337, 338, 3154, 3712, 2178, 2179, 3495, 674, 673, 3868, 2135, 27, 18,
    1429, 1430], dtype=np.int64)
NUM_VERTS = 5023
PLANE_SIZE = 296
FOCAL, SIZE = 12.0, 512
UNET_CH = {4: 256, 8: 256, 16: 256, 32: 256, 64: 128, 128: 64, 256: 32, 512: 16, 1024: 8}
GAN_CH = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64, 512: 32, 1024: 16}
TILE_H, TILE_W, DUP_X, DUP_Y = 16, 128, 2, 4
ALPHA_EPS, T_EPS = 1.0 / 255.0, 1e-4


def synthetic_avatar(seed: int = 0, size: int = 512) -> Dict[str, np.ndarray]:
    """A tracked-avatar entry (image, camera, shape code) in the schema of
    GAGAvatar's tracked.pt: a soft face-coloured blob on noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    blob = np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.05)
    base = np.stack([0.5 + 0.3 * blob, 0.4 + 0.25 * blob, 0.35 + 0.2 * blob])
    image = np.clip(base + rng.normal(0, 0.02, base.shape).astype(np.float32), 0, 1)
    transform = np.array([[-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 5000.0 / 512]], np.float32)
    shapecode = (rng.standard_normal(300) * 0.3).astype(np.float32)
    return {"image": image.astype(np.float32), "transform_matrix": transform,
            "shapecode": shapecode}


# ------------------------------------------------------------------ helpers

class Lowp:
    """Whether the StyleUNet's convolutions and the splat colors are rounded
    to fp8 (the control)."""

    on = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    if not Lowp.on:
        return t
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


@functools.lru_cache(maxsize=None)
def _lin_np(n_in: int, n_out: int, align: bool) -> np.ndarray:
    m = np.zeros((n_out, n_in))
    for j in range(n_out):
        if align:
            pos = 0.0 if n_out == 1 else j * (n_in - 1) / (n_out - 1)
        else:
            pos = min(max((j + 0.5) * n_in / n_out - 0.5, 0.0), n_in - 1.0)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n_in - 1)
        m[j, lo] += 1.0 - (pos - lo)
        m[j, hi] += pos - lo
    return m.astype(np.float32)


def bilinear(x: torch.Tensor, oh: int, ow: int, align: bool = False) -> torch.Tensor:
    """Bilinear resize of (..., H, W) as two separable matrix products."""
    h, w = x.shape[-2:]
    if (h, w) == (oh, ow):
        return x
    my = torch.from_numpy(_lin_np(h, oh, align)).to(x.device)
    mx = torch.from_numpy(_lin_np(w, ow, align)).to(x.device)
    return torch.matmul(torch.matmul(my, x), mx.T)


def antialias(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    lead = x.shape[:-2]
    out = F.interpolate(x.reshape((1, -1) + tuple(x.shape[-2:])), size=(oh, ow),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.reshape(lead + (oh, ow))


def l2n(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.sqrt(x.square().sum(dim=dim, keepdim=True)).clamp(min=1e-12)


def layer_norm(x, eps, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, stack: tuple = ()):
        super().__init__()
        self.w = nn.Parameter(torch.empty(*stack, cin, cout))
        self.b = nn.Parameter(torch.empty(*stack, cout))

    def forward(self, x, i=None):
        return torch.matmul(x, self.w if i is None else self.w[i]) + (
            self.b if i is None else self.b[i])


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float, stack: tuple = ()):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(*stack, d))
        self.bias = nn.Parameter(torch.empty(*stack, d))

    def forward(self, x, i=None):
        s, b = (self.scale, self.bias) if i is None else (self.scale[i], self.bias[i])
        return layer_norm(x, self.eps, s, b)


class Conv2d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, bias: bool = True, lowp: bool = False):
        super().__init__()
        self.lowp = lowp
        self.w = nn.Parameter(torch.empty(cout, cin, k, k))
        self.b = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x, stride: int = 1, padding: int = 0):
        if self.lowp:
            return F.conv2d(fp8(x), fp8(self.w), self.b, stride, padding)
        return F.conv2d(x, self.w, self.b, stride, padding)


# ------------------------------------------------------------- DINOv2 + DPT

class _Blocks(nn.Module):
    def __init__(self, d=768, depth=12, hidden=3072):
        super().__init__()
        s = (depth,)
        self.norm1 = LayerNorm(d, 1e-6, s)
        self.qkv = Linear(d, 3 * d, s)
        self.proj = Linear(d, d, s)
        self.ls1 = nn.Parameter(torch.empty(depth, d))
        self.norm2 = LayerNorm(d, 1e-6, s)
        self.fc1 = Linear(d, hidden, s)
        self.fc2 = Linear(hidden, d, s)
        self.ls2 = nn.Parameter(torch.empty(depth, d))


class DinoViT(nn.Module):
    def __init__(self, d=768, depth=12, heads=12, patch=14, image=518):
        super().__init__()
        self.d, self.depth, self.heads, self.patch = d, depth, heads, patch
        self.patch_embed = Conv2d(3, d, patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, (image // patch) ** 2 + 1, d))
        self.blocks = _Blocks(d, depth)
        self.norm = LayerNorm(d, 1e-6)

    def layers(self, images: torch.Tensor, n: int = 4) -> List[torch.Tensor]:
        """The last ``n`` blocks' outputs, normed, without the class token."""
        x = F.conv2d(images, self.patch_embed.w, stride=self.patch)
        b, d, gh, gw = x.shape
        x = x.reshape(b, d, gh * gw).transpose(1, 2) + self.patch_embed.b
        x = torch.cat([self.cls_token.expand(b, 1, d), x], 1) + self.pos_embed
        p, outs = self.blocks, []
        for i in range(self.depth):
            h = p.norm1(x, i)
            q, k, v = (t.reshape(b, -1, self.heads, d // self.heads).transpose(1, 2)
                       for t in p.qkv(h, i).chunk(3, -1))
            a = torch.softmax(q @ k.transpose(-1, -2) * (d // self.heads) ** -0.5, -1) @ v
            x = x + p.proj(a.transpose(1, 2).reshape(b, -1, d), i) * p.ls1[i]
            x = x + p.fc2(F.gelu(p.fc1(p.norm2(x, i), i)), i) * p.ls2[i]
            if i >= self.depth - n:
                outs.append(x)
        return [self.norm(o)[:, 1:] for o in outs]


class _Residual(nn.Module):
    def __init__(self, hid):
        super().__init__()
        self.conv1, self.conv2 = Conv2d(hid, hid, 3), Conv2d(hid, hid, 3)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(torch.relu(x), padding=1)), padding=1) + x


class _Fusion(nn.Module):
    def __init__(self, hid):
        super().__init__()
        self.res1, self.res2, self.out = _Residual(hid), _Residual(hid), Conv2d(hid, hid, 1)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.res1(skip)
        x = self.res2(x)
        size = size or (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out(bilinear(x, size[0], size[1], align=True))


class DinoDPT(nn.Module):
    DIMS = (256, 512, 1024, 1024)

    def __init__(self, out_dim=256, hid=256):
        super().__init__()
        self.dino = DinoViT()
        od = self.DIMS
        self.projects = nn.ModuleList(Conv2d(768, o, 1) for o in od)
        self.resize0, self.resize1 = Conv2d(od[0], od[0], 4), Conv2d(od[1], od[1], 2)
        self.resize3 = Conv2d(od[3], od[3], 3)
        self.layer_rn = nn.ModuleList(Conv2d(o + 3, hid, 3, bias=False) for o in od)
        self.refine = nn.ModuleList(_Fusion(hid) for _ in range(4))
        self.output_conv = Conv2d(hid, out_dim, 3)

    def forward(self, images):
        mean = images.new_tensor(IMAGENET_MEAN)[None, :, None, None]
        std = images.new_tensor(IMAGENET_STD)[None, :, None, None]
        normed = (images - mean) / std
        ph, pw = images.shape[-2] // 14, images.shape[-1] // 14
        feats = self.dino.layers(normed)
        outs = []
        for i, f in enumerate(feats):
            b, _, d = f.shape
            fm = self.projects[i](f.transpose(1, 2).reshape(b, d, ph, pw))
            if i == 0:
                fm = F.conv_transpose2d(fm, self.resize0.w, self.resize0.b, stride=4)
            elif i == 1:
                fm = F.conv_transpose2d(fm, self.resize1.w, self.resize1.b, stride=2)
            elif i == 3:
                fm = self.resize3(fm, stride=2, padding=1)
            small = antialias(normed, fm.shape[-2], fm.shape[-1])
            outs.append(self.layer_rn[i](torch.cat([small, fm], 1), padding=1))
        r = self.refine
        p4 = r[0](outs[3], size=outs[2].shape[-2:])
        p3 = r[1](p4, outs[2], size=outs[1].shape[-2:])
        p2 = r[2](p3, outs[1], size=outs[0].shape[-2:])
        return self.output_conv(r[3](p2, outs[0]), padding=1), feats[-1][:, 0]


# ------------------------------------------------------------ generators

def harmonic(x: torch.Tensor, n: int = 4) -> torch.Tensor:
    freqs = 2.0 ** torch.arange(n, dtype=torch.float32, device=x.device)
    flat = (x[..., :, None] * freqs).reshape(x.shape[:-1] + (x.shape[-1] * n,))
    return torch.cat([torch.sin(flat), torch.cos(flat), x], -1)


def _mlp(dims):
    return nn.ModuleList(Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1))


def _run(layers, x):
    for i, lin in enumerate(layers):
        x = lin(x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class LinearGS(nn.Module):
    def __init__(self, in_dim=1024, dir_dim=27):
        super().__init__()
        q = in_dim // 4
        self.features = _mlp([in_dim, q, q, q, q])
        self.color = _mlp([q + dir_dim, 128, 32])
        self.opacity = _mlp([q + dir_dim, 128, 1])
        self.scale = _mlp([q + dir_dim, 128, 3])
        self.rotation = _mlp([q + dir_dim, 128, 4])

    def forward(self, feat, direnc):
        feat = _run(self.features, feat)
        feat = torch.cat([feat, direnc[:, None].expand(feat.shape[0], feat.shape[1], -1)], -1)
        colors = _run(self.color, feat)
        return {"colors": torch.cat([torch.sigmoid(colors[..., :3]), colors[..., 3:]], -1),
                "opacities": torch.sigmoid(_run(self.opacity, feat)),
                "scales": torch.sigmoid(_run(self.scale, feat)) * 0.05,
                # GAGAvatar normalises (B, N, 4) over dim 1, the vertex axis
                "rotations": l2n(_run(self.rotation, feat), dim=1)}


class ConvGS(nn.Module):
    def __init__(self, in_dim=256, dir_dim=27):
        super().__init__()
        half = in_dim // 2
        self.conv1 = Conv2d(in_dim + dir_dim, half, 3)
        self.conv2, self.conv3 = Conv2d(half, half, 3), Conv2d(half, half, 3)
        self.conv4 = Conv2d(half, 41, 1)

    def forward(self, feat, direnc):
        b, _, h, w = feat.shape
        x = torch.cat([feat, direnc[:, :, None, None].expand(b, -1, h, w)], 1)
        for conv in (self.conv1, self.conv2, self.conv3):
            x = torch.relu(conv(x, padding=1))
        g = self.conv4(x)
        colors = g[:, :32]
        # GAGAvatar's colors[..., :3] on the NCHW map: the first 3 columns
        colors = torch.cat([torch.sigmoid(colors[..., :3]), colors[..., 3:]], -1)
        pts = lambda t: t.permute(0, 2, 3, 1).reshape(b, h * w, t.shape[1])
        return {"colors": pts(colors), "opacities": pts(torch.sigmoid(g[:, 32:33])),
                "scales": pts(torch.sigmoid(g[:, 33:36]) * 0.05),
                "rotations": l2n(pts(g[:, 36:40])), "positions": pts(torch.sigmoid(g[:, 40:41]))}


def planes(transform: np.ndarray):
    t = np.asarray(transform, np.float64)
    x, y = np.meshgrid(np.linspace(1, -1, PLANE_SIZE), np.linspace(1, -1, PLANE_SIZE))
    r, tr = t[:3, :3], t[:3, 3:]
    cam_dir = r @ np.array([0.0, 0.0, 1.0])
    ray = np.stack([x / 12.0, y / 12.0, np.ones_like(x)], -1).reshape(-1, 3) @ r.T
    origin = -(r @ tr)[:, 0]
    pts = origin[None] + abs(np.dot(origin, cam_dir)) * ray
    return pts.astype(np.float32), cam_dir.astype(np.float32)


def camera(rot: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """(K, 3) head rotations -> (K, 3, 4) cameras with the rotation folded in
    and the avatar's translation."""
    r = rot * rot.new_tensor([-1.0, 1.0, -1.0])
    flip = rot.new_tensor([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]])
    inv = torch.linalg.inv(rodrigues(r) @ flip)
    return torch.cat([inv, base[None, :, 3:4].expand(rot.shape[0], 3, 1)], -1)


# ---------------------------------------------------------------- StyleUNet

def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _resize2x(x, up):
    h, w = x.shape[-2:]
    return bilinear(x, *((h * 2, w * 2) if up else (h // 2, w // 2)))


class _Res(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv2d(cin, cin, 3, lowp=True)
        self.conv2 = Conv2d(cin, cout, 3, lowp=True)
        self.skip = Conv2d(cin, cout, 1, bias=False, lowp=True)

    def forward(self, x, up):
        out = _lrelu(self.conv2(_resize2x(_lrelu(self.conv1(x, padding=1)), up), padding=1))
        return out + self.skip(_resize2x(x, up))


class _Cond(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.c1, self.c2 = Conv2d(ch, ch, 3, lowp=True), Conv2d(ch, 2 * ch, 3, lowp=True)

    def forward(self, x):
        return self.c2(_lrelu(self.c1(x, padding=1)), padding=1)


class _ModConv(nn.Module):
    def __init__(self, style, cin, cout, k):
        super().__init__()
        self.modulation = Linear(style, cin)
        self.weight = nn.Parameter(torch.empty(1, cout, cin, k, k))

    def forward(self, x, style, demod=True, up=False):
        w = self.weight * self.modulation(style)[:, None, :, None, None]
        if demod:
            w = w * torch.rsqrt(w.square().sum((2, 3, 4)) + 1e-8)[:, :, None, None, None]
        if up:
            x = _resize2x(x, True)
        b, cout, cin, k, _ = w.shape
        h, wd = x.shape[-2:]
        out = F.conv2d(fp8(x.reshape(1, b * cin, h, wd)), fp8(w.reshape(b * cout, cin, k, k)),
                       padding=k // 2, groups=b)
        return out.reshape(b, cout, h, wd)


class _StyleConv(nn.Module):
    def __init__(self, style, cin, cout, k):
        super().__init__()
        self.mod = _ModConv(style, cin, cout, k)
        self.noise_weight = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(1, cout, 1, 1))

    def forward(self, x, style, noise, up=False):
        out = self.mod(x, style, True, up) * 2 ** 0.5 + self.noise_weight * noise
        return _lrelu(out + self.bias)


class _ToRGB(nn.Module):
    def __init__(self, style, cin, out_dim):
        super().__init__()
        self.mod = _ModConv(style, cin, out_dim, 1)
        self.bias = nn.Parameter(torch.empty(1, out_dim, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.mod(x, style, demod=False) + self.bias
        return out if skip is None else out + _resize2x(skip, True)


class StyleGAN2CSFT(nn.Module):
    def __init__(self, size=512, out_dim=3, style=512, n_mlp=8):
        super().__init__()
        self.log_size = int(math.log2(size))
        self.style_mlp = nn.ModuleList(Linear(style, style) for _ in range(n_mlp))
        self.constant_input = nn.Parameter(torch.empty(1, GAN_CH[4], 4, 4))
        self.conv1 = _StyleConv(style, GAN_CH[4], GAN_CH[4], 3)
        self.to_rgb1 = _ToRGB(style, GAN_CH[4], out_dim)
        convs, rgbs, cin = [], [], GAN_CH[4]
        for i in range(3, self.log_size + 1):
            cout = GAN_CH[2 ** i]
            convs += [_StyleConv(style, cin, cout, 3), _StyleConv(style, cout, cout, 3)]
            rgbs.append(_ToRGB(style, cout, out_dim))
            cin = cout
        self.convs, self.to_rgbs = nn.ModuleList(convs), nn.ModuleList(rgbs)
        self.noises = nn.ParameterList(
            nn.Parameter(torch.empty(1, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2)))
            for i in range((self.log_size - 2) * 2 + 1))

    def forward(self, style, conds):
        s = style * torch.rsqrt(style.square().mean(1, keepdim=True) + 1e-8)
        for lin in self.style_mlp:
            s = _lrelu(lin(s))
        out = self.conv1(self.constant_input.expand(style.shape[0], -1, -1, -1), s,
                         self.noises[0])
        skip = self.to_rgb1(out, s)
        i = 1
        for j, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * j](out, s, self.noises[2 * j + 1], up=True)
            if i < len(conds):
                out = out * conds[i - 1] + conds[i]
            out = self.convs[2 * j + 1](out, s, self.noises[2 * j + 2])
            skip = to_rgb(out, s, skip)
            i += 2
        return skip


class StyleUNet(nn.Module):
    def __init__(self, size=512, in_dim=32, out_dim=3, style=512):
        super().__init__()
        self.size, self.log_size = size, int(math.log2(size))
        ch = UNET_CH
        self.first = Conv2d(in_dim, ch[size], 1, lowp=True)
        down, cin = [], ch[size]
        for i in range(self.log_size, 2, -1):
            down.append(_Res(cin, ch[2 ** (i - 1)]))
            cin = ch[2 ** (i - 1)]
        self.down = nn.ModuleList(down)
        self.final_conv = Conv2d(ch[8], ch[4], 3, lowp=True)
        up, rgb, cs, csh, cin = [], [], [], [], ch[4]
        for i in range(3, self.log_size + 1):
            cout = ch[2 ** i]
            up.append(_Res(cin, cout))
            rgb.append(Conv2d(cout, 3, 1))
            cs.append(_Cond(cout))
            csh.append(_Cond(cout))
            cin = cout
        self.up, self.to_rgb = nn.ModuleList(up), nn.ModuleList(rgb)
        self.cond_scale, self.cond_shift = nn.ModuleList(cs), nn.ModuleList(csh)
        self.final_linear = Linear(ch[4] * 16, style)
        self.gan = StyleGAN2CSFT(size, out_dim, style)

    def forward(self, x):
        feat = _lrelu(self.first(x))
        skips = []
        for block in self.down:
            feat = block(feat, up=False)
            skips.insert(0, feat)
        feat = _lrelu(self.final_conv(feat, padding=1))
        style = self.final_linear(feat.reshape(feat.shape[0], -1))
        conds = []
        for i, block in enumerate(self.up):
            feat = block(feat + skips[i], up=True)
            conds += [self.cond_scale[i](feat), self.cond_shift[i](feat)]
        return torch.sigmoid(self.gan(style, conds))


class GAGAvatarNets(nn.Module):
    def __init__(self):
        super().__init__()
        self.base_model = DinoDPT()
        self.head_base = nn.Parameter(torch.empty(NUM_VERTS, 256))
        self.gs_generator_g = LinearGS()
        self.gs_generator_l0 = ConvGS()
        self.gs_generator_l1 = ConvGS()
        self.upsampler = StyleUNet()


def gaga_spec() -> list:
    """(key, shape, rule) of every GAGAvatar parameter, for ``make_params``:
    each weight uniform within its fan-in bound (a modulated conv's normal,
    scaled as StyleGAN2 scales it), LayerNorm and LayerScale 1, biases 0
    (a modulation's 1), the noise maps and the constant input normal."""
    with torch.device("meta"):
        nets = GAGAvatarNets()
    spec = []
    for key, t in nets.state_dict().items():
        shape, leaf = tuple(t.shape), key.split(".")[-1]
        parent = key.rsplit(".", 1)[0]
        if ".noises." in key or key.endswith("constant_input") or key.endswith("head_base"):
            rule = ("normal", 1.0)
        elif leaf == "weight":                       # modulated conv (1, cout, cin, k, k)
            rule = ("normal", 1.0 / math.sqrt(shape[2] * shape[3] * shape[4]))
        elif leaf in ("ls1", "ls2") or (leaf == "scale" and "norm" in parent):
            rule = ("const", 1.0)
        elif leaf in ("noise_weight", "bias") or key.endswith("cls_token"):
            rule = ("const", 0.0)
        elif key.endswith("pos_embed"):
            rule = ("normal", 0.02)
        elif leaf == "b":
            rule = ("const", 1.0) if parent.endswith("modulation") else ("const", 0.0)
        elif leaf == "w":
            fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[-2]
            rule = ("uniform", 1.0 / math.sqrt(fan_in))
        else:
            raise ValueError(f"no rule for {key}")
        spec.append((key.replace(".", "//"), shape, rule))
    return spec


# ------------------------------------------------------------------ splat

def project(xyz, scales, rots, cam):
    """EWA projection: pixel means, depth, conics, radii, in-front mask."""
    r, t = cam[:3, :3], cam[:3, 3]
    flip = (-1.0, -1.0, 1.0)
    pv = [(xyz[:, 0] * r[0, i] + xyz[:, 1] * r[1, i] + xyz[:, 2] * r[2, i] + t[i]) * flip[i]
          for i in range(3)]
    depth = pv[2]
    fpix = FOCAL * SIZE / 2.0
    zs = depth.clamp(min=0.01)
    mx = (FOCAL * pv[0] / zs + 1.0) * (SIZE / 2.0)
    my = (FOCAL * pv[1] / zs + 1.0) * (SIZE / 2.0)
    w, qx, qy, qz = rots.unbind(-1)
    rot = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - w * qz), 2 * (qx * qz + w * qy)],
           [2 * (qx * qy + w * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - w * qx)],
           [2 * (qx * qz - w * qy), 2 * (qy * qz + w * qx), 1 - 2 * (qx * qx + qy * qy)]]
    s = scales.unbind(-1)
    m = [[rot[i][j] * s[j] for j in range(3)] for i in range(3)]
    cov = {(i, j): m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]
           for i in range(3) for j in range(3) if i <= j}
    lim = 1.3 / FOCAL
    txz = (pv[0] / zs).clamp(-lim, lim) * zs
    tyz = (pv[1] / zs).clamp(-lim, lim) * zs
    j00, j02, j12 = fpix / zs, -fpix * txz / (zs * zs), -fpix * tyz / (zs * zs)
    wr = [[r[k, c] * flip[c] for c in range(3)] for k in range(3)]
    a = [j00 * wr[0][k] + j02 * wr[2][k] for k in range(3)]
    b = [j00 * wr[1][k] + j12 * wr[2][k] for k in range(3)]

    def quad(u, v):
        return (u[0] * v[0] * cov[(0, 0)] + u[1] * v[1] * cov[(1, 1)] + u[2] * v[2] * cov[(2, 2)]
                + (u[0] * v[1] + u[1] * v[0]) * cov[(0, 1)]
                + (u[0] * v[2] + u[2] * v[0]) * cov[(0, 2)]
                + (u[1] * v[2] + u[2] * v[1]) * cov[(1, 2)])

    c00, c01, c11 = quad(a, a) + 0.3, quad(a, b), quad(b, b) + 0.3
    det = (c00 * c11 - c01 * c01).clamp(min=1e-12)
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt((mid * mid - det).clamp(min=0.1))
    return mx, my, depth, c11 / det, -c01 / det, c00 / det, torch.ceil(3.0 * torch.sqrt(lam))


def splat(xyz, colors, opac, scales, rots, cam) -> torch.Tensor:
    """(32, 512, 512): each gaussian listed in the 16x128 tiles of its
    2x4-tile window that its (clamped) bounding box meets, in stable depth
    order; each pixel composites its tile's list front to back until its
    transmittance falls to 1e-4."""
    mx, my, depth, ca, cb, cc, radius = project(xyz, scales, rots, cam)
    op = torch.where(depth > 0.01, opac[:, 0], 0.0)
    perm = torch.argsort(depth, stable=True)
    mxp, myp, rp, opp = mx[perm], my[perm], radius[perm], op[perm]
    rx, ry = rp.clamp(max=(DUP_X - 1) * TILE_W // 2), rp.clamp(max=(DUP_Y - 1) * TILE_H // 2)
    cx0, cy0 = torch.floor((mxp - rx) / TILE_W), torch.floor((myp - ry) / TILE_H)
    tiles_x, tiles_y = SIZE // TILE_W, SIZE // TILE_H
    lists = [[] for _ in range(tiles_x * tiles_y)]
    order = torch.arange(len(perm), device=xyz.device)
    for dy in range(DUP_Y):
        for dx in range(DUP_X):
            tx, ty = cx0 + dx, cy0 + dy
            ok = ((mxp + rx >= tx * TILE_W) & (mxp - rx <= (tx + 1) * TILE_W)
                  & (myp + ry >= ty * TILE_H) & (myp - ry <= (ty + 1) * TILE_H)
                  & (tx >= 0) & (tx < tiles_x) & (ty >= 0) & (ty < tiles_y)
                  & (opp > 0) & (rp > 0))
            tile = (ty * tiles_x + tx)[ok].long()
            lists.append((tile, order[ok]))
    tile_all = torch.cat([t for t, _ in lists[tiles_x * tiles_y:]])
    rank_all = torch.cat([r for _, r in lists[tiles_x * tiles_y:]])
    key = tile_all * len(perm) + rank_all
    key, _ = torch.sort(key)
    tile_of, rank_of = key // len(perm), key % len(perm)
    bounds = torch.searchsorted(tile_of, torch.arange(tiles_x * tiles_y + 1,
                                                      device=xyz.device)).tolist()
    geo = torch.stack([mx, my, ca, cb, cc, op], 1)[perm]
    col = fp8(colors[perm])
    out = torch.zeros(tiles_x * tiles_y, TILE_H * TILE_W, 32, device=xyz.device)
    pix = torch.arange(TILE_H * TILE_W, device=xyz.device)
    ly, lx = (pix // TILE_W).float(), (pix % TILE_W).float()
    for t in range(tiles_x * tiles_y):
        idx = rank_of[bounds[t]:bounds[t + 1]]
        if len(idx) == 0:
            continue
        px = ((t % tiles_x) * TILE_W + lx + 0.5)[:, None]
        py = ((t // tiles_x) * TILE_H + ly + 0.5)[:, None]
        g = geo[idx]
        ddx, ddy = px - g[:, 0], py - g[:, 1]
        power = -0.5 * (g[:, 2] * ddx * ddx + g[:, 4] * ddy * ddy) - g[:, 3] * ddx * ddy
        alpha = torch.clamp(g[:, 5] * torch.exp(power), max=0.99)
        alpha = torch.where((power > 0) | (alpha < ALPHA_EPS), 0.0, alpha)
        trans = torch.cumprod(1.0 - alpha, 1)
        before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
        out[t] = torch.where(before > T_EPS, alpha * before, 0.0) @ col[idx]
    img = out.reshape(tiles_y, tiles_x, TILE_H, TILE_W, 32)
    return img.permute(4, 0, 2, 1, 3).reshape(32, SIZE, SIZE)


# ----------------------------------------------------------------- avatar

class GagaReference:
    """The avatar encode once, then frames of given motions."""

    def __init__(self, params: Dict[str, torch.Tensor], avatar: Dict[str, np.ndarray],
                 flame, device):
        with torch.device("meta"):
            nets = GAGAvatarNets()
        nets.load_state_dict({k.replace("//", "."): v for k, v in params.items()},
                             assign=True)
        self.nets, self.flame, self.device = nets, flame, device
        pts, dirs = planes(avatar["transform_matrix"])
        pts = torch.from_numpy(pts)[None].to(device)
        dirs = torch.from_numpy(dirs)[None].to(device)
        image = torch.from_numpy(avatar["image"])[None].to(device)
        self.base = torch.from_numpy(avatar["transform_matrix"][:3]).to(device)
        self.shape = torch.from_numpy(avatar["shapecode"]).reshape(1, -1).to(device)
        with torch.no_grad():
            dense, glob = nets.base_model(antialias(image, 518, 518))
            direnc = harmonic(dirs)
            head = torch.cat([nets.head_base[None], glob[:, None].expand(1, NUM_VERTS, -1)], -1)
            g = nets.gs_generator_g(head, direnc)
            g["xyz"] = head.new_zeros((1, NUM_VERTS, 3))
            l0 = nets.gs_generator_l0(dense, direnc)
            l1 = nets.gs_generator_l1(dense, direnc)
            l0["xyz"] = pts + l0.pop("positions") * dirs[:, None]
            l1["xyz"] = pts - l1.pop("positions") * dirs[:, None]
            self.gs = {k: torch.cat([g[k], l0[k], l1[k]], 1)[0] for k in g}

    @torch.no_grad()
    def frames(self, motions: torch.Tensor, picks: List[int]) -> torch.Tensor:
        """yuv420 frames (len(picks), 3H/2, W) of the frames ``picks`` of a
        clip's motions (T, 106): FLAME at GAGAvatar's scale with the clip's
        shape code and jaw, the forehead vertices smoothed by an EMA over the
        clip (seeded by its first frame), the rotation in the camera."""
        t = motions.shape[0]
        z3 = motions.new_zeros(t, 3)
        verts = self.flame.forward(self.shape.expand(t, -1), motions[:, :100], z3,
                                   motions[:, 103:106])
        idx = torch.from_numpy(FOREHEAD).to(verts.device)
        cur, state, smooth = verts[:, idx], None, []
        for i in range(t):
            state = cur[0] if state is None else state
            state = 0.98 * state + 0.02 * cur[i]
            smooth.append(state)
        verts[:, idx] = torch.stack(smooth)
        cams = camera(motions[:, 100:103], self.base)
        out = []
        for i in picks:
            xyz = torch.cat([verts[i], self.gs["xyz"][NUM_VERTS:]])
            render = splat(xyz, self.gs["colors"], self.gs["opacities"], self.gs["scales"],
                           self.gs["rotations"], cams[i])
            out.append(self.nets.upsampler(render[None]).clamp(0.0, 1.0))
        return rgb_to_yuv420(torch.cat(out).permute(0, 2, 3, 1))
