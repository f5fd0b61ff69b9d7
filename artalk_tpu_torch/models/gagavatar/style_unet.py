"""StyleUNet super-resolver: UNet SFT conditions + StyleGAN2 generator.

Counterpart of ``artalk_tpu/models/gagavatar/style_unet.py`` (reference:
app/GAGAvatar/modules/style_unet.py:13-252, style_clean.py:168-313): a UNet
over the 32-channel splat render gives a 512-d style code and per-scale SFT
scale/shift maps; a StyleGAN2 generator with weight (de)modulation renders
the RGB image, modulated by them.

The modulated conv is the reference's grouped conv (one group per sample).
Noise injection uses the stored per-layer noise buffers (the deterministic
``randomize_noise=False`` path). ``compute_dtype=torch.bfloat16`` runs every
conv and matmul in bf16 (parameters cast on use, the resize matrices' float32
results cast back to bf16, the demodulation and style norm summed in
float32) and returns float32 after the final sigmoid.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize2d import resize_bilinear
from .. import nn as tnn

UNET_CHANNELS = {4: 256, 8: 256, 16: 256, 32: 256, 64: 128, 128: 64, 256: 32,
                 512: 16, 1024: 8}
GAN_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64,
                512: 32, 1024: 16}


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _linear(lin: tnn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin`` in the input's dtype."""
    return torch.matmul(x, lin.w.to(x.dtype)) + lin.b.to(x.dtype)


def _resize2x(x: torch.Tensor, up: bool) -> torch.Tensor:
    h, w = x.shape[-2:]
    oh, ow = (h * 2, w * 2) if up else (h // 2, w // 2)
    # the float32 matrices must not upcast a bf16 path
    return resize_bilinear(x, oh, ow).to(x.dtype)


class _ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cin, 3)
        self.conv2 = tnn.Conv2d(cin, cout, 3)
        self.skip = tnn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x: torch.Tensor, up: bool) -> torch.Tensor:
        out = _lrelu(self.conv1(x, padding=1))
        out = _lrelu(self.conv2(_resize2x(out, up), padding=1))
        return out + self.skip(_resize2x(x, up))


class _CondConv(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.c1 = tnn.Conv2d(ch, ch, 3)
        self.c2 = tnn.Conv2d(ch, 2 * ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(_lrelu(self.c1(x, padding=1)), padding=1)


class StyleUNet(nn.Module):
    def __init__(self, in_size: int = 512, out_size: int = 512, in_dim: int = 32,
                 out_dim: int = 3, num_style_feat: int = 512, num_mlp: int = 8):
        super().__init__()
        assert in_size <= out_size, "downscaling front-end not implemented"
        self.out_size = out_size
        self.log_size = int(math.log2(out_size))
        ch = UNET_CHANNELS
        self.first = tnn.Conv2d(in_dim, ch[out_size], 1)
        down, cin = [], ch[out_size]
        for i in range(self.log_size, 2, -1):
            down.append(_ResBlock(cin, ch[2 ** (i - 1)]))
            cin = ch[2 ** (i - 1)]
        self.down = nn.ModuleList(down)
        self.final_conv = tnn.Conv2d(ch[8], ch[4], 3)
        up, to_rgb, cond_scale, cond_shift, cin = [], [], [], [], ch[4]
        for i in range(3, self.log_size + 1):
            cout = ch[2 ** i]
            up.append(_ResBlock(cin, cout))
            to_rgb.append(tnn.Conv2d(cout, 3, 1))   # in the reference's tree, unused
            cond_scale.append(_CondConv(cout))
            cond_shift.append(_CondConv(cout))
            cin = cout
        self.up = nn.ModuleList(up)
        self.to_rgb = nn.ModuleList(to_rgb)
        self.cond_scale = nn.ModuleList(cond_scale)
        self.cond_shift = nn.ModuleList(cond_shift)
        self.final_linear = tnn.Linear(ch[4] * 16, num_style_feat)
        self.gan = StyleGAN2GeneratorCSFT(out_size, out_dim, num_style_feat, num_mlp)

    def init(self, gen: torch.Generator) -> "StyleUNet":
        for m in self.modules():
            if isinstance(m, tnn.Conv2d):
                m.init(gen)
        tnn.linear_init(self.final_linear, gen)
        self.gan.init(gen)
        return self

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(B, in_dim, S, S) -> (B, out_dim, out_size, out_size), sigmoid, float32."""
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        if x.shape[-1] < self.out_size:
            x = resize_bilinear(x, self.out_size, self.out_size).to(x.dtype)
        feat = _lrelu(self.first(x))
        skips: List[torch.Tensor] = []
        for block in self.down:
            feat = block(feat, up=False)
            skips.insert(0, feat)
        feat = _lrelu(self.final_conv(feat, padding=1))
        style = _linear(self.final_linear, feat.reshape(feat.shape[0], -1))
        conditions = []
        for i, block in enumerate(self.up):
            feat = block(feat + skips[i], up=True)
            conditions.append(self.cond_scale[i](feat))
            conditions.append(self.cond_shift[i](feat))
        image = self.gan(style, conditions)
        return torch.sigmoid(image.float()).contiguous()


class _ModConv(nn.Module):
    """StyleGAN2 modulated conv parameters: ``modulation`` (style -> per
    input channel scale, bias 1) and ``weight`` (1, cout, cin, k, k)."""

    def __init__(self, num_style_feat: int, cin: int, cout: int, k: int):
        super().__init__()
        self.modulation = tnn.Linear(num_style_feat, cin)
        self.weight = nn.Parameter(torch.empty(1, cout, cin, k, k))

    def init(self, gen: torch.Generator) -> None:
        tnn.kaiming_uniform(self.modulation.w.data, self.modulation.in_dim, gen, a=0.0)
        self.modulation.b.data.fill_(1.0)   # bias_fill=1 (style_clean.py:233)
        _, cout, cin, k, _ = self.weight.shape
        self.weight.data.normal_(generator=gen).div_(math.sqrt(cin * k * k))

    def forward(self, x: torch.Tensor, style: torch.Tensor, demodulate: bool = True,
                upsample: bool = False) -> torch.Tensor:
        """(style_clean.py:240-260): one grouped conv, one group per sample."""
        dt = x.dtype
        s = _linear(self.modulation, style)                           # (B, cin)
        weight = self.weight.to(dt) * s[:, None, :, None, None]       # (B, cout, cin, k, k)
        if demodulate:
            # float32 sum: a bf16 sum over cin * k * k squares is too lossy
            demod = torch.rsqrt(weight.float().square().sum(dim=(2, 3, 4)) + 1e-8)
            weight = weight * demod[:, :, None, None, None].to(dt)
        if upsample:
            x = _resize2x(x, True)
        b, cout, cin, k, _ = weight.shape
        h, w = x.shape[-2:]
        out = tnn.conv2d(x.reshape(1, b * cin, h, w), weight.reshape(b * cout, cin, k, k),
                         padding=k // 2, groups=b)
        return out.reshape(b, cout, h, w)


class _StyleConv(nn.Module):
    def __init__(self, num_style_feat: int, cin: int, cout: int, k: int):
        super().__init__()
        self.mod = _ModConv(num_style_feat, cin, cout, k)
        self.noise_weight = nn.Parameter(torch.zeros(()))
        self.bias = nn.Parameter(torch.zeros(1, cout, 1, 1))

    def forward(self, x, style, noise, upsample=False):
        dt = x.dtype
        out = self.mod(x, style, True, upsample) * (2 ** 0.5)
        out = out + self.noise_weight.to(dt) * noise.to(dt)
        return _lrelu(out + self.bias.to(dt))


class _ToRGB(nn.Module):
    def __init__(self, num_style_feat: int, cin: int, out_dim: int):
        super().__init__()
        self.mod = _ModConv(num_style_feat, cin, out_dim, 1)
        self.bias = nn.Parameter(torch.zeros(1, out_dim, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.mod(x, style, demodulate=False) + self.bias.to(x.dtype)
        if skip is not None:
            out = out + _resize2x(skip, True)
        return out


class StyleGAN2GeneratorCSFT(nn.Module):
    def __init__(self, out_size: int, out_dim: int = 3, num_style_feat: int = 512,
                 num_mlp: int = 8):
        super().__init__()
        self.log_size = int(math.log2(out_size))
        num_layers = (self.log_size - 2) * 2 + 1
        ch = GAN_CHANNELS
        self.style_mlp = nn.ModuleList(tnn.Linear(num_style_feat, num_style_feat)
                                       for _ in range(num_mlp))
        self.constant_input = nn.Parameter(torch.empty(1, ch[4], 4, 4))
        self.conv1 = _StyleConv(num_style_feat, ch[4], ch[4], 3)
        self.to_rgb1 = _ToRGB(num_style_feat, ch[4], out_dim)
        convs, rgbs, cin = [], [], ch[4]
        for i in range(3, self.log_size + 1):
            cout = ch[2 ** i]
            convs.append(_StyleConv(num_style_feat, cin, cout, 3))   # upsample
            convs.append(_StyleConv(num_style_feat, cout, cout, 3))  # regular
            rgbs.append(_ToRGB(num_style_feat, cout, out_dim))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(rgbs)
        self.noises = nn.ParameterList(
            nn.Parameter(torch.empty(1, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2)))
            for i in range(num_layers))

    def init(self, gen: torch.Generator) -> "StyleGAN2GeneratorCSFT":
        for lin in self.style_mlp:
            tnn.linear_init(lin, gen)
        for m in self.modules():
            if isinstance(m, _ModConv):
                m.init(gen)
        for t in (*self.noises, self.constant_input):
            t.data.normal_(generator=gen)
        return self

    def forward(self, style: torch.Tensor, conditions: List[torch.Tensor]) -> torch.Tensor:
        dt = style.dtype
        # normalize + MLP (the norm accumulated in float32 whatever the dtype)
        s = style * torch.rsqrt(style.float().square().mean(dim=1, keepdim=True)
                                + 1e-8).to(dt)
        for lin in self.style_mlp:
            s = _lrelu(_linear(lin, s))
        noises = self.noises
        out = self.constant_input.to(dt).expand(style.shape[0], -1, -1, -1)
        out = self.conv1(out, s, noises[0])
        skip = self.to_rgb1(out, s)
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * idx](out, s, noises[2 * idx + 1], upsample=True)
            if i < len(conditions):
                out = out * conditions[i - 1] + conditions[i]
            out = self.convs[2 * idx + 1](out, s, noises[2 * idx + 2])
            skip = to_rgb(out, s, skip)
            i += 2
        return skip
