"""Plain PyTorch reference of ARTalk's motion path (Chu et al. 2025,
arXiv:2502.20323): wav2vec2-XLS-R audio features, the multi-scale AR
transformer's logits teacher-forced, the BITWISE_VAE with its multi-scale
BSQ, and Savitzky-Golay smoothing. Written from the published architecture
and ARTalk's ``app/`` modules; it imports nothing of the program.

The reference follows the decisions the program served: the AR code bits of
each window and the carry bits the VAE re-encodes after it. Each window's
logits are the teacher-forced forward of all 181 tokens at once under the
level-causal mask (where the program decodes level by level through a KV
cache), and each carry's BSQ values are computed with the program's bits of
the coarser levels. ``decision gaps`` then say how far each served bit lies
below the reference's best choice; the motion is decoded from the served
bits and smoothed, and compared with the program's.

Everything is float32. ``Precision`` sets what the reference may lower for
the control runs: TF32 in every matrix product and convolution, or weights
of the AR blocks and the encoder layers rounded to a few bits per output
channel (weight-only quantisation).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

P = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Precision:
    """What a reference run computes in: ``tf32`` lets matmuls and cuDNN
    convolutions round their inputs to TF32; ``weight_bits`` (8, 4; None
    keeps float32) rounds the AR blocks' and the encoder layers' weights,
    symmetric per output channel; ``fp8`` rounds the GAGAvatar
    super-resolution's convolutions and the splat colors to fp8."""

    tf32: bool = False
    weight_bits: Optional[int] = None
    fp8: bool = False


FP32 = Precision()


@contextlib.contextmanager
def precision_flags(prec: Precision):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = prec.tf32
    torch.backends.cudnn.allow_tf32 = prec.tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def quantize_weight(w: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """(..., in, out) weights rounded to ``bits`` per output column
    (symmetric, scale = max |w| / (2^(bits-1) - 1)); None returns ``w``."""
    if bits is None:
        return w
    qmax = 2 ** (bits - 1) - 1
    scale = w.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / qmax
    return torch.round(w / scale).clamp(-qmax, qmax) * scale


# ----------------------------------------------------------------- primitives


def layer_norm(x: torch.Tensor, eps: float, scale=None, bias=None) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, l, c = x.shape
    return x.reshape(b, l, n, c // n).transpose(1, 2)


def unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def attention(q, k, v, scale, bias=None) -> torch.Tensor:
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    return torch.matmul(torch.softmax(logits, dim=-1), v)


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(x.square().sum(dim=-1, keepdim=True)).clamp(min=1e-12)


@functools.lru_cache(maxsize=None)
def _resize_np(kind: str, n_in: int, n_out: int) -> np.ndarray:
    """F.interpolate(mode=kind, align_corners=False) along one axis, as an
    (out, in) matrix in float64, rounded to float32."""
    m = np.zeros((n_out, n_in))
    for j in range(n_out):
        if kind == "area":
            lo, hi = int(np.floor(j * n_in / n_out)), int(np.ceil((j + 1) * n_in / n_out))
            m[j, lo:hi] = 1.0 / (hi - lo)
        else:
            pos = min(max((j + 0.5) * n_in / n_out - 0.5, 0.0), n_in - 1.0)
            lo = int(np.floor(pos))
            hi = min(lo + 1, n_in - 1)
            m[j, lo] += 1.0 - (pos - lo)
            m[j, hi] += pos - lo
    return m.astype(np.float32)


def resize(x: torch.Tensor, n_out: int, kind: str) -> torch.Tensor:
    """Resize axis -2 of (..., T, C)."""
    n_in = x.shape[-2]
    if n_in == n_out:
        return x
    return torch.matmul(torch.from_numpy(_resize_np(kind, n_in, n_out)).to(x.device), x)


@functools.lru_cache(maxsize=None)
def _savgol_np(n: int, window: int, order: int) -> np.ndarray:
    """scipy.signal.savgol_filter(mode='interp') along time as an (n, n)
    matrix: the central least-squares tap inside, a polynomial fit over the
    first and the last window at the edges."""
    half = window // 2
    fit = np.linalg.pinv(np.vander(np.arange(window, dtype=np.float64), order + 1,
                                   increasing=True))
    centre = np.linalg.pinv(np.vander(np.arange(-half, half + 1, dtype=np.float64),
                                      order + 1, increasing=True))[0]
    m = np.zeros((n, n))
    for t in range(half, n - half):
        m[t, t - half:t + half + 1] = centre
    m[:half, :window] = np.vander(np.arange(half, dtype=np.float64), order + 1,
                                  increasing=True) @ fit
    m[n - half:, n - window:] = np.vander(np.arange(window - half, window, dtype=np.float64),
                                          order + 1, increasing=True) @ fit
    return m.astype(np.float32)


def savgol(x: torch.Tensor, window: int, order: int) -> torch.Tensor:
    n = x.shape[-2]
    if n < window:
        window = n if n % 2 == 1 else n - 1
        order = min(order, max(window - 1, 0))
        if window < 3:
            return x
    return torch.matmul(torch.from_numpy(_savgol_np(n, window, order)).to(x.device), x)


def smooth_motion(motion: torch.Tensor) -> torch.Tensor:
    """ARTalk's smoothing: window 5 / order 2 on every dim, window 9 / order
    3 on the global rotation (dims 100:103), then the last two jaw dims set
    to zero."""
    out = savgol(motion, 5, 2)
    out = torch.cat([out[..., :100], savgol(motion[..., 100:103], 9, 3), out[..., 103:]], -1)
    out[..., 104:] = 0.0
    return out


# -------------------------------------------------------------------- model


class MotionReference:
    """The motion model of one configuration on the given parameters."""

    def __init__(self, cfg: dict, params: P, prec: Precision = FP32):
        self.cfg, self.p, self.prec = cfg, params, prec
        vae = cfg["vae"]
        self.patch_nums = tuple(vae["patch_nums"])
        self.window = self.patch_nums[-1]
        self.code_dim = vae["code_dim"]
        self.tokens = sum(self.patch_nums)
        self.levels = np.concatenate([np.full(n, i) for i, n in enumerate(self.patch_nums)])
        assert cfg["ar"]["prev_ratio"] == 1, "the reference carries one window"

    def w(self, key: str, quantize: bool = False) -> torch.Tensor:
        t = self.p[key]
        return quantize_weight(t, self.prec.weight_bits) if quantize else t

    # ------------------------------------------------------------- wav2vec2

    def audio_features(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, samples) -> (B, frames, hidden): z-norm, the conv frontend
        (each conv with a LayerNorm over channels, erf GELU), the feature
        projection, the grouped positional conv, the pre-LN layers and the
        final LayerNorm."""
        c = self.cfg["wav2vec"]
        eps = c["layer_norm_eps"]
        a = "audio_encoder"
        n = audio.shape[-1]
        mean = audio.mean(dim=-1, keepdim=True)
        std = torch.sqrt((audio - mean).square().sum(dim=-1, keepdim=True) / (n - 1))
        x = ((audio - mean) / (std + 1e-6))[:, None]
        for i, stride in enumerate(c["conv_stride"]):
            p = f"{a}//feature_extractor//{i}"
            x = F.conv1d(x, self.w(f"{p}//conv//w"), self.w(f"{p}//conv//b"), stride=stride)
            x = layer_norm(x.transpose(1, 2), eps, self.w(f"{p}//norm//scale"),
                           self.w(f"{p}//norm//bias")).transpose(1, 2)
            x = F.gelu(x)
        x = x.transpose(1, 2)
        p = f"{a}//feature_projection"
        x = layer_norm(x, eps, self.w(f"{p}//norm//scale"), self.w(f"{p}//norm//bias"))
        x = torch.matmul(x, self.w(f"{p}//proj//w")) + self.w(f"{p}//proj//b")
        k = c["num_conv_pos_embeddings"]
        pos = F.conv1d(x.transpose(1, 2), self.w(f"{a}//encoder//pos_conv//w"),
                       self.w(f"{a}//encoder//pos_conv//b"), padding=k // 2,
                       groups=c["num_conv_pos_embedding_groups"])
        if k % 2 == 0:
            pos = pos[..., :-1]
        x = x + F.gelu(pos.transpose(1, 2))
        L = f"{a}//encoder//layers"
        nh = c["num_attention_heads"]
        for i in range(c["num_hidden_layers"]):
            def lin(name, t):
                return torch.matmul(t, self.w(f"{L}//{name}//w", True)[i]) + self.w(f"{L}//{name}//b")[i]
            y = layer_norm(x, eps, self.w(f"{L}//norm1//scale")[i], self.w(f"{L}//norm1//bias")[i])
            q, kk, v = (heads(lin(nm, y), nh) for nm in ("q", "k", "v"))
            x = x + lin("out", unheads(attention(q, kk, v, q.shape[-1] ** -0.5)))
            y = layer_norm(x, eps, self.w(f"{L}//norm2//scale")[i], self.w(f"{L}//norm2//bias")[i])
            x = x + lin("fc2", F.gelu(lin("fc1", y)))
        return layer_norm(x, eps, self.w(f"{a}//encoder//final_norm//scale"),
                          self.w(f"{a}//encoder//final_norm//bias"))

    def audio_condition(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, window samples) -> (B, 181, hidden): the features area-resized
        to each scale."""
        feat = self.audio_features(audio)
        return torch.cat([resize(feat, n, "area") for n in self.patch_nums], dim=1)

    # ------------------------------------------------------------------ BSQ

    def bits_values(self, bits: torch.Tensor) -> torch.Tensor:
        return (bits.float() * 2.0 - 1.0) / math.sqrt(self.code_dim)

    def split(self, bits: torch.Tensor) -> List[torch.Tensor]:
        out, start = [], 0
        for n in self.patch_nums:
            out.append(bits[..., start:start + n, :])
            start += n
        return out

    def bits_to_feat(self, bits: torch.Tensor) -> torch.Tensor:
        f = 0.0
        for lvl, b in enumerate(self.split(bits)):
            v = self.bits_values(b)
            f = f + (resize(v, self.window, "linear") if lvl < len(self.patch_nums) - 1 else v)
        return f

    def ms_feat(self, bits: torch.Tensor) -> torch.Tensor:
        """The AR inputs of levels 1..: the reconstruction through each level,
        area-resized to the next scale."""
        f, out = 0.0, []
        for lvl, b in enumerate(self.split(bits)[:-1]):
            f = f + resize(self.bits_values(b), self.window, "linear")
            out.append(resize(f, self.patch_nums[lvl + 1], "area"))
        return torch.cat(out, dim=-2)

    def bsq_values(self, f: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
        """The normalised latents whose signs are the bits of ``f`` (B, T, C),
        each level's residual taken after the served ``bits`` of the levels
        before it: (B, 181, C)."""
        residual, out = f, []
        scale = 1.0 / math.sqrt(self.code_dim)
        for n, b in zip(self.patch_nums, self.split(bits)):
            z = l2n(resize(residual, n, "area"))
            out.append(z)
            hard = torch.where(b > 0, scale, -scale).to(z.dtype)
            residual = residual - resize(z + (hard - z), self.window, "linear")
        return torch.cat(out, dim=-2)

    # ------------------------------------------------------------------ VAE

    def _tower(self, prefix: str, x: torch.Tensor, bias) -> torch.Tensor:
        v = self.cfg["vae"]
        h = x.shape[-1]
        L = f"{prefix}//layers"
        for i in range(v["depth"]):
            y = layer_norm(x, 1e-5, self.w(f"{L}//attn//norm//scale")[i],
                           self.w(f"{L}//attn//norm//bias")[i])
            q, k, vv = (heads(t, v["num_heads"]) for t in
                        torch.matmul(y, self.w(f"{L}//attn//qkv//w")[i]).chunk(3, dim=-1))
            x = x + (torch.matmul(unheads(attention(q, k, vv, h ** -0.5, bias)),
                                  self.w(f"{L}//attn//out//w")[i]) + self.w(f"{L}//attn//out//b")[i])
            f1 = F.gelu(torch.matmul(x, self.w(f"{L}//ffn//fc1//w")[i])
                        + self.w(f"{L}//ffn//fc1//b")[i], approximate="tanh")
            x = x + torch.matmul(f1, self.w(f"{L}//ffn//fc2//w")[i]) + self.w(f"{L}//ffn//fc2//b")[i]
        return x

    def _lin(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w(f"{prefix}//w")) + self.w(f"{prefix}//b")

    def two_window_bias(self, device) -> torch.Tensor:
        w = self.window
        bias = torch.zeros(2 * w, 2 * w, device=device)
        bias[:w, w:] = -torch.inf
        return bias

    def decode(self, prev_bits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
        """(prev carry bits, this window's bits) -> this window's motion."""
        feat = torch.cat([self.bits_to_feat(prev_bits), self.bits_to_feat(bits)], dim=1)
        h = F.leaky_relu(self._lin("vae//decoder//inp", feat + self.w("vae//dec_pos_embed")), 0.2)
        h = self._tower("vae//decoder", h, self.two_window_bias(feat.device))
        motion = self._lin("vae//decoder//out", h) * self.w("vae//motion_std") + self.w("vae//motion_mean")
        return motion[:, self.window:]

    def encode_latent(self, motion: torch.Tensor) -> torch.Tensor:
        """One window of motion -> the VAE latent the BSQ quantises."""
        x = ((motion - self.w("vae//motion_mean")) / self.w("vae//motion_std")
             + self.w("vae//enc_pos_embed")[:, :self.window])
        h = F.leaky_relu(self._lin("vae//encoder//inp", x), 0.2)
        return self._lin("vae//encoder//out", self._tower("vae//encoder", h, None))

    # ------------------------------------------------------------------- AR

    def prefix(self, carry_bits: torch.Tensor) -> torch.Tensor:
        """The previous window's attention prefix: [null style | embedded
        multi-scale features of the carry bits]."""
        style = self.w("null_style_cond").expand(carry_bits.shape[0], 1, -1)
        return torch.cat([style, self._lin("vqfeat_embed", self.ms_feat(carry_bits))], dim=1)

    def lvl_pos(self) -> torch.Tensor:
        idx = torch.from_numpy(self.levels).to(self.p["lvl_embed"].device)
        return self.w("lvl_embed")[idx][None] + self.w("pos_embed")

    def logits(self, cond: torch.Tensor, carry_bits: torch.Tensor,
               bits: torch.Tensor) -> torch.Tensor:
        """Teacher-forced bit logits (B, 181, code_dim, 2) of one window:
        every level's inputs built from the served ``bits``, all 181 tokens
        at once under the level-causal mask, with the carry's prefix fully
        visible."""
        ar = self.cfg["ar"]
        depth, nh = ar["depth"], ar["num_heads"]
        idx = torch.from_numpy(self.levels).to(cond.device)
        prev = self.prefix(carry_bits) + self.w("lvl_embed")[idx][None] + self.w("prev_pos_embed")
        style = self.w("null_style_cond").expand(bits.shape[0], 1, -1)
        x = torch.cat([style, self._lin("vqfeat_embed", self.ms_feat(bits))], 1) + self.lvl_pos()
        mask = torch.where(idx[:, None] >= idx[None, :], 0.0, -torch.inf)
        bias = torch.cat([torch.zeros(self.tokens, prev.shape[1], device=cond.device), mask], 1)
        sc = F.silu(cond)
        B = "blocks"
        scale_mul = torch.exp(torch.clamp(self.w(f"{B}//scale_mul"), max=math.log(100.0)))
        for i in range(depth):
            ada = torch.matmul(sc, self.w(f"{B}//ada_lin//w")[i]) + self.w(f"{B}//ada_lin//b")[i]
            g1, g2, s1, s2, sh1, sh2 = ada.chunk(6, dim=-1)
            hm = layer_norm(x, 1e-6) * (s1 + 1.0) + sh1
            q = torch.matmul(hm, self.w(f"{B}//q//w", True)[i]) + self.w(f"{B}//q//b")[i]
            kv_in = torch.cat([prev, hm], dim=1)
            k = torch.matmul(kv_in, self.w(f"{B}//k//w", True)[i])
            v = torch.matmul(kv_in, self.w(f"{B}//v//w", True)[i]) + self.w(f"{B}//v//b")[i]
            q, k, v = l2n(heads(q, nh)) * scale_mul[i], l2n(heads(k, nh)), heads(v, nh)
            a = unheads(attention(q, k, v, 1.0, bias))
            x = x + (torch.matmul(a, self.w(f"{B}//proj//w", True)[i]) + self.w(f"{B}//proj//b")[i]) * g1
            hm2 = layer_norm(x, 1e-6) * (s2 + 1.0) + sh2
            f1 = F.gelu(torch.matmul(hm2, self.w(f"{B}//fc1//w", True)[i]) + self.w(f"{B}//fc1//b")[i],
                        approximate="tanh")
            x = x + (torch.matmul(f1, self.w(f"{B}//fc2//w", True)[i]) + self.w(f"{B}//fc2//b")[i]) * g2
        h_scale, h_shift = self._lin("head//ada_lin", sc).chunk(2, dim=-1)
        feats = layer_norm(x, 1e-6) * (h_scale + 1.0) + h_shift
        out = self._lin("head//out", feats)
        return out.reshape(out.shape[0], out.shape[1], -1, 2)

    # --------------------------------------------------------------- streams

    @torch.no_grad()
    def follow(self, audio: torch.Tensor, served: List[Tuple[torch.Tensor, torch.Tensor]],
               carry0: torch.Tensor) -> dict:
        """Follow one stream of windows: ``audio`` (N, window samples),
        ``served[i]`` = (code bits (181, C), carry bits after the window
        (181, C)) as the program decided them, ``carry0`` the carry before the
        first window. Returns per window the logits, the BSQ latents of the
        carry and the raw motion, each computed from the served decisions."""
        with precision_flags(self.prec):
            carry = carry0[None]
            logits, latents, motions = [], [], []
            for i, (bits, next_carry) in enumerate(served):
                cond = self.audio_condition(audio[i:i + 1])
                logits.append(self.logits(cond, carry, bits[None])[0])
                motion = self.decode(carry, bits[None])
                motions.append(motion[0])
                latents.append(self.bsq_values(self.encode_latent(motion), next_carry[None])[0])
                carry = next_carry[None]
            return {"logits": logits, "latents": latents, "motion": torch.cat(motions)}

    @torch.no_grad()
    def initial_latent(self, carry0: torch.Tensor, device) -> torch.Tensor:
        """The BSQ latents of the bootstrap carry (a window of zero motion)."""
        with precision_flags(self.prec):
            zero = torch.zeros(1, self.window, self.cfg["vae"]["motion_dim"], device=device)
            return self.bsq_values(self.encode_latent(zero), carry0[None])[0]
