"""The motion model's parameters: their names and shapes, and seeded values.

The names and shapes are those of ARTalk's checkpoint as the port loads it
(a flat dict keyed by the module path joined with ``//``; linear weights are
``(in, out)``, a layer stack keeps its layers on a leading axis). The values
are random: no released checkpoint is in the repository. ``make_params``
draws them on the device from the seed in two large calls, one uniform and
one normal, and scales each tensor by the rule of its kind (a linear layer's
fan-in bound, ones for a LayerNorm's scale, the dataset's motion statistics
where the checkpoint holds them). The benchmark hands the same dict to the
program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .data_stats import ALLTALKEMICA_MEAN, ALLTALKEMICA_STD

# (key, shape, rule); a rule is ("uniform", bound), ("normal", std),
# ("const", value) or ("table", name)
Spec = List[Tuple[str, Tuple[int, ...], tuple]]


def _linear(spec: Spec, prefix: str, fan_in: int, fan_out: int, stack: tuple = (),
            bias: bool = True, w_bound: float | None = None, b_bound: float | None = None
            ) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    spec.append((f"{prefix}//w", stack + (fan_in, fan_out),
                 ("uniform", bound if w_bound is None else w_bound)))
    if bias:
        spec.append((f"{prefix}//b", stack + (fan_out,),
                     ("uniform", bound if b_bound is None else b_bound)))


def _norm(spec: Spec, prefix: str, dim: int, stack: tuple = ()) -> None:
    spec.append((f"{prefix}//scale", stack + (dim,), ("const", 1.0)))
    spec.append((f"{prefix}//bias", stack + (dim,), ("const", 0.0)))


def motion_spec(cfg: dict) -> Spec:
    """Every parameter of the motion model of configuration ``cfg`` (the
    ``model`` group of a configuration file)."""
    w2v, ar, vae, sty = cfg["wav2vec"], cfg["ar"], cfg["vae"], cfg["style_encoder"]
    spec: Spec = []
    d = ar["embed_dim"]
    tokens = sum(vae["patch_nums"])
    pe_std = math.sqrt(1 / d / 3)
    spec += [("null_style_cond", (1, 1, d), ("normal", 0.5)),
             ("pos_embed", (1, tokens, d), ("normal", pe_std)),
             ("prev_pos_embed", (1, tokens * ar["prev_ratio"], d), ("normal", pe_std)),
             ("lvl_embed", (len(vae["patch_nums"]), d), ("normal", pe_std))]
    # BITWISE_VAE
    h, md, cd, vd = vae["hidden_dim"], vae["motion_dim"], vae["code_dim"], vae["depth"]
    w = vae["patch_nums"][-1]
    spec += [("vae//enc_pos_embed", (1, 2 * w, md), ("normal", math.sqrt(1 / md / 3))),
             ("vae//dec_pos_embed", (1, 2 * w, cd), ("normal", math.sqrt(1 / cd / 3))),
             ("vae//motion_mean", (md,), ("table", "motion_mean")),
             ("vae//motion_std", (md,), ("table", "motion_std"))]
    for coder, cin, cout in (("encoder", md, cd), ("decoder", cd, md)):
        p = f"vae//{coder}"
        _linear(spec, f"{p}//inp", cin, h)
        _norm(spec, f"{p}//layers//attn//norm", h, (vd,))
        _linear(spec, f"{p}//layers//attn//qkv", h, 3 * h, (vd,), bias=False)
        _linear(spec, f"{p}//layers//attn//out", h, h, (vd,))
        _linear(spec, f"{p}//layers//ffn//fc1", h, int(1.5 * h), (vd,))
        _linear(spec, f"{p}//layers//ffn//fc2", int(1.5 * h), h, (vd,))
        _linear(spec, f"{p}//out", h, cout,
                w_bound=0.05 * math.sqrt(6.0 / (h + md)) if coder == "decoder" else None)
    # style encoder (unused with the null style, but part of the checkpoint)
    sd, sl = sty["feature_dim"], sty["num_layers"]
    spec += [("style_encoder//pe", (1, sty["max_len"], sd), ("table", "sinusoidal")),
             ("style_encoder//motion_mean", (md,), ("table", "motion_mean")),
             ("style_encoder//motion_std", (md,), ("table", "motion_std"))]
    _linear(spec, "style_encoder//proj", md, sd)
    _linear(spec, "style_encoder//layers//qkv", sd, 3 * sd, (sl,))
    _linear(spec, "style_encoder//layers//out", sd, sd, (sl,))
    _norm(spec, "style_encoder//layers//norm1", sd, (sl,))
    _norm(spec, "style_encoder//layers//norm2", sd, (sl,))
    _linear(spec, "style_encoder//layers//fc1", sd, sty["ffn_dim"], (sl,))
    _linear(spec, "style_encoder//layers//fc2", sty["ffn_dim"], sd, (sl,))
    # wav2vec2 (stable layer norm: every conv has its LayerNorm)
    a = "audio_encoder"
    cin = 1
    for n, (co, k) in enumerate(zip(w2v["conv_dim"], w2v["conv_kernel"])):
        spec.append((f"{a}//feature_extractor//{n}//conv//w", (co, cin, k),
                     ("uniform", 1.0 / math.sqrt(cin * k))))
        spec.append((f"{a}//feature_extractor//{n}//conv//b", (co,), ("const", 0.0)))
        _norm(spec, f"{a}//feature_extractor//{n}//norm", co)
        cin = co
    hd, ld = w2v["hidden_size"], w2v["num_hidden_layers"]
    _norm(spec, f"{a}//feature_projection//norm", cin)
    _linear(spec, f"{a}//feature_projection//proj", cin, hd)
    kp, gp = w2v["num_conv_pos_embeddings"], w2v["num_conv_pos_embedding_groups"]
    spec.append((f"{a}//encoder//pos_conv//w", (hd, hd // gp, kp),
                 ("uniform", 1.0 / math.sqrt(hd // gp * kp))))
    spec.append((f"{a}//encoder//pos_conv//b", (hd,), ("const", 0.0)))
    for name in ("q", "k", "v", "out"):
        _linear(spec, f"{a}//encoder//layers//{name}", hd, hd, (ld,))
    _norm(spec, f"{a}//encoder//layers//norm1", hd, (ld,))
    _norm(spec, f"{a}//encoder//layers//norm2", hd, (ld,))
    _linear(spec, f"{a}//encoder//layers//fc1", hd, w2v["intermediate_size"], (ld,))
    _linear(spec, f"{a}//encoder//layers//fc2", w2v["intermediate_size"], hd, (ld,))
    _norm(spec, f"{a}//encoder//final_norm", hd)
    # AR transformer
    depth, heads = ar["depth"], ar["num_heads"]
    ca = ar["audio_dim"]
    hidden = round(d * ar["mlp_ratio"])
    _linear(spec, "vqfeat_embed", cd, d)
    _linear(spec, "style_cond_embed", ar["style_dim"], d)
    spec.append(("blocks//scale_mul", (depth, 1, heads, 1, 1), ("const", math.log(4.0))))
    _linear(spec, "blocks//ada_lin", ca, 6 * d, (depth,))
    _linear(spec, "blocks//q", d, d, (depth,))
    _linear(spec, "blocks//k", d, d, (depth,), bias=False)
    _linear(spec, "blocks//v", d, d, (depth,))
    _linear(spec, "blocks//proj", d, d, (depth,))
    _linear(spec, "blocks//fc1", d, hidden, (depth,))
    _linear(spec, "blocks//fc2", hidden, d, (depth,))
    _linear(spec, "head//ada_lin", ca, 2 * d)
    _linear(spec, "head//out", d, 2 * cd)
    return spec


def _table(name: str, shape: tuple) -> np.ndarray:
    if name == "motion_mean":
        return ALLTALKEMICA_MEAN
    if name == "motion_std":
        return ALLTALKEMICA_STD
    max_len, dim = shape[-2], shape[-1]        # sinusoidal position table
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return pe.reshape(shape).astype(np.float32)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose, drawn from the run's seed and ``tags``."""
    return int(np.random.SeedSequence([int(seed) % 2**64, *tags]).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


@torch.no_grad()
def make_params(spec: Spec, seed: int, device: torch.device, tag: int = 1
                ) -> Dict[str, torch.Tensor]:
    """Seeded values of every parameter of ``spec``, float32 on ``device``:
    views into one flat buffer, drawn there in one uniform and one normal
    call from a generator on the device (``tag`` tells one model's draws
    from another's)."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, tag))
    flat = torch.rand(total, generator=gen, device=device)
    normal = torch.randn(sum(n for (_, _, r), n in zip(spec, sizes) if r[0] == "normal"),
                         generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    start = used = 0
    for (key, shape, rule), n in zip(spec, sizes):
        view = flat[start:start + n]
        kind, arg = rule
        if kind == "uniform":
            view.mul_(2.0 * arg).sub_(arg)
        elif kind == "normal":
            view.copy_(normal[used:used + n].clamp_(-2.0, 2.0).mul_(arg))
            used += n
        elif kind == "const":
            view.fill_(arg)
        else:
            view.copy_(torch.from_numpy(_table(arg, shape)).reshape(-1))
        out[key] = view.view(shape)
        start += n
    return out
