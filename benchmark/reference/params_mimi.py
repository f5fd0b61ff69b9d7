"""The parameters of the motion model on the Mimi encoder: their names and
shapes, as the port loads ARTalk's checkpoint with ``AUDIO_ENCODER:
"mimi"`` (``utils/params.params_from_flat``), and the rule of each seeded
value.

The motion model's entries are ``params.motion_spec``'s without its
``audio_encoder//`` keys (the wav2vec2 group it reads is a placeholder whose
entries are dropped); the AR AdaLN's input is the configuration's
``audio_dim``, 512. The Mimi tree follows HF's ``MimiModel`` encode path:
convolutions ``(out, in, k)``, kaiming-uniform (the fan-in bound) with zero
biases; the transformer's bias-free linears ``(in, out)`` stacked by layer,
uniform within the fan-in bound; LayerNorm scales 1; LayerScale at its
published 0.01; codebooks (``embed_sum``) normal at the configuration's
``codebook_std`` with usage 1.
"""

from __future__ import annotations

import math

from .params import Spec, _linear, _norm, motion_spec

# stands in for the wav2vec2 group that ``motion_spec`` reads; its entries go
NO_WAV2VEC = {"conv_dim": [1], "conv_kernel": [1], "conv_stride": [1], "hidden_size": 1,
              "num_hidden_layers": 1, "num_attention_heads": 1, "intermediate_size": 1,
              "num_conv_pos_embeddings": 1, "num_conv_pos_embedding_groups": 1}

A = "audio_encoder"


def _conv(spec: Spec, prefix: str, cout: int, cin: int, k: int, bias: bool = True) -> None:
    spec.append((f"{prefix}//w", (cout, cin, k), ("uniform", 1.0 / math.sqrt(cin * k))))
    if bias:
        spec.append((f"{prefix}//b", (cout,), ("const", 0.0)))


def mimi_spec(cfg: dict, codebook_std: float) -> Spec:
    """The Mimi encoder's parameters, ``audio_encoder//``-keyed, for the
    ``mimi`` group ``cfg``."""
    spec: Spec = []
    f, d = cfg["num_filters"], cfg["hidden_size"]
    _conv(spec, f"{A}//seanet//init_conv", f, 1, cfg["kernel_size"])
    for i, ratio in enumerate(reversed(cfg["ratios"])):
        c = f * 2 ** i
        for j in range(cfg["num_residual_layers"]):
            r = f"{A}//seanet//blocks//{i}//resnets//{j}"
            _conv(spec, f"{r}//conv1", c // cfg["compress"], c, cfg["residual_kernel_size"])
            _conv(spec, f"{r}//conv2", c, c // cfg["compress"], 1)
        _conv(spec, f"{A}//seanet//blocks//{i}//down", 2 * c, c, 2 * ratio)
    _conv(spec, f"{A}//seanet//final_conv", d, f * 2 ** len(cfg["ratios"]),
          cfg["last_kernel_size"])
    T, n = f"{A}//transformer", (cfg["num_hidden_layers"],)
    hd = cfg["num_heads"] * cfg["head_dim"]
    spec += [(f"{T}//ls_attn", n + (d,), ("const", cfg["layer_scale"])),
             (f"{T}//ls_mlp", n + (d,), ("const", cfg["layer_scale"]))]
    for name, fi, fo in (("q", d, hd), ("k", d, hd), ("v", d, hd), ("o", hd, d),
                         ("fc1", d, cfg["intermediate_size"]),
                         ("fc2", cfg["intermediate_size"], d)):
        _linear(spec, f"{T}//{name}", fi, fo, n, bias=False)
    _norm(spec, f"{T}//norm1", d, n)
    _norm(spec, f"{T}//norm2", d, n)
    _conv(spec, f"{A}//downsample", d, d, 4, bias=False)
    ns = cfg["num_semantic_quantizers"]
    for q, count in (("semantic_rvq", ns), ("acoustic_rvq", cfg["num_quantizers"] - ns)):
        size, cd = cfg["codebook_size"], cfg["codebook_dim"]
        spec += [(f"{A}//{q}//embed_sum", (count, size, cd), ("normal", codebook_std)),
                 (f"{A}//{q}//cluster_usage", (count, size), ("const", 1.0))]
        _conv(spec, f"{A}//{q}//input_proj", cd, d, 1, bias=False)
        _conv(spec, f"{A}//{q}//output_proj", d, cd, 1, bias=False)
    return spec


def mimi_motion_spec(model: dict) -> Spec:
    """Every parameter of the Mimi-conditioned motion model of ``model`` (the
    ``model`` group of a configuration file)."""
    base = [e for e in motion_spec(dict(model, wav2vec=NO_WAV2VEC))
            if not e[0].startswith(f"{A}//")]
    return base + mimi_spec(model["mimi"], model["mimi_codebook_std"])
