"""Reference (PyTorch) checkpoint -> parameter tree conversion, numpy only.

The port's own copy of ``artalk_tpu/utils/convert.py``, which cannot be
imported without jax. Maps the reference's ``ARTalk_wav2vec.pt`` state-dict
layout (the BitwiseARModel built at app/models.py:13-56, including the
embedded wav2vec2-xls-r audio encoder, BITWISE_VAE, and StyleEncoder), the
GAGAvatar and the Mimi checkpoints onto the JAX package's parameter trees
(nested dicts and lists of numpy arrays). ``utils/params.save_params_npz``
writes such a tree as the flat ``//``-keyed archive that both packages load;
``convert_checkpoint.py`` does the ``torch.load`` and hands numpy arrays here.

Conventions translated:
- torch Linear stores (out, in); we store w as (in, out)  -> transpose.
- torch LayerNorm weight/bias -> scale/bias.
- weight-normed convs (wav2vec positional conv) are materialized.
- registered buffers that are derived constants (attention masks, level
  indices) are dropped -- we rebuild them from config.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

Array = np.ndarray
StateDict = Dict[str, Array]


def _lin(sd: StateDict, prefix: str, bias: bool = True) -> dict:
    p = {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _ln(sd: StateDict, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _stack(trees: List[Any]) -> Any:
    """Stack a list of identically structured param trees (nested dicts and
    lists of arrays) along a new leading axis, leaf by leaf."""
    first = trees[0]
    if isinstance(first, dict):
        if any(t.keys() != first.keys() for t in trees):
            raise ValueError("_stack: trees differ in their keys")
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        if any(len(t) != len(first) for t in trees):
            raise ValueError("_stack: trees differ in their lengths")
        return type(first)(_stack(list(xs)) for xs in zip(*trees))
    return np.stack(trees)


def _count(sd: StateDict, fmt: str) -> int:
    """Number of consecutive indexed submodules: max n with a key starting
    ``fmt.format(n)``. Lets every converter infer its depth from the state
    dict itself, so the same code handles production and small test models."""
    n = 0
    while any(k.startswith(fmt.format(n)) for k in sd):
        n += 1
    return n


# ---------------------------------------------------------------------------
# wav2vec2 (HF Wav2Vec2Model state dict, xls-r layer_norm variant)
# ---------------------------------------------------------------------------


def _materialize_weight_norm(sd: StateDict, prefix: str) -> Array:
    """Materialize a weight-normed conv weight (old weight_g/weight_v naming or
    new parametrizations naming). Norm is over dims (0, 1), per kernel position
    (torch weight_norm dim=2 as used by HF's positional conv)."""
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"]
    if f"{prefix}.weight_g" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    else:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    return (g * v / norm).astype(v.dtype)


def convert_wav2vec(sd: StateDict, num_layers: int | None = None,
                    num_convs: int | None = None) -> dict:
    """HF Wav2Vec2Model (xls-r-300m) state dict -> Wav2VecEncoder params.

    Layer/conv counts default to what the state dict actually contains
    (24 / 7 for the production xls-r-300m checkpoint)."""
    if num_layers is None:
        num_layers = _count(sd, "encoder.layers.{}.")
    if num_convs is None:
        num_convs = _count(sd, "feature_extractor.conv_layers.{}.")
    convs = []
    for i in range(num_convs):
        pre = f"feature_extractor.conv_layers.{i}"
        conv = {"w": sd[f"{pre}.conv.weight"]}
        if f"{pre}.conv.bias" in sd:
            conv["b"] = sd[f"{pre}.conv.bias"]
        entry = {"conv": conv}
        # "layer" mode: every conv has a LayerNorm; "group" mode (base /
        # HuBERT): only conv0 carries a GroupNorm (same param shapes)
        if f"{pre}.layer_norm.weight" in sd:
            entry["norm"] = _ln(sd, f"{pre}.layer_norm")
        convs.append(entry)

    layers = []
    for i in range(num_layers):
        pre = f"encoder.layers.{i}"
        layers.append({
            "q": _lin(sd, f"{pre}.attention.q_proj"),
            "k": _lin(sd, f"{pre}.attention.k_proj"),
            "v": _lin(sd, f"{pre}.attention.v_proj"),
            "out": _lin(sd, f"{pre}.attention.out_proj"),
            "norm1": _ln(sd, f"{pre}.layer_norm"),
            "norm2": _ln(sd, f"{pre}.final_layer_norm"),
            "fc1": _lin(sd, f"{pre}.feed_forward.intermediate_dense"),
            "fc2": _lin(sd, f"{pre}.feed_forward.output_dense"),
        })

    return {
        "feature_extractor": convs,
        "feature_projection": {
            "norm": _ln(sd, "feature_projection.layer_norm"),
            "proj": _lin(sd, "feature_projection.projection"),
        },
        "encoder": {
            "pos_conv": {
                "w": _materialize_weight_norm(sd, "encoder.pos_conv_embed.conv"),
                "b": sd["encoder.pos_conv_embed.conv.bias"],
            },
            "layers": _stack(layers),
            "final_norm": _ln(sd, "encoder.layer_norm"),
        },
    }


# ---------------------------------------------------------------------------
# StyleEncoder (torch nn.TransformerEncoder layout, style_encoder.py:10-43)
# ---------------------------------------------------------------------------


def convert_style_encoder(sd: StateDict, num_layers: int | None = None,
                          max_len: int = 600, feature_dim: int = 128) -> dict:
    from ..models.nn import sinusoidal_pe

    if num_layers is None:
        num_layers = _count(sd, "encoder.transformer.layers.{}.")
    layers = []
    for i in range(num_layers):
        pre = f"encoder.transformer.layers.{i}"
        layers.append({
            "qkv": {
                "w": np.ascontiguousarray(sd[f"{pre}.self_attn.in_proj_weight"].T),
                "b": sd[f"{pre}.self_attn.in_proj_bias"],
            },
            "out": _lin(sd, f"{pre}.self_attn.out_proj"),
            "norm1": _ln(sd, f"{pre}.norm1"),
            "norm2": _ln(sd, f"{pre}.norm2"),
            "fc1": _lin(sd, f"{pre}.linear1"),
            "fc2": _lin(sd, f"{pre}.linear2"),
        })
    pe = sd.get("PE.pe")
    if pe is None:
        pe = sinusoidal_pe(max_len, feature_dim)[None]
    return {
        "proj": _lin(sd, "encoder.motion_proj"),
        "layers": _stack(layers),
        "pe": pe,
        "motion_mean": sd["motion_mean"],
        "motion_std": sd["motion_std"],
    }


# ---------------------------------------------------------------------------
# BITWISE_VAE (bitwise_vae.py:15-41 layout)
# ---------------------------------------------------------------------------


def _vae_tower(sd: StateDict, prefix: str, depth: int) -> dict:
    layers = []
    for i in range(depth):
        attn_pre = f"{prefix}.{2 * i}"
        ffn_pre = f"{prefix}.{2 * i + 1}"
        layers.append({
            "attn": {
                "norm": _ln(sd, f"{attn_pre}.norm"),
                "qkv": _lin(sd, f"{attn_pre}.to_qkv", bias=False),
                "out": _lin(sd, f"{attn_pre}.to_out"),
            },
            "ffn": {
                "fc1": _lin(sd, f"{ffn_pre}.0"),
                "fc2": _lin(sd, f"{ffn_pre}.2"),
            },
        })
    return _stack(layers)


def convert_vae(sd: StateDict, depth: int | None = None) -> dict:
    if depth is None:
        # encoder_transformer interleaves [attn, ffn] per depth step
        depth = _count(sd, "encoder.encoder_transformer.{}.") // 2
    return {
        "encoder": {
            "inp": _lin(sd, "encoder.inp_mapping.0"),
            "layers": _vae_tower(sd, "encoder.encoder_transformer", depth),
            "out": _lin(sd, "encoder.code_mapping"),
        },
        "decoder": {
            "inp": _lin(sd, "decoder.inp_mapping.0"),
            "layers": _vae_tower(sd, "decoder.decoder_transformer", depth),
            "out": _lin(sd, "decoder.out_mapping"),
        },
        "enc_pos_embed": sd["enc_pos_embed"],
        "dec_pos_embed": sd["dec_pos_embed"],
        "motion_mean": sd["motion_mean"],
        "motion_std": sd["motion_std"],
    }


# ---------------------------------------------------------------------------
# Full BitwiseARModel (app/models.py:13-56 layout)
# ---------------------------------------------------------------------------


def _subdict(sd: StateDict, prefix: str) -> StateDict:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_ar_model(sd: StateDict, depth: int | None = None,
                     vae_depth: int | None = None) -> dict:
    """Full reference checkpoint -> BitwiseARModel params."""
    if depth is None:
        depth = _count(sd, "attn_blocks.{}.")
    blocks = []
    for i in range(depth):
        pre = f"attn_blocks.{i}"
        blocks.append({
            "ada_lin": _lin(sd, f"{pre}.ada_lin.1"),
            "q": _lin(sd, f"{pre}.attn.query"),
            "k": _lin(sd, f"{pre}.attn.key", bias=False),
            "v": _lin(sd, f"{pre}.attn.value"),
            "proj": _lin(sd, f"{pre}.attn.proj"),
            "scale_mul": sd[f"{pre}.attn.scale_mul_1H11"],
            "fc1": _lin(sd, f"{pre}.ffn.0"),
            "fc2": _lin(sd, f"{pre}.ffn.2"),
        })
    return {
        "vae": convert_vae(_subdict(sd, "basic_vae."), depth=vae_depth),
        "style_encoder": convert_style_encoder(_subdict(sd, "style_encoder.")),
        "audio_encoder": convert_wav2vec(_subdict(sd, "audio_encoder.")),
        "vqfeat_embed": _lin(sd, "vqfeat_embed"),
        "style_cond_embed": _lin(sd, "style_cond_embed"),
        "blocks": _stack(blocks),
        "head": {
            "ada_lin": _lin(sd, "cond_logits_head.ada_lin.1"),
            "out": _lin(sd, "logits_head"),
        },
        "null_style_cond": sd["null_style_cond"],
        "pos_embed": sd["pos_embed"],
        "prev_pos_embed": sd["prev_pos_embed"],
        "lvl_embed": sd["lvl_embed.weight"],
    }


# ---------------------------------------------------------------------------
# GAGAvatar (app/GAGAvatar/models.py:16-47 layout)
# ---------------------------------------------------------------------------


def _conv(sd: StateDict, prefix: str, bias: bool = True) -> dict:
    p = {"w": sd[f"{prefix}.weight"]}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def convert_dino_vit(sd: StateDict, depth: int | None = None) -> dict:
    """torch-hub DINOv2 ViT state dict (dinov2_vitb14) -> DinoViT params."""
    if depth is None:
        depth = _count(sd, "blocks.{}.")
    blocks = []
    for i in range(depth):
        pre = f"blocks.{i}"
        blocks.append({
            "norm1": _ln(sd, f"{pre}.norm1"),
            "qkv": _lin(sd, f"{pre}.attn.qkv"),
            "proj": _lin(sd, f"{pre}.attn.proj"),
            "ls1": sd[f"{pre}.ls1.gamma"],
            "norm2": _ln(sd, f"{pre}.norm2"),
            "fc1": _lin(sd, f"{pre}.mlp.fc1"),
            "fc2": _lin(sd, f"{pre}.mlp.fc2"),
            "ls2": sd[f"{pre}.ls2.gamma"],
        })
    return {
        "patch_embed": _conv(sd, "patch_embed.proj"),
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
        "blocks": _stack(blocks),
        "norm": _ln(sd, "norm"),
    }


def convert_dino_dpt(sd: StateDict) -> dict:
    """DINOBase state dict (dino_base.py:8-51) -> DinoDPT params."""

    def fusion(pre):
        return {
            "res1": {"conv1": _conv(sd, f"{pre}.resConfUnit1.conv1"),
                     "conv2": _conv(sd, f"{pre}.resConfUnit1.conv2")},
            "res2": {"conv1": _conv(sd, f"{pre}.resConfUnit2.conv1"),
                     "conv2": _conv(sd, f"{pre}.resConfUnit2.conv2")},
            "out": _conv(sd, f"{pre}.out_conv"),
        }

    return {
        "dino": convert_dino_vit(_subdict(sd, "dino_model.")),
        "projects": [_conv(sd, f"projects.{i}") for i in range(4)],
        "resize0": _conv(sd, "resize_layers.0"),
        "resize1": _conv(sd, "resize_layers.1"),
        "resize3": _conv(sd, "resize_layers.3"),
        "layer_rn": [_conv(sd, f"layer_rn.{i}", bias=False) for i in range(4)],
        "refine": [fusion(f"refinenet.{i}") for i in range(4)],
        "output_conv": _conv(sd, "output_conv"),
    }


def _mlp_seq(sd: StateDict, prefix: str, indices) -> list:
    return [_lin(sd, f"{prefix}.{i}") for i in indices]


def convert_gs_generator_linear(sd: StateDict) -> dict:
    return {
        "features": _mlp_seq(sd, "feature_layers", (0, 2, 4, 6)),
        "color": _mlp_seq(sd, "color_layers", (0, 2)),
        "opacity": _mlp_seq(sd, "opacity_layers", (0, 2)),
        "scale": _mlp_seq(sd, "scale_layers", (0, 2)),
        "rotation": _mlp_seq(sd, "rotation_layers", (0, 2)),
    }


def convert_gs_generator_conv(sd: StateDict) -> dict:
    return {
        "conv1": _conv(sd, "gaussian_conv.0"),
        "conv2": _conv(sd, "gaussian_conv.2"),
        "conv3": _conv(sd, "gaussian_conv.4"),
        "conv4": _conv(sd, "gaussian_conv.6"),
    }


def convert_style_unet(sd: StateDict, log_size: int | None = None) -> dict:
    """StyleUNet + StyleGAN2GeneratorCSFT (style_unet.py:13-218)."""
    if log_size is None:  # infer from the UNet downsample chain (9 at 512^2)
        log_size = _count(sd, "conv_body_down.{}.") + 2
    n_up = log_size - 2
    # style_mlp is Sequential(NormStyleCode, [Linear, LeakyReLU] * num_mlp):
    # only odd indices carry params (style_clean.py:137-144)
    num_mlp = sum(1 for i in range(64)
                  if f"stylegan_decoder.style_mlp.{1 + 2 * i}.weight" in sd)

    def res_block(pre):
        return {"conv1": _conv(sd, f"{pre}.conv1"),
                "conv2": _conv(sd, f"{pre}.conv2"),
                "skip": _conv(sd, f"{pre}.skip", bias=False)}

    def modconv(pre):
        return {"modulation": _lin(sd, f"{pre}.modulation"),
                "weight": sd[f"{pre}.weight"]}

    def style_conv(pre):
        return {"mod": modconv(f"{pre}.modulated_conv"),
                "noise_weight": sd[f"{pre}.weight"].reshape(()),
                "bias": sd[f"{pre}.bias"]}

    def to_rgb(pre):
        return {"mod": modconv(f"{pre}.modulated_conv"),
                "bias": sd[f"{pre}.bias"]}

    gan = {
        "style_mlp": [_lin(sd, f"stylegan_decoder.style_mlp.{1 + 2 * i}")
                      for i in range(num_mlp)],
        "constant_input": sd["stylegan_decoder.constant_input.weight"],
        "conv1": style_conv("stylegan_decoder.style_conv1"),
        "to_rgb1": to_rgb("stylegan_decoder.to_rgb1"),
        "convs": [style_conv(f"stylegan_decoder.style_convs.{i}")
                  for i in range(2 * n_up)],
        "to_rgbs": [to_rgb(f"stylegan_decoder.to_rgbs.{i}") for i in range(n_up)],
        "noises": [sd[f"stylegan_decoder.noises.noise{i}"]
                   for i in range(2 * n_up + 1)],
    }
    return {
        "first": _conv(sd, "conv_body_first"),
        "down": [res_block(f"conv_body_down.{i}") for i in range(n_up)],
        "final_conv": _conv(sd, "final_conv"),
        "up": [res_block(f"conv_body_up.{i}") for i in range(n_up)],
        "to_rgb": [_conv(sd, f"toRGB.{i}") for i in range(n_up)],
        "cond_scale": [{"c1": _conv(sd, f"condition_scale.{i}.0"),
                        "c2": _conv(sd, f"condition_scale.{i}.2")} for i in range(n_up)],
        "cond_shift": [{"c1": _conv(sd, f"condition_shift.{i}.0"),
                        "c2": _conv(sd, f"condition_shift.{i}.2")} for i in range(n_up)],
        "final_linear": _lin(sd, "final_linear"),
        "gan": gan,
    }


def convert_gagavatar(sd: StateDict) -> dict:
    """Full GAGAvatar.pt 'model' state dict -> GAGAvatar params."""
    return {
        "base_model": convert_dino_dpt(_subdict(sd, "base_model.")),
        "head_base": sd["head_base"],
        "gs_generator_g": convert_gs_generator_linear(_subdict(sd, "gs_generator_g.")),
        "gs_generator_l0": convert_gs_generator_conv(_subdict(sd, "gs_generator_l0.")),
        "gs_generator_l1": convert_gs_generator_conv(_subdict(sd, "gs_generator_l1.")),
        "upsampler": convert_style_unet(_subdict(sd, "upsampler.")),
    }


# ---------------------------------------------------------------------------
# Mimi codec encoder (HF MimiModel state dict -> MimiEncoder params)
# ---------------------------------------------------------------------------


def convert_mimi(sd: StateDict, num_residual_layers: int = 1,
                 num_ratios: int = 4, num_layers: int = 8) -> dict:
    """HF MimiModel state dict -> MimiEncoder params (encode path; decoder
    weights are ignored)."""

    def conv_at(idx, bias=True):
        p = {"w": sd[f"encoder.layers.{idx}.conv.weight"]}
        key = f"encoder.layers.{idx}.conv.bias"
        if bias and key in sd:
            p["b"] = sd[key]
        return p

    blocks = []
    idx = 1
    for _ in range(num_ratios):
        res = []
        for j in range(num_residual_layers):
            res.append({
                "conv1": {"w": sd[f"encoder.layers.{idx}.block.1.conv.weight"],
                          "b": sd[f"encoder.layers.{idx}.block.1.conv.bias"]},
                "conv2": {"w": sd[f"encoder.layers.{idx}.block.3.conv.weight"],
                          "b": sd[f"encoder.layers.{idx}.block.3.conv.bias"]},
            })
            idx += 1
        idx += 1  # ELU
        down = conv_at(idx)
        idx += 1
        blocks.append({"resnets": res, "down": down})
    idx += 1  # final ELU
    seanet = {
        "init_conv": conv_at(0),
        "blocks": blocks,
        "final_conv": conv_at(idx),
    }

    layers = []
    for i in range(num_layers):
        pre = f"encoder_transformer.layers.{i}"
        layers.append({
            "q": _lin(sd, f"{pre}.self_attn.q_proj", bias=False),
            "k": _lin(sd, f"{pre}.self_attn.k_proj", bias=False),
            "v": _lin(sd, f"{pre}.self_attn.v_proj", bias=False),
            "o": _lin(sd, f"{pre}.self_attn.o_proj", bias=False),
            "norm1": _ln(sd, f"{pre}.input_layernorm"),
            "norm2": _ln(sd, f"{pre}.post_attention_layernorm"),
            "fc1": _lin(sd, f"{pre}.mlp.fc1", bias=False),
            "fc2": _lin(sd, f"{pre}.mlp.fc2", bias=False),
            "ls_attn": sd[f"{pre}.self_attn_layer_scale.scale"],
            "ls_mlp": sd[f"{pre}.mlp_layer_scale.scale"],
        })

    def rvq(prefix):
        n = 0
        while f"quantizer.{prefix}.layers.{n}.codebook.embed_sum" in sd:
            n += 1
        return {
            "embed_sum": np.stack([
                sd[f"quantizer.{prefix}.layers.{q}.codebook.embed_sum"]
                for q in range(n)]),
            "cluster_usage": np.stack([
                sd[f"quantizer.{prefix}.layers.{q}.codebook.cluster_usage"]
                for q in range(n)]),
            "input_proj": {"w": sd[f"quantizer.{prefix}.input_proj.weight"]},
            "output_proj": {"w": sd[f"quantizer.{prefix}.output_proj.weight"]},
        }

    return {
        "seanet": seanet,
        "transformer": _stack(layers),
        "downsample": {"w": sd["downsample.conv.weight"]},
        "semantic_rvq": rvq("semantic_residual_vector_quantizer"),
        "acoustic_rvq": rvq("acoustic_residual_vector_quantizer"),
    }
