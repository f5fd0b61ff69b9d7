"""The system under test, built as a user builds it: the port's engine on one
card, from the configuration's widths, the seeded parameters and the FLAME
asset the benchmark writes. Nothing here measures; the drivers do.

The precision switches of the cell are set in the environment before the
engine is built, as a deployment sets them (``ARTALK_AR_PRECISION``,
``ARTALK_AR_FUSED``, ``ARTALK_GAGA_PRECISION``; unset means the default).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .harness import BENCH
from .reference.mesh import synthetic_flame
from .reference.gaga import gaga_spec, synthetic_avatar
from .reference.params import make_params, motion_spec

ASSETS = BENCH / "_cache" / "assets"
SWITCHES = ("ARTALK_AR_PRECISION", "ARTALK_AR_FUSED", "ARTALK_GAGA_PRECISION")


def set_precision(cell: dict) -> None:
    for key in SWITCHES:
        os.environ.pop(key, None)
    for key, value in cell.get("precision", {}).items():
        if key not in SWITCHES:
            raise ValueError(f"unknown precision switch {key}")
        os.environ[key] = str(value)


def assets_dir(model: dict) -> Path:
    """A directory holding the FLAME asset of the configuration as
    ``flame.npz`` (written once per checkout, at a fixed path)."""
    flame = model["flame"]
    path = ASSETS / f"flame_v{flame['num_verts']}_seed{flame['asset_seed']}"
    target = path / "flame.npz"
    if not target.exists():
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / f"flame.{os.getpid()}.npz"
        np.savez(tmp, **synthetic_flame(flame["num_verts"], flame["asset_seed"]))
        os.replace(tmp, target)
    return path


def model_config(model: dict):
    """The port's ``ModelConfig`` at the configuration's widths."""
    from artalk_tpu_torch.config import ARConfig, ModelConfig, VAEConfig, Wav2VecConfig

    ar, vae, w = model["ar"], model["vae"], model["wav2vec"]
    return ModelConfig(
        ar=ARConfig(depth=ar["depth"], num_heads=ar["num_heads"], prev_ratio=ar["prev_ratio"],
                    audio_encoder="wav2vec", embed_dim=ar["embed_dim"],
                    style_dim=ar["style_dim"], mlp_ratio=ar["mlp_ratio"],
                    audio_dim=ar["audio_dim"]),
        vae=VAEConfig(motion_dim=vae["motion_dim"], code_dim=vae["code_dim"],
                      depth=vae["depth"], num_heads=vae["num_heads"],
                      hidden_dim=vae["hidden_dim"], patch_nums=tuple(vae["patch_nums"])),
        wav2vec=Wav2VecConfig(
            conv_dim=tuple(w["conv_dim"]), conv_stride=tuple(w["conv_stride"]),
            conv_kernel=tuple(w["conv_kernel"]), hidden_size=w["hidden_size"],
            num_hidden_layers=w["num_hidden_layers"],
            num_attention_heads=w["num_attention_heads"],
            intermediate_size=w["intermediate_size"],
            num_conv_pos_embeddings=w["num_conv_pos_embeddings"],
            num_conv_pos_embedding_groups=w["num_conv_pos_embedding_groups"],
            layer_norm_eps=w["layer_norm_eps"]),
        fps=float(model["fps"]), sample_rate=int(model["sample_rate"]))


def motion_params_host(model: dict, seed: int, device: torch.device) -> dict:
    """The seeded motion parameters, drawn on ``device`` and handed over as
    host arrays (the engine's ``params`` takes a checkpoint's flat dict)."""
    return _host(make_params(motion_spec(model), seed, device))


def _host(params: dict) -> dict:
    """Host arrays of seeded parameters, through one copy of their buffer."""
    host = next(iter(params.values()))._base.cpu()
    out, start = {}, 0
    for key, t in params.items():
        out[key] = host[start:start + t.numel()].view(t.shape).numpy()
        start += t.numel()
    return out


def build_engine(model: dict, cell: dict, seed: int, device: torch.device):
    """The port's engine as the cell runs it; with a ``gagavatar`` group in
    the configuration, the GAGAvatar renderer too, on the seeded weights."""
    from artalk_tpu_torch.engine import ARTAvatarInferEngine

    set_precision(cell)
    engine = ARTAvatarInferEngine(
        load_gaga=False, clip_length=int(model["clip_length"]), assets_dir=str(assets_dir(model)),
        output_dir=str(BENCH / "_cache" / "out"), config=model_config(model),
        params=motion_params_host(model, seed, device),
        image_size=int(model["renderer"]["image_size"]), seed=int(seed) % 2**31, device=device)
    if "gagavatar" in model:
        add_gagavatar(engine, model, seed, device)
    return engine


def gaga_params_host(seed: int, device: torch.device) -> dict:
    return _host(make_params(gaga_spec(), seed, device, tag=2))


def add_gagavatar(engine, model: dict, seed: int, device: torch.device) -> None:
    """The GAGAvatar renderer of ``ARTAvatarInferEngine(load_gaga=True)``,
    built on the seeded weights (the engine's own would be random from a
    fixed seed, drawn on the host): ``engine.gagavatar`` and the FLAME at
    GAGAvatar's world scale."""
    from artalk_tpu_torch.models.flame import FlameModel
    from artalk_tpu_torch.models.gagavatar import GAGAvatar

    g = model["gagavatar"]
    bank = Path(engine.assets_dir) / "avatars"
    target = bank / f"{g['avatar']}.npz"
    if not target.exists():
        bank.mkdir(parents=True, exist_ok=True)
        tmp = bank / f"avatar.{os.getpid()}.npz"
        np.savez_compressed(tmp, **synthetic_avatar(g["avatar_seed"]))
        os.replace(tmp, target)
    engine.gagavatar = GAGAvatar(assets_dir=engine.assets_dir,
                                 params=gaga_params_host(seed, device), device=device)
    flame = dict(np.load(Path(engine.assets_dir) / "flame.npz"))
    engine.gagavatar_flame = FlameModel(flame, n_shape=300, n_exp=100,
                                        scale=float(g["world_scale"])).to(device)
