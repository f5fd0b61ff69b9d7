"""Typed configuration, same JSON schema as ``artalk_tpu/config.py``.

Reference-format ``config.json`` files load verbatim. The dataclasses mirror
the JAX package's field for field, except that ``ModelConfig`` has no
``mimi`` field yet: the mimi encoder is not ported (ROADMAP.md Queue 1
item 12), and the JAX default for that field pulls in jax.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """BITWISE_VAE motion tokenizer config (reference: assets/config.json VAE_CONFIG)."""

    motion_dim: int = 106
    code_dim: int = 32
    depth: int = 8
    num_heads: int = 8
    hidden_dim: int = 512
    patch_nums: Sequence[int] = (1, 5, 25, 50, 100)

    @property
    def window(self) -> int:
        """Frames per AR window = finest scale."""
        return int(self.patch_nums[-1])

    @classmethod
    def from_json_dict(cls, d: dict) -> "VAEConfig":
        return cls(
            motion_dim=d.get("MOTION_DIM", 106),
            code_dim=d.get("V_CODE_DIM", 32),
            depth=d.get("T_DEPTH", 8),
            num_heads=d.get("T_NUM_HEADS", 8),
            hidden_dim=d.get("T_HIDDEN_DIM", 512),
            patch_nums=tuple(d.get("V_PATCH_NUMS", (1, 5, 25, 50, 100))),
        )


@dataclasses.dataclass(frozen=True)
class ARConfig:
    """Autoregressive generator config (reference: assets/config.json AR_CONFIG)."""

    depth: int = 12
    num_heads: int = 12
    prev_ratio: int = 1
    audio_encoder: str = "wav2vec"  # 'wav2vec' | 'mimi' (mimi not ported yet)
    embed_dim: int = 768
    style_dim: int = 128
    mlp_ratio: float = 4.0
    audio_dim: int | None = None    # override conditioning width (tests/small models)

    @property
    def audio_feature_dim(self) -> int:
        if self.audio_dim is not None:
            return self.audio_dim
        return {"wav2vec": 1024, "mimi": 512}[self.audio_encoder]

    @classmethod
    def from_json_dict(cls, d: dict) -> "ARConfig":
        return cls(
            depth=d.get("T_DEPTH", 12),
            num_heads=d.get("T_NUM_HEADS", 12),
            prev_ratio=d.get("PREV_RATIO", 1),
            audio_encoder=d.get("AUDIO_ENCODER", "wav2vec"),
        )


@dataclasses.dataclass(frozen=True)
class Wav2VecConfig:
    """wav2vec2-xls-r-300m architecture constants (no network access needed)."""

    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"   # only "layer" is ported
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = True  # only the stable (pre-LN) layout is ported
    layer_norm_eps: float = 1e-5
    use_flash_attention: bool = False  # flash kernel not ported yet

    def num_output_frames(self, num_samples: int) -> int:
        """Output sequence length of the conv feature extractor."""
        length = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            length = (length - k) // s + 1
        return length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Top-level model config bundling AR + VAE + audio sub-configs.

    The JAX config's precision switches (``bf16_audio``, ``bf16_ar``,
    ``fused_ar``, ``int8_ar``) are not here: their kernels are not ported yet
    (ROADMAP.md Queue 1 item 8), and the engine raises for the environment
    switches that set them."""

    ar: ARConfig = dataclasses.field(default_factory=ARConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    wav2vec: Wav2VecConfig = dataclasses.field(default_factory=Wav2VecConfig)
    fps: float = 25.0
    sample_rate: int = 16000

    @property
    def window_audio_samples(self) -> int:
        """Audio samples per AR window (64 000 for the default schedule)."""
        return int(self.vae.window / self.fps * self.sample_rate)

    @classmethod
    def from_json_dict(cls, d: dict) -> "ModelConfig":
        return cls(
            ar=ARConfig.from_json_dict(d.get("AR_CONFIG", {})),
            vae=VAEConfig.from_json_dict(d.get("VAE_CONFIG", {})),
        )


def load_config(path: str) -> ModelConfig:
    """Load a reference-format config.json into a typed ModelConfig."""
    with open(path) as f:
        return ModelConfig.from_json_dict(json.load(f))
