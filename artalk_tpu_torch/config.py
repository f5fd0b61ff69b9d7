"""Typed configuration, same JSON schema as ``artalk_tpu/config.py``.

Reference-format ``config.json`` files load verbatim. The dataclasses mirror
the JAX package's field for field. ``MimiEncoderConfig`` lives here (the JAX
package keeps it in ``models/mimi.py`` and imports it lazily to break an
import cycle), so ``ModelConfig.mimi`` takes a plain default.
``WhisperEncoderConfig`` (``AUDIO_ENCODER: "whisper"``) is the port's own: the
JAX package has no Whisper encoder. Its JSON form is the ``WHISPER_CONFIG``
group of ``config.json`` under Hugging Face's ``WhisperConfig`` key names,
written only for a Whisper-conditioned model.

The precision mode is read from the environment here and nowhere else
(``precision_from_env``).
"""

from __future__ import annotations

import dataclasses
import json
import os
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

    @property
    def total_tokens(self) -> int:
        """Sum of all scales = AR slots per window (181 for the default schedule)."""
        return int(sum(self.patch_nums))

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

    def to_json_dict(self) -> dict:
        """The reference's ``VAE_CONFIG`` form (``from_json_dict``'s inverse)."""
        return {
            "MOTION_DIM": self.motion_dim,
            "V_CODE_DIM": self.code_dim,
            "T_DEPTH": self.depth,
            "T_NUM_HEADS": self.num_heads,
            "T_HIDDEN_DIM": self.hidden_dim,
            "V_PATCH_NUMS": list(self.patch_nums),
        }


@dataclasses.dataclass(frozen=True)
class ARConfig:
    """Autoregressive generator config (reference: assets/config.json AR_CONFIG)."""

    depth: int = 12
    num_heads: int = 12
    prev_ratio: int = 1
    audio_encoder: str = "wav2vec"  # 'wav2vec' | 'mimi' | 'whisper'
    embed_dim: int = 768
    style_dim: int = 128
    mlp_ratio: float = 4.0
    audio_dim: int | None = None    # override conditioning width (tests/small models)

    @property
    def audio_feature_dim(self) -> int:
        if self.audio_dim is not None:
            return self.audio_dim
        return {"wav2vec": 1024, "mimi": 512, "whisper": 1280}[self.audio_encoder]

    @classmethod
    def from_json_dict(cls, d: dict) -> "ARConfig":
        return cls(
            depth=d.get("T_DEPTH", 12),
            num_heads=d.get("T_NUM_HEADS", 12),
            prev_ratio=d.get("PREV_RATIO", 1),
            audio_encoder=d.get("AUDIO_ENCODER", "wav2vec"),
        )

    def to_json_dict(self) -> dict:
        """The reference's ``AR_CONFIG`` form (the widths it fixes are not in it)."""
        return {
            "T_DEPTH": self.depth,
            "T_NUM_HEADS": self.num_heads,
            "PREV_RATIO": self.prev_ratio,
            "AUDIO_ENCODER": self.audio_encoder,
        }


@dataclasses.dataclass(frozen=True)
class Wav2VecConfig:
    """wav2vec2-xls-r-300m architecture constants (no network access needed)."""

    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"   # "layer" (xls-r) | "group" (base/HuBERT)
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = True  # pre-LN (xls-r) | post-LN (base/HuBERT)
    layer_norm_eps: float = 1e-5
    # the layer loop's attention through the flash-attention kernel
    # (ops/attention.py) instead of the plain softmax
    use_flash_attention: bool = False

    def num_output_frames(self, num_samples: int) -> int:
        """Output sequence length of the conv feature extractor."""
        length = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            length = (length - k) // s + 1
        return length


def hubert_base_config(**overrides) -> Wav2VecConfig:
    """facebook/hubert-base-ls960 architecture constants: group-norm conv0,
    bias-free convs, post-LN 12-layer 768-wide encoder."""
    kwargs = dict(
        conv_dim=(512, 512, 512, 512, 512, 512, 512),
        conv_stride=(5, 2, 2, 2, 2, 2, 2),
        conv_kernel=(10, 3, 3, 3, 3, 2, 2),
        conv_bias=False,
        feat_extract_norm="group",
        hidden_size=768,
        num_hidden_layers=12,
        num_attention_heads=12,
        intermediate_size=3072,
        num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16,
        do_stable_layer_norm=False,
    )
    kwargs.update(overrides)
    return Wav2VecConfig(**kwargs)


@dataclasses.dataclass(frozen=True)
class MimiEncoderConfig:
    """Mimi codec encode path (HF ``MimiModel`` defaults): SEANet, an 8-layer
    RoPE transformer with a sliding window, split RVQ of 32 codebooks."""

    sampling_rate: int = 24000
    num_filters: int = 64
    num_residual_layers: int = 1
    ratios: Sequence[int] = (8, 6, 5, 4)   # upsampling_ratios (decoder order)
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    compress: int = 2
    hidden_size: int = 512
    num_hidden_layers: int = 8
    num_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 2048
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: int = 250
    layer_scale: float = 0.01

    def num_output_frames(self, samples_24k: int) -> int:
        length = samples_24k
        for ratio in reversed(self.ratios):
            length = -(-length // ratio)
        return -(-length // 2)  # final stride-2 downsample


@dataclasses.dataclass(frozen=True)
class WhisperEncoderConfig:
    """Whisper large-v3's encoder (``openai/whisper-large-v3``: config.json and
    preprocessor_config.json): a 128-bin log-mel front over exactly
    ``chunk_length`` seconds of 16 kHz audio, two GELU convolutions (the
    second of stride 2), fixed sinusoidal positions, 32 pre-LN layers of 1280
    with 20 heads and FFN 5120, a final LayerNorm. ``chunk_length`` may be
    cut for small models (tests); ``max_source_positions`` must be half the
    mel frames it gives."""

    num_mel_bins: int = 128
    n_fft: int = 400
    hop_length: int = 160
    sampling_rate: int = 16000
    chunk_length: float = 30.0
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    max_source_positions: int = 1500
    layer_norm_eps: float = 1e-5

    @property
    def n_samples(self) -> int:
        """Samples of the encoder's fixed input (480,000 at 30 s)."""
        return int(round(self.chunk_length * self.sampling_rate))

    @property
    def n_frames(self) -> int:
        """Mel frames of that input (3,000): the STFT's frames less the last."""
        return self.n_samples // self.hop_length

    def window_positions(self, window_samples: int) -> int:
        """Encoder positions (50 Hz) that cover the last ``window_samples``
        of the input: 200 for a 4-s window."""
        return window_samples // (2 * self.hop_length)

    @classmethod
    def from_json_dict(cls, d: dict) -> "WhisperEncoderConfig":
        """The ``WHISPER_CONFIG`` group: HF ``WhisperConfig`` /
        ``WhisperFeatureExtractor`` key names, published defaults."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"WHISPER_CONFIG: unknown keys {sorted(unknown)}")
        return cls(**d)

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Top-level model config bundling AR + VAE + audio sub-configs, with the
    JAX config's precision switches (``precision_from_env`` sets them from the
    ``ARTALK_AR_PRECISION`` / ``ARTALK_AR_FUSED`` environment variables)."""

    ar: ARConfig = dataclasses.field(default_factory=ARConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    wav2vec: Wav2VecConfig = dataclasses.field(default_factory=Wav2VecConfig)
    mimi: MimiEncoderConfig = dataclasses.field(default_factory=MimiEncoderConfig)
    whisper: WhisperEncoderConfig = dataclasses.field(default_factory=WhisperEncoderConfig)
    fps: float = 25.0
    sample_rate: int = 16000
    # run the wav2vec2 or Whisper encoder in bfloat16 (norm statistics,
    # softmax and Whisper's log-mel front stay float32). Changes code bits
    # against float32; opt-in.
    bf16_audio: bool = False
    # run the AR blocks of the window decode in bfloat16; the head and the
    # inter-level arithmetic stay float32. Opt-in.
    bf16_ar: bool = False
    # run each scale level's 12 blocks as one launch of the block-stack
    # kernel (ops/ar_block_stack.py) and each window's encoder layers as one
    # launch of ops/encoder_block_stack.py. Tested to atol, not bit-pinned.
    fused_ar: bool = False
    # weight-only int8 packs for both block-stack kernels (symmetric, per
    # output channel; bf16 compute). Only the fused paths read them.
    int8_ar: bool = False

    @property
    def window_audio_samples(self) -> int:
        """Audio samples per AR window (64 000 for the default schedule)."""
        return int(self.vae.window / self.fps * self.sample_rate)

    @classmethod
    def from_json_dict(cls, d: dict) -> "ModelConfig":
        ar = ARConfig.from_json_dict(d.get("AR_CONFIG", {}))
        whisper = WhisperEncoderConfig.from_json_dict(d.get("WHISPER_CONFIG", {}))
        if ar.audio_encoder == "whisper" and whisper.d_model != ar.audio_feature_dim:
            # the AdaLN input is the encoder's width
            ar = dataclasses.replace(ar, audio_dim=whisper.d_model)
        return cls(ar=ar, vae=VAEConfig.from_json_dict(d.get("VAE_CONFIG", {})),
                   whisper=whisper)

    def to_json_dict(self) -> dict:
        """The reference's ``config.json`` form: ``load_config`` reads it back
        (with ``WHISPER_CONFIG`` for a Whisper-conditioned model)."""
        out = {"AR_CONFIG": self.ar.to_json_dict(), "VAE_CONFIG": self.vae.to_json_dict()}
        if self.ar.audio_encoder == "whisper":
            out["WHISPER_CONFIG"] = self.whisper.to_json_dict()
        return out


def load_config(path: str) -> ModelConfig:
    """Load a reference-format config.json into a typed ModelConfig."""
    with open(path) as f:
        return ModelConfig.from_json_dict(json.load(f))


def assets_config(assets_dir: str) -> ModelConfig:
    """``<assets_dir>/config.json``, or the production ``ModelConfig()``
    where there is none."""
    path = os.path.join(assets_dir, "config.json")
    return load_config(path) if os.path.exists(path) else ModelConfig()


def precision_from_env(config: ModelConfig) -> ModelConfig:
    """``config`` with the environment's precision mode switched on, as the
    JAX engine reads it: ``ARTALK_AR_PRECISION`` = ``exact`` (the default) /
    ``fast`` (``bf16_audio``, ``bf16_ar``) / ``int8`` (fast, ``int8_ar`` and
    ``fused_ar``), and ``ARTALK_AR_FUSED=1`` (``fused_ar``). "fast" and
    "int8" change the code bits against "exact". The one reader of these
    variables."""
    ar_prec = os.environ.get("ARTALK_AR_PRECISION", "exact")
    if ar_prec not in ("exact", "fast", "int8"):
        raise ValueError(
            f"ARTALK_AR_PRECISION={ar_prec!r}: expected 'exact', 'fast' or 'int8'")
    if ar_prec in ("fast", "int8"):
        config = dataclasses.replace(config, bf16_audio=True, bf16_ar=True)
    if ar_prec == "int8":
        config = dataclasses.replace(config, int8_ar=True, fused_ar=True)
    if os.environ.get("ARTALK_AR_FUSED", "0") not in ("0", ""):
        config = dataclasses.replace(config, fused_ar=True)
    return config


def precision_mode(config: ModelConfig) -> str:
    """The name of ``config``'s precision mode: "exact", "fused" (float32
    packs), "fast", "fast+fused" or "int8"."""
    if config.int8_ar:
        return "int8"
    name = "fast" if config.bf16_ar else "exact"
    if config.fused_ar:
        return "fused" if name == "exact" else name + "+fused"
    return name
