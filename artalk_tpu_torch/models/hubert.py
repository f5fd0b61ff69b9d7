"""HuBERT audio encoder (the third audio-encoder variant).

Counterpart of ``artalk_tpu/models/hubert.py``: z-norm -> conv extractor ->
an optional linear resize of the conv features to a target frame count ->
feature projection -> encoder. The architecture is the wav2vec2 "base"
layout (group-norm conv0, bias-free convs, post-LN encoder;
``config.hubert_base_config``), so this is ``Wav2VecEncoder`` with that
configuration and a ``frame_num`` argument; its parameter tree is the JAX
``HubertEncoder.init`` tree. The JAX package wires it into no engine; it is a
standalone encoder here too. ``use_flash_attention`` in its configuration
routes the layers' attention through the flash-attention kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Wav2VecConfig, hubert_base_config
from ..ops.resample1d import resize_linear
from .wav2vec import Wav2VecEncoder, normalize_audio


class HubertEncoder(Wav2VecEncoder):
    def __init__(self, cfg: Optional[Wav2VecConfig] = None):
        super().__init__(cfg if cfg is not None else hubert_base_config())

    def forward(self, audio: torch.Tensor, frame_num: Optional[int] = None) -> torch.Tensor:
        """(B, T_samples) -> (B, frames, hidden). With ``frame_num`` the conv
        features are linearly resized to that length before the encoder
        (``F.interpolate(..., mode="linear", align_corners=False)``)."""
        feats = self.extract_features(normalize_audio(audio))
        if frame_num is not None:
            feats = resize_linear(feats, frame_num)
        return self.encode(feats)
