"""The plain motion reference on the Whisper encoder: ``MotionReference``
with its audio condition taken from Whisper (``reference/whisper.py``)
instead of wav2vec2. A window's condition is the last 200 of the 1,500
positions of the 30 s that end with it (its own 4 s at 50 Hz), area-resized
to each scale (181 rows). Everything else, the teacher-forced AR logits, the
VAE, the carry's BSQ values and the motion, is ``MotionReference``'s.

Following a session, the reference rebuilds each window's 30 s from the
windows the session sent before it, in order (zeros before its first), so
it holds the program to the context its carry should have kept: a tick in
which the session sent nothing adds nothing. The encodes run before the
windows are followed, in blocks of rows; each window's log-mel and kept
positions are in ``follow``'s result under ``"whisper"``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .motion import FP32, MotionReference, P, Precision, precision_flags, resize
from .whisper import WhisperReference


class WhisperMotionReference(MotionReference):
    def __init__(self, cfg: dict, params: P, prec: Precision = FP32):
        super().__init__(cfg, params, prec)
        self.whisper = WhisperReference(cfg["whisper"], params, prec)
        w = cfg["whisper"]
        self.keep = cfg["window_samples"] // (2 * w["hop_length"])
        self._emb: List[torch.Tensor] = []

    def audio_condition(self, audio: torch.Tensor) -> torch.Tensor:
        """The next window of the session being followed: its kept positions
        (encoded in ``follow``) area-resized to each scale."""
        feat = self._emb.pop(0)[None]
        return torch.cat([resize(feat, n, "area") for n in self.patch_nums], dim=1)

    @torch.no_grad()
    def follow(self, audio: torch.Tensor, served: List[Tuple[torch.Tensor, torch.Tensor]],
               carry0: torch.Tensor) -> dict:
        """``MotionReference.follow`` of one session's windows ``audio`` (N,
        window samples, in the order sent), each conditioned on the 30 s that
        end with it; the result also holds the encodes (``"whisper"``: the
        log-mels (N, n_mels, frames) and kept positions (N, 200, d))."""
        with precision_flags(self.prec):
            enc = self.whisper.encode_session(audio, self.keep)
        self._emb = list(enc["emb"])
        out = super().follow(audio, served, carry0)
        out["whisper"] = enc
        return out
