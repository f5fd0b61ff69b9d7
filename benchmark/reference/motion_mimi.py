"""The plain motion reference on the Mimi encoder: ``MotionReference`` with
its audio condition taken from Mimi (``reference/mimi.py``) instead of
wav2vec2. A window's condition is the 512-d decode of its codes at 12.5 Hz
(50 frames a 4-s window), area-resized to each scale (181 rows), as ARTalk
conditions on Mimi. Everything else, the teacher-forced AR logits, the VAE,
the carry's BSQ values and the motion, is ``MotionReference``'s.

Following a stream, the reference takes each window's codes as the program
served them (teacher-forced: the condition and each RVQ stage's residual are
built from them) or, given none, decides its own (the control). Each
window's Mimi encode is kept in ``follow``'s result under ``"mimi"``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .mimi import MimiReference
from .motion import FP32, MotionReference, P, Precision, precision_flags, resize


class MimiMotionReference(MotionReference):
    def __init__(self, cfg: dict, params: P, prec: Precision = FP32):
        super().__init__(cfg, params, prec)
        self.mimi = MimiReference(cfg["mimi"], params)
        self._codes: List[Optional[torch.Tensor]] = []
        self._encoded: List[dict] = []

    def condition(self, codes: torch.Tensor) -> torch.Tensor:
        """A window's codes (1, n_q, 50) -> its condition (1, 181, 512)."""
        feat = self.mimi.decode(codes)
        return torch.cat([resize(feat, n, "area") for n in self.patch_nums], dim=1)

    def audio_condition(self, audio: torch.Tensor) -> torch.Tensor:
        """The next window of the stream being followed: its Mimi encode,
        teacher-forced on its served codes where they were given, kept; its
        condition from those codes."""
        codes = self._codes.pop(0) if self._codes else None
        enc = self.mimi.encode(audio, codes)
        self._encoded.append(enc)
        return self.condition(enc["codes"])

    @torch.no_grad()
    def follow(self, audio: torch.Tensor, served: List[Tuple[torch.Tensor, torch.Tensor]],
               carry0: torch.Tensor, codes: Optional[List[torch.Tensor]] = None) -> dict:
        """``MotionReference.follow`` with each window's served Mimi codes
        (n_q, 50), or the reference's own where ``codes`` is None; the result
        also holds each window's encode (``"mimi"``)."""
        self._codes = [None] * len(served) if codes is None else [c[None] for c in codes]
        self._encoded = []
        out = super().follow(audio, served, carry0)
        out["mimi"] = self._encoded
        return out

    @torch.no_grad()
    def code_gap(self, down: torch.Tensor, codes: torch.Tensor) -> float:
        """``MimiReference.code_gap`` at this reference's precision."""
        with precision_flags(self.prec):
            return self.mimi.code_gap(down, codes)
