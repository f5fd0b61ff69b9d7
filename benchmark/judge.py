"""The comparison that decides ``correct``: the program's outputs against the
plain reference's, number by number, each against its limit from the cell
file.

- ``ar_bit_gap``: the widest gap by which a served code bit's logit lies
  below the reference's best logit at that position, over every bit of every
  window checked (the reference teacher-forced with the served bits).
- ``carry_bit_gap``: the same for the carry bits the VAE re-encodes after
  each window: how far the reference's BSQ value lies on the other side of
  zero from the bit the program kept.
- ``motion_err``: the largest absolute difference between the program's
  motion and the reference's, decoded from the same served bits and
  smoothed, over the reference's largest absolute value.
- ``frame_mad``: the mean absolute difference in 8-bit levels between the
  program's yuv420 frames and the reference's render of the program's
  motion, over every plane of every frame checked.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def ar_bit_gap(ref_logits: torch.Tensor, bits: torch.Tensor) -> float:
    """ref_logits (..., C, 2), bits (..., C) -> the widest gap."""
    chosen = torch.gather(ref_logits, -1, bits.long()[..., None])[..., 0]
    return float((ref_logits.amax(-1) - chosen).max())


def carry_bit_gap(ref_latent: torch.Tensor, bits: torch.Tensor) -> float:
    """ref_latent (..., C) BSQ values, bits (..., C) -> the widest distance on
    the wrong side of zero (0 where every bit agrees)."""
    sign = bits.float() * 2.0 - 1.0
    return float(torch.clamp(-ref_latent * sign, min=0.0).max())


def motion_err(program: np.ndarray, reference: np.ndarray) -> float:
    return float(np.abs(program - reference).max() / max(np.abs(reference).max(), 1e-12))


def frame_mad(program: np.ndarray, reference: np.ndarray) -> float:
    return float(np.abs(program.astype(np.int16) - reference.astype(np.int16)).mean())


def stream_numbers(followed: List[dict], served: List[List[tuple]],
                   carry0: List[torch.Tensor], first_latents: List[torch.Tensor],
                   motions: List[Optional[np.ndarray]],
                   ref_motions: List[np.ndarray]) -> Dict[str, float]:
    """The decision and motion numbers of streams (clips or sessions) the
    reference followed.
    ``followed[i]`` is ``MotionReference.follow``'s result for stream i,
    ``served[i]`` its (bits, carry) per window, ``first_latents[i]`` the
    reference's latents of the bootstrap carry ``carry0[i]``."""
    gaps, carry_gaps, errs = [0.0], [0.0], [0.0]
    for f, s, c0, l0, prog, ref in zip(followed, served, carry0, first_latents, motions,
                                       ref_motions):
        carry_gaps.append(carry_bit_gap(l0, c0))
        for logits, latent, (bits, carry) in zip(f["logits"], f["latents"], s):
            gaps.append(ar_bit_gap(logits, bits))
            carry_gaps.append(carry_bit_gap(latent, carry))
        if prog is not None:       # None: its client received nothing to compare
            errs.append(motion_err(prog, ref))
    return {"ar_bit_gap": max(gaps), "carry_bit_gap": max(carry_gaps),
            "motion_err": max(errs)}


def control_decisions(followed: dict) -> List[tuple]:
    """What a lower-precision reference would have served in the program's
    place at each window: its own best bits, and the signs of its carry
    latents."""
    return [(lg.argmax(-1).to(torch.int32), (lt > 0).to(torch.int32))
            for lg, lt in zip(followed["logits"], followed["latents"])]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number that is missing or not finite fails."""
    rows = [(k, numbers.get(k, float("nan")), limits[k]) for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
