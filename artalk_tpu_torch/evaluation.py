"""Motion quality metrics: LVE, FDD, beat alignment, diversity.

Counterpart of ``artalk_tpu/evaluation.py`` (numpy at module level, but part
of a package that imports jax, so the metrics are copied here). The standard
speech-to-motion metrics over the port's FLAME geometry:

- **LVE** (lip vertex error): mean over frames of the max L2 error over the
  lip vertices, prediction against ground truth.
- **FDD** (upper-face dynamics deviation): mean over the upper-face vertices
  of the difference in temporal standard deviation of per-vertex motion.
- **BA** (beat alignment): mean over audio onsets of a Gaussian reward on the
  distance to the nearest motion-velocity minimum; 0 to 1.
- **Diversity**: mean pairwise L2 between motion clips generated for the same
  audio.

Region index sets come from the FLAME landmark tables at the template pose
(mouth = landmarks 48:68 of the 70-point convention, brows = 17:27), or from
a geometric fallback when the asset has no landmark tables (the synthetic
asset). The vertices come from the port's FLAME on an explicit device.

CLI: ``python -m artalk_tpu_torch.evaluation pred.npy gt.npy [--audio x.wav]
[--assets assets]`` ((T, 106) motions; prints one JSON object of metrics; runs
on cuda).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch


# --------------------------------------------------------------------- regions


def _template_landmarks(flame) -> Optional[np.ndarray]:
    """(70, 3) template landmarks from the asset's tables, None without them."""
    if flame.lmk_faces_idx is None:
        return None
    with torch.no_grad():
        return flame.landmarks(flame.v_template[None], refine_eyes=False)[0].cpu().numpy()


def lip_vertex_indices(flame, radius_scale: float = 1.2) -> np.ndarray:
    """Vertices within ``radius_scale`` times the mouth radius of the mouth
    centre (landmarks 48:68); without landmark tables, the front-lower face
    (z above its 70th percentile, y below its 30th)."""
    v = flame.v_template.cpu().numpy()
    lmk = _template_landmarks(flame)
    if lmk is not None:
        mouth = lmk[48:68]
        center = mouth.mean(axis=0)
        radius = np.linalg.norm(mouth - center, axis=1).max() * radius_scale
        d = np.linalg.norm(v - center, axis=1)
        return np.nonzero(d <= radius)[0]
    front = v[:, 2] >= np.quantile(v[:, 2], 0.70)
    low = v[:, 1] <= np.quantile(v[:, 1], 0.30)
    return np.nonzero(front & low)[0]


def upper_face_vertex_indices(flame) -> np.ndarray:
    """Vertices at or above the brow line (landmarks 17:27), or above the
    60th y-percentile without landmark tables."""
    v = flame.v_template.cpu().numpy()
    lmk = _template_landmarks(flame)
    brow_y = lmk[17:27, 1].min() if lmk is not None else np.quantile(v[:, 1], 0.60)
    return np.nonzero(v[:, 1] >= brow_y)[0]


# --------------------------------------------------------------------- metrics


def lip_vertex_error(pred_verts: np.ndarray, gt_verts: np.ndarray,
                     lip_idx: np.ndarray) -> float:
    """Mean over frames of the max lip-vertex L2 error. (T, V, 3) inputs."""
    pred = np.asarray(pred_verts)[:, lip_idx]
    gt = np.asarray(gt_verts)[:, lip_idx]
    err = np.linalg.norm(pred - gt, axis=-1)          # (T, L)
    return float(err.max(axis=1).mean())


def upper_face_dynamics_deviation(pred_verts: np.ndarray, gt_verts: np.ndarray,
                                  upper_idx: np.ndarray) -> float:
    """Mean |std_t(pred) - std_t(gt)| of per-vertex motion magnitude."""

    def _dyn(v):
        v = np.asarray(v)[:, upper_idx]                # (T, U, 3)
        disp = np.linalg.norm(v - v.mean(axis=0, keepdims=True), axis=-1)
        return disp.std(axis=0)                        # (U,)

    return float(np.abs(_dyn(pred_verts) - _dyn(gt_verts)).mean())


def audio_onsets(audio: np.ndarray, sr: int = 16000, frame: int = 512,
                 hop: int = 256) -> np.ndarray:
    """Onset times (seconds) by spectral-flux peak picking."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    if len(audio) < frame:
        return np.zeros((0,))
    n = 1 + (len(audio) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    frames = audio[idx] * np.hanning(frame)[None, :]
    mag = np.abs(np.fft.rfft(frames, axis=1))
    flux = np.maximum(0.0, np.diff(mag, axis=0)).sum(axis=1)  # (n-1,)
    if flux.size < 3:
        return np.zeros((0,))
    thresh = flux.mean() + flux.std()
    peaks = [i for i in range(1, len(flux) - 1)
             if flux[i] >= thresh and flux[i] >= flux[i - 1] and flux[i] > flux[i + 1]]
    return (np.asarray(peaks, np.float64) + 1) * hop / sr


def motion_beats(motion: np.ndarray, fps: float = 25.0) -> np.ndarray:
    """Beat times (seconds): local minima of the motion velocity magnitude."""
    motion = np.asarray(motion, np.float32)
    vel = np.linalg.norm(np.diff(motion, axis=0), axis=-1)     # (T-1,)
    if vel.size < 3:
        return np.zeros((0,))
    beats = [t for t in range(1, len(vel) - 1)
             if vel[t] <= vel[t - 1] and vel[t] < vel[t + 1]]
    return np.asarray(beats, np.float64) / fps


def beat_alignment(motion: np.ndarray, audio: np.ndarray, sr: int = 16000,
                   fps: float = 25.0, sigma: float = 0.1) -> float:
    """Mean Gaussian reward on each audio onset's distance to the nearest
    motion beat."""
    onsets = audio_onsets(audio, sr)
    beats = motion_beats(motion, fps)
    if onsets.size == 0 or beats.size == 0:
        return 0.0
    d = np.abs(onsets[:, None] - beats[None, :]).min(axis=1)
    return float(np.exp(-(d ** 2) / (2 * sigma ** 2)).mean())


def diversity(motion_set: np.ndarray) -> float:
    """Mean pairwise L2 between (N, T, D) motion clips (N >= 2)."""
    m = np.asarray(motion_set, np.float32)
    n = m.shape[0]
    if n < 2:
        return 0.0
    flat = m.reshape(n, -1)
    d = np.linalg.norm(flat[:, None] - flat[None, :], axis=-1)
    return float(d[np.triu_indices(n, 1)].mean())


# ------------------------------------------------------------------ end-to-end


def motion_to_vertices(flame, motion: np.ndarray, device, shape: Optional[np.ndarray] = None,
                       with_global: bool = False) -> np.ndarray:
    """(T, 106) motion -> (T, V, 3) FLAME vertices computed on ``device``
    (``flame`` must be there); no global pose by default, as LVE and FDD are
    reported with the head pose excluded."""
    motion = np.asarray(motion, np.float32)
    t = motion.shape[0]
    if shape is None:
        shape = np.zeros((t, flame.n_shape), np.float32)
    else:
        shape = np.broadcast_to(np.asarray(shape, np.float32), (t, flame.n_shape))
    with torch.no_grad():
        verts = flame.motion_to_verts(torch.from_numpy(np.ascontiguousarray(shape)).to(device),
                                      torch.from_numpy(motion).to(device),
                                      with_global=with_global)
    return verts.cpu().numpy()


def evaluate_motion(pred_motion: np.ndarray, gt_motion: np.ndarray, flame,
                    audio: Optional[np.ndarray] = None, sr: int = 16000,
                    fps: float = 25.0, device="cuda") -> dict:
    """All applicable metrics for one clip pair (BA needs ``audio``); the
    FLAME vertices are computed on ``device``, where ``flame`` must be (it is
    not moved)."""
    device = torch.device(device)
    if flame.v_template.device.type != device.type:
        raise ValueError(f"evaluate_motion: flame is on {flame.v_template.device}, "
                         f"not on {device}")
    t = min(len(pred_motion), len(gt_motion))
    pred_v = motion_to_vertices(flame, pred_motion[:t], device)
    gt_v = motion_to_vertices(flame, gt_motion[:t], device)
    lips = lip_vertex_indices(flame)
    upper = upper_face_vertex_indices(flame)
    out = {
        "frames": int(t),
        "lve": lip_vertex_error(pred_v, gt_v, lips),
        "fdd": upper_face_dynamics_deviation(pred_v, gt_v, upper),
        "lip_vertices": int(len(lips)),
        "upper_vertices": int(len(upper)),
    }
    if audio is not None:
        out["beat_align"] = beat_alignment(pred_motion[:t], audio, sr, fps)
    return out


def main(argv=None, device="cuda"):
    import argparse

    from .models.flame import FlameModel
    from .utils.assets import load_or_synthesize_flame

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("pred", help="(T, 106) motion .npy")
    p.add_argument("gt", help="(T, 106) motion .npy")
    p.add_argument("--audio", default=None, help="16 kHz mono wav/npy for beat alignment")
    p.add_argument("--assets", default="assets")
    args = p.parse_args(argv)

    flame = FlameModel(load_or_synthesize_flame(args.assets), n_shape=300, n_exp=100,
                       scale=1.0).to(device)
    audio = None
    if args.audio:
        if args.audio.endswith(".npy"):
            audio = np.load(args.audio)
        else:
            from .utils.audio import load_audio_16k_mono

            audio = load_audio_16k_mono(args.audio)
    print(json.dumps(evaluate_motion(np.load(args.pred), np.load(args.gt), flame,
                                     audio=audio, device=device)))


if __name__ == "__main__":
    main()
