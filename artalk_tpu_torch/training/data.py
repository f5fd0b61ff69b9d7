"""Training data pipeline: aligned (audio, motion) window sampling + prefetch.

Counterpart of ``artalk_tpu/training/data.py``. Clips of 25 fps FLAME motion
with 16 kHz audio give, per example, consecutive (prev_window, this_window)
motion pairs (stage 1), plus the aligned 4 s audio chunk and a style clip
sampled from the same clip (stage 2). ``MotionAudioDataset`` and
``synthetic_clips`` are numpy only, copied from the JAX module (which imports
jax), so one seed gives the same batches bit for bit in both packages.

``prefetch_to_device`` turns each numpy batch into CPU tensors on a host
thread (pinned when the target is a CUDA device) while the current step
runs; the consuming thread issues the copies to the device, so no copy is
enqueued from a foreign thread. Given a mesh, it keeps each rank's dp rows,
as the JAX version's ``sharding=`` places each device's.

Clips load from .npz files ({'audio': (S,), 'motion': (T, 106)}) or
in-memory arrays.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh


class MotionAudioDataset:
    def __init__(self, clips: Sequence[Tuple[np.ndarray, np.ndarray]],
                 window: int = 100, fps: float = 25.0, sample_rate: int = 16000,
                 style_frames: int = 50):
        """clips: list of (audio (S,), motion (T, D)) with S ~= T/fps*sr."""
        self.window = window
        self.fps = fps
        self.sample_rate = sample_rate
        self.style_frames = style_frames
        self.samples_per_frame = int(sample_rate / fps)
        self.clips: List[Tuple[np.ndarray, np.ndarray]] = []
        for audio, motion in clips:
            audio = np.asarray(audio, np.float32).reshape(-1)
            motion = np.asarray(motion, np.float32)
            if motion.shape[0] >= 2 * window:
                self.clips.append((audio, motion))
        if not self.clips:
            raise ValueError(f"no clip has >= {2 * window} frames")

    @classmethod
    def from_directory(cls, path: str, **kwargs) -> "MotionAudioDataset":
        clips = []
        for f in sorted(os.listdir(path)):
            if f.endswith(".npz"):
                with np.load(os.path.join(path, f)) as z:
                    clips.append((z["audio"], z["motion"]))
        return cls(clips, **kwargs)

    def sample_window_pair(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """One training example: consecutive (prev, this) windows + aligned
        audio for `this` + a style clip from elsewhere in the same clip."""
        w, spf = self.window, self.samples_per_frame
        audio, motion = self.clips[rng.integers(len(self.clips))]
        t = motion.shape[0]
        start = int(rng.integers(0, t - 2 * w + 1))
        prev = motion[start : start + w]
        this = motion[start + w : start + 2 * w]
        a0 = (start + w) * spf
        chunk = np.zeros(w * spf, np.float32)
        avail = audio[a0 : a0 + w * spf]
        chunk[: len(avail)] = avail
        s0 = int(rng.integers(0, t - self.style_frames + 1))
        style = motion[s0 : s0 + self.style_frames]
        return {"prev_motion": prev, "this_motion": this, "audio": chunk,
                "style_motion": style}

    def batches(self, batch_size: int, seed: int = 0,
                num_batches: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        produced = 0
        while num_batches is None or produced < num_batches:
            examples = [self.sample_window_pair(rng) for _ in range(batch_size)]
            yield {k: np.stack([e[k] for e in examples]) for k in examples[0]}
            produced += 1


def prefetch_to_device(batches: Iterator[Dict[str, np.ndarray]], size: int = 2,
                       device: Union[str, torch.device] = "cuda",
                       mesh: Optional[DeviceMesh] = None, axis: int = 0
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield ``batches`` as tensors on ``device``, at most ``size`` batches
    ahead. A host thread makes the CPU tensors (pinned for a CUDA device);
    this generator, in the caller's thread, copies each to the device
    (non-blocking from pinned memory). An exception in ``batches`` is raised
    here. With ``mesh`` each array is cut along ``axis`` to this rank's dp
    rows (the rows of dp index r of dp: [r * n, (r + 1) * n)), what the
    mesh-aware train steps take; every rank passes the same global batches."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    dp, r = (1, 0) if mesh is None else (mesh.size(0), mesh.get_local_rank("dp"))

    def rows(v: np.ndarray) -> np.ndarray:
        if v.shape[axis] % dp:
            raise ValueError(f"a batch of {v.shape[axis]} rows does not split over dp={dp}")
        n = v.shape[axis] // dp
        return np.take(v, np.arange(r * n, (r + 1) * n), axis=axis)

    def producer():
        try:
            for batch in batches:
                tensors = {k: torch.from_numpy(np.ascontiguousarray(rows(v)))
                           for k, v in batch.items()}
                if pin:
                    tensors = {k: v.pin_memory() for k, v in tensors.items()}
                q.put(tensors)
        except Exception as exc:  # handed to the consumer, which raises it
            q.put(exc)
        finally:
            q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, Exception):
            raise item
        yield {k: v.to(device, non_blocking=pin) for k, v in item.items()}


def synthetic_clips(num_clips: int = 4, frames: int = 400, motion_dim: int = 106,
                    fps: float = 25.0, sample_rate: int = 16000,
                    seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Smooth random (audio, motion) clips for tests and smoke training."""
    rng = np.random.default_rng(seed)
    clips = []
    for _ in range(num_clips):
        t = np.arange(frames)[:, None] / fps
        freqs = rng.uniform(0.3, 3.0, (1, motion_dim))
        phase = rng.uniform(0, 2 * np.pi, (1, motion_dim))
        motion = (np.sin(2 * np.pi * freqs * t + phase)
                  * rng.uniform(0.05, 0.5, (1, motion_dim))).astype(np.float32)
        samples = int(frames / fps * sample_rate)
        audio = (rng.standard_normal(samples) * 0.1).astype(np.float32)
        clips.append((audio, motion))
    return clips
