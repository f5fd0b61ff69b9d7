"""Host-side video muxing of yuv420p frames, from ``artalk_tpu/utils/video.py``.

H.264 (yuv420p, crf 18) + AAC as the reference writes it, behind one function
that degrades gracefully:

1. PyAV (if installed) -- H.264 + AAC, same settings as the reference.
2. ffmpeg CLI (if on PATH) -- same codecs via a rawvideo pipe.
3. Fallback: .npz of frames + audio (lossless, always available; the JAX
   package's ``read_video_npz`` reads it).

The JAX package's native Y4M tier (its C++ runtime) is not ported yet, and
only the renderer's yuv420p planes are written (the JAX writer also takes RGB).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np


def _have_av() -> bool:
    try:
        import av  # noqa: F401
        return True
    except ImportError:
        return False


def write_video(frames: np.ndarray, path: str, fps: float = 25.0,
                audio: Optional[np.ndarray] = None, sample_rate: int = 16000,
                acodec: str = "aac") -> str:
    """frames: (T, H * 3 // 2, W) uint8 planar yuv420p, BT.601 full range
    (ops/colorspace.py). Returns the path actually written."""
    frames = np.ascontiguousarray(frames)
    assert frames.ndim == 3 and frames.dtype == np.uint8, (frames.shape, frames.dtype)
    if _have_av():
        _write_av(frames, path, fps, audio, sample_rate, acodec)
        return path
    if shutil.which("ffmpeg"):
        _write_ffmpeg(frames, path, fps, audio, sample_rate)
        return path
    alt = os.path.splitext(path)[0] + ".npz"
    np.savez_compressed(alt, frames=frames, fps=fps,
                        audio=audio if audio is not None else np.zeros(0, np.float32),
                        sample_rate=sample_rate, pix_fmt="yuv420")
    return alt


def _write_av(frames, path, fps, audio, sample_rate, acodec):
    import av

    container = av.open(path, mode="w")
    stream = container.add_stream("h264", rate=fps)
    stream.width = frames.shape[2]
    stream.height = frames.shape[1] * 2 // 3
    stream.pix_fmt = "yuv420p"
    stream.options = {"crf": "18"}
    # the planes are BT.601 FULL range; signal it so decoders don't expand
    # 0-255 as if it were limited/tv range
    try:
        stream.codec_context.color_range = 2  # AVCOL_RANGE_JPEG
    except (AttributeError, ValueError):  # pragma: no cover - PyAV version
        pass
    audio_stream = None
    if audio is not None:
        audio_stream = container.add_stream(acodec if acodec == "aac" else "mp3",
                                            rate=sample_rate)
        audio_stream.format = "fltp"
    for frame in frames:
        for packet in stream.encode(av.VideoFrame.from_ndarray(frame, format="yuv420p")):
            container.mux(packet)
    if audio is not None:
        audio = np.asarray(audio, np.float32)
        spf = int(sample_rate // fps)
        for i in range(0, len(audio), spf):
            chunk = audio[i : i + spf]
            if len(chunk) < spf:
                chunk = np.pad(chunk, (0, spf - len(chunk)))
            af = av.AudioFrame.from_ndarray(chunk[None], format="fltp", layout="mono")
            af.rate = sample_rate
            for packet in audio_stream.encode(af):
                container.mux(packet)
    for packet in stream.encode():
        container.mux(packet)
    if audio is not None:
        for packet in audio_stream.encode():
            container.mux(packet)
    container.close()


def _write_ffmpeg(frames, path, fps, audio, sample_rate):
    t, h32, w = frames.shape
    h = h32 * 2 // 3
    audio_args = []
    audio_file = None
    if audio is not None:
        audio_file = path + ".pcm"
        np.asarray(audio, np.float32).tofile(audio_file)
        audio_args = ["-f", "f32le", "-ar", str(sample_rate), "-ac", "1",
                      "-i", audio_file, "-c:a", "aac", "-shortest"]
    # full-range planes: declare the input range and keep it on output so
    # players don't mis-expand levels
    cmd = [
        "ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "yuv420p", "-color_range", "pc",
        "-s", f"{w}x{h}", "-r", str(fps), "-i", "-", *audio_args,
        "-c:v", "libx264", "-pix_fmt", "yuv420p", "-color_range", "pc", "-crf", "18",
        path,
    ]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    proc.communicate(frames.tobytes())
    if audio_file and os.path.exists(audio_file):
        os.remove(audio_file)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed with code {proc.returncode}")
