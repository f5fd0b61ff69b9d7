"""Host-side video muxing and reading, from ``artalk_tpu/utils/video.py``.

H.264 (yuv420p, crf 18) + AAC as the reference writes it, behind one function
that degrades gracefully:

1. PyAV (if installed) -- H.264 + AAC, same settings as the reference.
2. ffmpeg CLI (if on PATH) -- same codecs via a rawvideo pipe.
3. Y4M (``runtime/media.py``) -- codec-free YUV4MPEG2 playable by
   mpv/ffplay/VLC, the audio as a sibling 16-bit .wav.
4. Fallback: .npz of frames + audio (lossless, always available).

Each backend takes the renderers' yuv420p planes (``pix_fmt="yuv420"``, the
port's default: the engine's frames leave the card as planes) or RGB frames
(``pix_fmt="rgb24"``, the JAX writer's default). ``read_y4m`` and
``read_video_npz`` read back what tiers 3 and 4 wrote; the PyAV readers
(ports of the reference's ``app/utils_videos.py``) read encoded video and
need PyAV, which they say when it is missing.
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
                acodec: str = "aac", pix_fmt: str = "yuv420") -> str:
    """frames: (T, H * 3 // 2, W) uint8 planar yuv420p, BT.601 full range
    (ops/colorspace.py), or -- with ``pix_fmt="rgb24"`` -- (T, H, W, 3) RGB
    (clipped to [0, 255] and cast to uint8 if it is not uint8). Returns the
    path actually written."""
    frames = np.ascontiguousarray(frames)
    if pix_fmt == "yuv420":
        assert frames.ndim == 3 and frames.dtype == np.uint8, (frames.shape, frames.dtype)
    elif pix_fmt == "rgb24":
        assert frames.ndim == 4 and frames.shape[-1] == 3, frames.shape
        if frames.dtype != np.uint8:
            frames = np.clip(frames, 0, 255).astype(np.uint8)
    else:
        raise ValueError(f"pix_fmt={pix_fmt!r}: expected 'yuv420' or 'rgb24'")
    if _have_av():
        _write_av(frames, path, fps, audio, sample_rate, acodec, pix_fmt)
        return path
    if shutil.which("ffmpeg"):
        _write_ffmpeg(frames, path, fps, audio, sample_rate, pix_fmt)
        return path
    try:
        return _write_y4m_wav(frames, path, fps, audio, sample_rate, pix_fmt)
    except OSError as e:
        print(f"[artalk_tpu_torch] y4m writer failed ({e}); falling back to npz")
    alt = os.path.splitext(path)[0] + ".npz"
    np.savez_compressed(alt, frames=frames, fps=fps,
                        audio=audio if audio is not None else np.zeros(0, np.float32),
                        sample_rate=sample_rate, pix_fmt=pix_fmt)
    return alt


def _write_av(frames, path, fps, audio, sample_rate, acodec, pix_fmt="yuv420"):
    import av

    yuv = pix_fmt == "yuv420"
    container = av.open(path, mode="w")
    stream = container.add_stream("h264", rate=fps)
    stream.width = frames.shape[2]
    stream.height = frames.shape[1] * 2 // 3 if yuv else frames.shape[1]
    stream.pix_fmt = "yuv420p"
    stream.options = {"crf": "18"}
    if yuv:
        # the planes are BT.601 FULL range; signal it so decoders don't
        # expand 0-255 as if it were limited/tv range
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
        vf = av.VideoFrame.from_ndarray(frame, format="yuv420p" if yuv else "rgb24")
        for packet in stream.encode(vf):
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


def _write_ffmpeg(frames, path, fps, audio, sample_rate, pix_fmt="yuv420"):
    yuv = pix_fmt == "yuv420"
    if yuv:
        t, h32, w = frames.shape
        h, in_fmt = h32 * 2 // 3, "yuv420p"
    else:
        t, h, w, _ = frames.shape
        in_fmt = "rgb24"
    audio_args = []
    audio_file = None
    if audio is not None:
        audio_file = path + ".pcm"
        np.asarray(audio, np.float32).tofile(audio_file)
        audio_args = ["-f", "f32le", "-ar", str(sample_rate), "-ac", "1",
                      "-i", audio_file, "-c:a", "aac", "-shortest"]
    # full-range planes: declare the input range and keep it on output so
    # players don't mis-expand levels
    color_range = ["-color_range", "pc"] if yuv else []
    cmd = [
        "ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", in_fmt, *color_range,
        "-s", f"{w}x{h}", "-r", str(fps), "-i", "-", *audio_args,
        "-c:v", "libx264", "-pix_fmt", "yuv420p", *color_range, "-crf", "18",
        path,
    ]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    proc.communicate(frames.tobytes())
    if audio_file and os.path.exists(audio_file):
        os.remove(audio_file)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed with code {proc.returncode}")


def _write_y4m_wav(frames, path, fps, audio, sample_rate, pix_fmt="yuv420") -> str:
    """Y4M video + sibling .wav audio (no codecs required), as the JAX
    package's ``_write_y4m_wav`` writes them."""
    import wave

    from ..runtime import media

    out = os.path.splitext(path)[0] + ".y4m"
    if pix_fmt == "yuv420":
        media.write_y4m_planar(out, frames, fps=fps)   # the planes as they are
    else:
        media.write_y4m(out, frames, fps=fps)          # RGB converted on the host
    if audio is not None:
        pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
        with wave.open(os.path.splitext(path)[0] + ".wav", "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sample_rate)
            f.writeframes((pcm * 32767.0).astype(np.int16).tobytes())
    return out


def read_y4m(path: str) -> tuple:
    """(frames (T, H * 3 // 2, W) uint8 planar yuv420p, fps) of a YUV4MPEG2
    file as ``write_y4m_planar`` writes it."""
    with open(path, "rb") as f:
        header = f.readline().split()
        body = f.read()
    w, h = int(header[1][1:]), int(header[2][1:])
    num, den = (int(x) for x in header[3][1:].split(b":"))
    frame = 6 + w * h * 3 // 2   # b"FRAME\n" and the planes
    if len(body) % frame:
        raise ValueError(f"{path}: {len(body)} bytes are not whole {w}x{h} frames")
    frames = np.frombuffer(body, np.uint8).reshape(-1, frame)[:, 6:]
    return frames.reshape(-1, h * 3 // 2, w), num / den


def yuv420p_to_rgb(frames: np.ndarray) -> np.ndarray:
    """(T, H * 3 // 2, W) uint8 planar yuv420p -> (T, H, W, 3) uint8 RGB
    (inverse of ops/colorspace.py's BT.601 full-range transform; the JAX
    package's arithmetic in its order, so the two agree bit for bit)."""
    t, h32, w = frames.shape
    h = h32 * 2 // 3
    y = frames[:, :h].astype(np.float32)
    u = frames[:, h:h + h // 4].reshape(t, h // 2, w // 2).astype(np.float32) - 128.0
    v = frames[:, h + h // 4:].reshape(t, h // 2, w // 2).astype(np.float32) - 128.0
    u = np.repeat(np.repeat(u, 2, axis=1), 2, axis=2)
    v = np.repeat(np.repeat(v, 2, axis=1), 2, axis=2)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return np.clip(np.stack([r, g, b], axis=-1) + 0.5, 0, 255).astype(np.uint8)


def read_video_npz(path: str) -> tuple:
    """(frames (T, H, W, 3) uint8 RGB, fps, audio, sample_rate) of the .npz
    fallback container; yuv420 planes are converted to RGB."""
    with np.load(path) as z:
        frames = z["frames"]
        if "pix_fmt" in z.files and str(z["pix_fmt"]) == "yuv420":
            frames = yuv420p_to_rgb(frames)
        return frames, float(z["fps"]), z["audio"], int(z["sample_rate"])


# ---------------------------------------------------------------------------
# Readers of encoded video (ports of app/utils_videos.py:62-128), gated on PyAV
# ---------------------------------------------------------------------------


def _require_av():
    try:
        import av
        return av
    except ImportError as e:
        raise RuntimeError("video reading requires PyAV (not installed)") from e


def read_video_frames(video_path: str):
    """Yield (H, W, 3) uint8 RGB frames."""
    av = _require_av()
    container = av.open(video_path)
    for frame in container.decode(video=0):
        yield frame.to_ndarray(format="rgb24")


def get_video_info(video_path: str) -> dict:
    """{"video": {width, height, frame_rate, num_frames} or None,
    "audio": {channels, sample_rate, duration} or None}."""
    av = _require_av()
    container = av.open(video_path)
    vs = next((s for s in container.streams if s.type == "video"), None)
    astream = next((s for s in container.streams if s.type == "audio"), None)
    return {
        "video": None if vs is None else {
            "width": vs.width, "height": vs.height,
            "frame_rate": float(vs.average_rate), "num_frames": vs.frames},
        "audio": None if astream is None else {
            "channels": astream.channels, "sample_rate": astream.rate,
            "duration": astream.duration},
    }


def read_all_video_frames(video_path: str) -> tuple:
    """(uint8 (T, H, W, 3) RGB frames, fps)."""
    av = _require_av()
    container = av.open(video_path)
    vs = next((s for s in container.streams if s.type == "video"), None)
    if vs is None:
        return np.zeros((0,), np.uint8), 0.0
    frames = [f.to_ndarray(format="rgb24")
              for f in container.decode(video=0) if f.pts is not None]
    return np.stack(frames), float(vs.average_rate)


def read_audio_samples(video_path: str, stereo: bool = False) -> tuple:
    """(float32 samples in [-1, 1], sample_rate); (None, None) without an
    audio stream. Channels are averaged unless ``stereo``."""
    av = _require_av()
    container = av.open(video_path)
    astream = next((s for s in container.streams if s.type == "audio"), None)
    if astream is None:
        return None, None
    audio = np.concatenate([f.to_ndarray() for f in container.decode(audio=0)], axis=-1)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    elif audio.dtype == np.int32:
        audio = audio.astype(np.float32) / 2147483648.0
    if not stereo:
        audio = audio.mean(axis=0)
    return audio, astream.rate
