"""artalk_tpu_torch.utils.video against artalk_tpu.utils.video: the yuv420p
-> RGB inverse bit for bit, the .npz container read alike, the RGB path of
every writer tier (Y4M bytes, ffmpeg's command line, the .npz) equal to the
JAX writer's, and the PyAV readers, which without PyAV raise as JAX's do
(their PyAV branch runs only where ``av`` is installed)."""

import os
import sys
import wave

import numpy as np
import pytest
import torch

from artalk_tpu.utils import video as jvideo

from artalk_tpu_torch.ops.colorspace import rgb_to_yuv420p
from artalk_tpu_torch.utils import video as tvideo

READERS = ("read_video_frames", "get_video_info", "read_all_video_frames", "read_audio_samples")


def _planes(rng, t=3, h=32, w=48):
    return rng.integers(0, 256, (t, h * 3 // 2, w)).astype(np.uint8)


@pytest.fixture
def no_codecs(monkeypatch):
    """Neither PyAV nor ffmpeg, for both packages' writers."""
    for module in (tvideo, jvideo):
        monkeypatch.setattr(module, "_have_av", lambda: False)
        monkeypatch.setattr(module.shutil, "which", lambda name: None)


@pytest.mark.parametrize("shape", [(1, 4, 2), (3, 32, 48), (2, 64, 64)])
def test_yuv420p_to_rgb_equals_jax(rng, shape):
    planes = _planes(rng, *shape)
    got = tvideo.yuv420p_to_rgb(planes)
    assert got.shape == shape + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jvideo.yuv420p_to_rgb(planes))


def test_roundtrip_on_chroma_constant_blocks(rng):
    """The device transform and its host inverse recover 2x2-constant colour
    blocks within 3 (tests/test_colorspace.py's rule)."""
    small = rng.integers(16, 240, (2, 16, 24, 3)).astype(np.uint8)
    u8 = np.repeat(np.repeat(small, 2, axis=1), 2, axis=2)
    x = torch.from_numpy((u8.astype(np.float32) + 0.5) / 255.0)
    back = tvideo.yuv420p_to_rgb(rgb_to_yuv420p(x, channel_axis=-1).numpy())
    assert np.abs(back.astype(int) - u8.astype(int)).max() <= 3


@pytest.mark.parametrize("pix_fmt", ["yuv420", "rgb24"])
def test_npz_container_reads_as_jax(rng, tmp_path, no_codecs, monkeypatch, pix_fmt):
    """With no Y4M writer either, ``write_video`` falls back to the .npz;
    the port's ``read_video_npz`` of it equals JAX's (RGB frames, fps,
    audio, sample rate), and so does JAX's writer's file."""
    def no_y4m(*args):
        raise OSError("no y4m")

    monkeypatch.setattr(tvideo, "_write_y4m_wav", no_y4m)
    monkeypatch.setattr(jvideo, "_write_y4m_wav", no_y4m)
    frames = _planes(rng) if pix_fmt == "yuv420" else \
        rng.integers(0, 256, (3, 32, 48, 3)).astype(np.uint8)
    audio = (rng.standard_normal(1920) * 0.1).astype(np.float32)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = tvideo.write_video(frames, str(tmp_path / "port" / "clip.mp4"), 25.0, audio, 16000,
                             pix_fmt=pix_fmt)
    want = jvideo.write_video(frames, str(tmp_path / "jax" / "clip.mp4"), 25.0, audio, 16000,
                              pix_fmt=pix_fmt)
    assert got.endswith("clip.npz") and want.endswith("clip.npz")
    for path in (got, want):
        port, ref = tvideo.read_video_npz(path), jvideo.read_video_npz(path)
        assert port[0].shape == (3, 32, 48, 3) and port[0].dtype == np.uint8
        np.testing.assert_array_equal(port[0], ref[0])
        np.testing.assert_array_equal(port[2], audio)
        assert port[1] == ref[1] == 25.0 and port[3] == ref[3] == 16000


def test_odd_rgb_frames_fall_back_to_npz_as_jax(rng, tmp_path, no_codecs):
    """RGB frames of odd height and width, which the Y4M tier refuses (its
    4:2:0 planes need even sizes), go to the .npz as in JAX, and the port's
    file reads as JAX's does."""
    frames = rng.integers(0, 256, (3, 31, 33, 3)).astype(np.uint8)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = tvideo.write_video(frames, str(tmp_path / "port" / "clip.mp4"), 25.0,
                             pix_fmt="rgb24")
    want = jvideo.write_video(frames, str(tmp_path / "jax" / "clip.mp4"), 25.0,
                              pix_fmt="rgb24")
    assert got.endswith("clip.npz") and want.endswith("clip.npz")
    port, ref = tvideo.read_video_npz(got), jvideo.read_video_npz(want)
    np.testing.assert_array_equal(port[0], frames)
    for g, w in zip(port, ref):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_y4m_bytes_equal_jax(rng, tmp_path, no_codecs, dtype):
    """``write_video(..., pix_fmt="rgb24")`` through the Y4M tier writes the
    JAX writer's bytes (video and WAV) for the same frames; float frames are
    clipped and cast as JAX casts them."""
    frames = rng.integers(0, 256, (4, 32, 48, 3)).astype(dtype)
    if dtype == np.float32:
        frames = frames * 1.2 - 20.0   # out of range on both sides
    audio = (rng.standard_normal(2560) * 0.5).astype(np.float32)
    paths = {}
    for side, module in (("port", tvideo), ("jax", jvideo)):
        (tmp_path / side).mkdir()
        paths[side] = module.write_video(frames, str(tmp_path / side / "clip.mp4"), 25.0, audio,
                                         16000, pix_fmt="rgb24")
    assert paths["port"].endswith("clip.y4m")
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    wavs = [str(tmp_path / side / "clip.wav") for side in ("port", "jax")]
    assert open(wavs[0], "rb").read() == open(wavs[1], "rb").read()
    planes, fps = tvideo.read_y4m(paths["port"])
    assert planes.shape == (4, 48, 48) and fps == 25.0
    with wave.open(wavs[0]) as f:
        assert f.getframerate() == 16000 and f.getnframes() == 2560


@pytest.mark.parametrize("pix_fmt", ["yuv420", "rgb24"])
def test_ffmpeg_command_equals_jax(rng, tmp_path, monkeypatch, pix_fmt):
    """The ffmpeg tier's command line and the bytes piped to it are JAX's."""
    calls = []

    class FakePopen:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            self.cmd = cmd

        def communicate(self, data):
            calls.append((self.cmd, data))
            return b"", b""

    monkeypatch.setattr(tvideo.subprocess, "Popen", FakePopen)
    frames = _planes(rng) if pix_fmt == "yuv420" else \
        rng.integers(0, 256, (3, 32, 48, 3)).astype(np.uint8)
    audio = np.zeros(640, np.float32)
    out = str(tmp_path / "clip.mp4")
    tvideo._write_ffmpeg(frames, out, 25.0, audio, 16000, pix_fmt)
    jvideo._write_ffmpeg(frames, out, 25.0, audio, 16000, pix_fmt)
    (port_cmd, port_data), (jax_cmd, jax_data) = calls
    assert port_cmd == jax_cmd and port_data == jax_data
    assert ("rgb24" in port_cmd) == (pix_fmt == "rgb24")
    assert not os.path.exists(out + ".pcm")


def test_unknown_pix_fmt_raises(rng, tmp_path):
    with pytest.raises(ValueError, match="pix_fmt"):
        tvideo.write_video(_planes(rng), str(tmp_path / "clip.mp4"), pix_fmt="nv12")


@pytest.mark.parametrize("reader", READERS)
def test_readers_without_av_raise(tmp_path, monkeypatch, reader):
    """Without PyAV each reader raises JAX's RuntimeError (the generator on
    its first frame, as JAX's)."""
    monkeypatch.setitem(sys.modules, "av", None)   # import av raises ImportError
    path = str(tmp_path / "clip.mp4")
    for module in (tvideo, jvideo):
        with pytest.raises(RuntimeError, match=r"video reading requires PyAV \(not installed\)"):
            out = getattr(module, reader)(path)
            if reader == "read_video_frames":
                next(out)


def test_av_write_and_read_roundtrip(tmp_path, rng):
    """PyAV branch (runs wherever av is installed): RGB and yuv420 frames
    written with PyAV read back through the port's readers."""
    pytest.importorskip("av")
    frames = (rng.random((5, 32, 32, 3)) * 255).astype(np.uint8)
    audio = (0.1 * np.sin(np.linspace(0, 440, 16000))).astype(np.float32)
    out = str(tmp_path / "clip.mp4")
    tvideo._write_av(frames, out, 25.0, audio, 16000, "aac", pix_fmt="rgb24")
    info = tvideo.get_video_info(out)
    assert info["video"]["width"] == 32 and info["video"]["height"] == 32
    back, fps = tvideo.read_all_video_frames(out)
    assert back.shape[1:] == (32, 32, 3) and abs(fps - 25.0) < 1e-6
    assert len(list(tvideo.read_video_frames(out))) == len(back)
    samples, sr = tvideo.read_audio_samples(out)
    assert sr == 16000 and samples.ndim == 1
    planes = _planes(rng, 3, 32, 32)
    out_yuv = str(tmp_path / "clip_yuv.mp4")
    tvideo._write_av(planes, out_yuv, 25.0, None, 16000, "aac")
    assert tvideo.get_video_info(out_yuv)["video"]["height"] == 32
