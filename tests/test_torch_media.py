"""The port's host media runtime (artalk_tpu_torch/runtime/media.py, its own
copy of the native C++ kernels) against the JAX package's on the same
inputs: resampled audio, RGB -> yuv420 planes and Y4M files equal bit for
bit (both libraries are built with the same g++ flags on this host, so they
contract the same FMAs), the scipy / NumPy fallbacks equal when no library
is built, WAV ingest through ``load_audio_16k_mono``, and the Y4M + WAV tier
of ``write_video`` on a machine without PyAV and ffmpeg."""

import shutil
import wave

import numpy as np
import pytest

from artalk_tpu.runtime import media as jmedia
from artalk_tpu.utils import audio as jaudio
from artalk_tpu.utils import video as jvideo

from artalk_tpu_torch.runtime import media as tmedia
from artalk_tpu_torch.utils import audio as taudio
from artalk_tpu_torch.utils import video as tvideo

RATES = [8000, 22050, 24000, 44100, 48000]


def _noise(rng, n, channels=None):
    shape = (n,) if channels is None else (channels, n)
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


def test_native_library_builds_where_gxx_is():
    if shutil.which("g++") is None:
        pytest.skip("no g++: both packages take their scipy / NumPy fallbacks")
    assert tmedia.native_available() and jmedia.native_available()


@pytest.mark.parametrize("sr", RATES)
def test_resample_poly_equals_jax(sr):
    """3 s of seeded noise to 16 kHz: the same samples, bit for bit."""
    g = np.gcd(sr, 16000)
    audio = _noise(np.random.default_rng(sr), 3 * sr)
    got = tmedia.resample_poly(audio, 16000 // g, sr // g)
    want = jmedia.resample_poly(audio, 16000 // g, sr // g)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr", [22050, 48000])
def test_fallbacks_equal_jax(sr, monkeypatch, tmp_path):
    """Without a library (no g++) both packages take the same fallbacks:
    scipy's resample_poly and the NumPy colour transform."""
    monkeypatch.setattr(tmedia, "_get_lib", lambda: None)
    monkeypatch.setattr(jmedia, "_get_lib", lambda: None)
    g = np.gcd(sr, 16000)
    audio = _noise(np.random.default_rng(1), sr)
    np.testing.assert_array_equal(tmedia.resample_poly(audio, 16000 // g, sr // g),
                                  jmedia.resample_poly(audio, 16000 // g, sr // g))
    frames = np.random.default_rng(2).integers(0, 256, (2, 8, 12, 3)).astype(np.uint8)
    for got, want in zip(tmedia.rgb_to_yuv420(frames), jmedia.rgb_to_yuv420(frames)):
        np.testing.assert_array_equal(got, want)
    paths = [str(tmp_path / f"{name}.y4m") for name in ("port", "jax")]
    tmedia.write_y4m(paths[0], frames, fps=25.0)
    jmedia.write_y4m(paths[1], frames, fps=25.0)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_rgb_to_yuv420_equals_jax():
    frames = np.random.default_rng(3).integers(0, 256, (3, 32, 64, 3)).astype(np.uint8)
    got, want = tmedia.rgb_to_yuv420(frames), jmedia.rgb_to_yuv420(frames)
    assert [p.shape for p in got] == [(3, 32, 64), (3, 16, 32), (3, 16, 32)]
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fps", [25.0, 29.97])
def test_y4m_writers_equal_jax(fps, tmp_path):
    """write_y4m (RGB) and write_y4m_planar (yuv420p) give JAX's bytes."""
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (2, 16, 32, 3)).astype(np.uint8)
    planar = rng.integers(0, 256, (3, 24, 32)).astype(np.uint8)
    for writer, frames in (("write_y4m", rgb), ("write_y4m_planar", planar)):
        got = getattr(tmedia, writer)(str(tmp_path / f"port_{writer}.y4m"), frames, fps=fps)
        want = getattr(jmedia, writer)(str(tmp_path / f"jax_{writer}.y4m"), frames, fps=fps)
        assert open(got, "rb").read() == open(want, "rb").read(), writer
    frames, got_fps = tvideo.read_y4m(str(tmp_path / "port_write_y4m_planar.y4m"))
    np.testing.assert_array_equal(frames, planar)
    assert abs(got_fps - fps) < 1e-3


def test_load_audio_16k_mono_equals_jax(tmp_path):
    """A 44.1 kHz 16-bit stereo WAV: the port's 16 kHz mono samples equal
    JAX's (resample per channel, then the channel mean)."""
    stereo = np.clip(_noise(np.random.default_rng(5), 44100, channels=2), -1, 1)
    path = str(tmp_path / "stereo.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(44100)
        f.writeframes((stereo.T * 32767).astype(np.int16).tobytes())
    got = taudio.load_audio_16k_mono(path)
    want = jaudio.load_audio_16k_mono(path)
    assert got.dtype == np.float32 and got.shape == want.shape == (16000,)
    np.testing.assert_array_equal(got, want)


def test_write_video_without_av_or_ffmpeg_writes_y4m_and_wav(tmp_path, monkeypatch):
    """With neither PyAV nor ffmpeg, write_video writes <name>.y4m and
    <name>.wav, byte for byte as the JAX package writes them."""
    for module in (tvideo, jvideo):
        monkeypatch.setattr(module, "_have_av", lambda: False)
        monkeypatch.setattr(module.shutil, "which", lambda name: None)
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (4, 48, 32)).astype(np.uint8)
    audio = _noise(rng, 6400) * 4   # clipped to [-1, 1] in the WAV
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = tvideo.write_video(frames, str(tmp_path / "port" / "clip.mp4"), 25.0, audio, 16000)
    want = jvideo.write_video(frames, str(tmp_path / "jax" / "clip.mp4"), 25.0, audio, 16000,
                              pix_fmt="yuv420")
    assert got.endswith("clip.y4m") and want.endswith("clip.y4m")
    assert open(got, "rb").read() == open(want, "rb").read()
    wavs = [str(tmp_path / side / "clip.wav") for side in ("port", "jax")]
    assert open(wavs[0], "rb").read() == open(wavs[1], "rb").read()
    read, fps = tvideo.read_y4m(got)
    np.testing.assert_array_equal(read, frames)
    assert fps == 25.0
