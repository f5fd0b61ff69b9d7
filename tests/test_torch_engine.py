"""The artalk_tpu_torch engine end to end on the CPU (plain versions), against
the JAX engine on the same parameters: inference motions to atol 1e-5,
streaming equal to the offline decode, rendered yuv420p frames within 1 on
>= 99.9 % of samples, and the CLI's mesh path."""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artalk_tpu.engine import ARTAvatarInferEngine as JaxEngine
from artalk_tpu.utils.assets import save_flame_npz, synthetic_flame
from artalk_tpu.utils.checkpoint import _flatten
from artalk_tpu.utils.video import read_video_npz

from artalk_tpu_torch import cli as tcli
from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.utils.video import read_video_npz as port_read_video_npz
from artalk_tpu_torch.utils.video import read_y4m

from test_engine import CFG, _write_wav
from test_torch_params import torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)

SIZE = 128


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    assets = tmp_path_factory.mktemp("assets")
    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(assets / "flame_synthetic.npz"))
    jeng = JaxEngine(assets_dir=str(assets), output_dir=str(tmp_path_factory.mktemp("jout")),
                     config=CFG, image_size=SIZE, interpret=True)
    teng = ARTAvatarInferEngine(
        assets_dir=str(assets), output_dir=str(tmp_path_factory.mktemp("tout")),
        config=torch_config(CFG), params=_flatten(jeng.params), image_size=SIZE,
        device="cpu")
    return jeng, teng, assets


@pytest.mark.parametrize("seconds", [0.25, 0.7])
def test_inference_matches_jax(engines, rng, seconds):
    jeng, teng, _ = engines
    audio = (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)
    got = teng.inference(audio)
    want = jeng.inference(audio)
    assert got.shape == want.shape == (int(np.ceil(seconds * 25)), 106)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[:, 104:], 0.0)
    np.testing.assert_array_equal(teng.inference(audio), got)


def test_style_motion_matches_jax(engines, rng):
    jeng, teng, _ = engines
    style = rng.standard_normal((50, 106)).astype(np.float32)
    audio = (rng.standard_normal(2560) * 0.1).astype(np.float32)
    try:
        jeng.set_style_motion(style)
        teng.set_style_motion(style)
        np.testing.assert_allclose(teng.inference(audio), jeng.inference(audio), atol=1e-5)
    finally:
        jeng.style_motion = teng.style_motion = None
    with pytest.raises(AssertionError):
        teng.set_style_motion(np.zeros((10, 106), np.float32))


def test_stream_equals_offline(engines, rng):
    """Window-by-window streaming (also resumed mid-stream from the saved
    carry) gives exactly the raw offline decode."""
    _, teng, _ = engines
    ws = teng.model.window_samples
    audio = (rng.standard_normal(3 * ws + 700) * 0.1).astype(np.float32)
    padded = np.zeros(4 * ws, np.float32)
    padded[: len(audio)] = audio
    offline = teng.model.generate(torch.from_numpy(padded.reshape(4, 1, ws)),
                                  teng.model.encode_style(None))[0].numpy()
    chunks = [audio[i : i + ws] for i in range(0, len(audio), ws)]
    streamed = np.concatenate(list(teng.stream(chunks)), axis=0)
    assert streamed.shape == (3 * CFG.vae.window + 2, 106)
    np.testing.assert_array_equal(streamed, offline[: len(streamed)])
    first = list(teng.stream(chunks[:2]))
    rest = list(teng.stream(chunks[2:], state=teng.last_stream_state))
    np.testing.assert_array_equal(np.concatenate(first + rest, axis=0), streamed)
    with pytest.raises(ValueError, match="exceeds"):
        next(teng.stream([np.zeros(ws + 1, np.float32)]))


def test_rendering_matches_jax(engines, rng):
    jeng, teng, _ = engines
    audio = (rng.standard_normal(2560) * 0.1).astype(np.float32)
    motions = teng.inference(audio)
    out = teng.rendering(audio, motions, shape_id="mesh", save_name="clip")
    assert os.path.exists(out)
    if out.endswith(".y4m"):   # no PyAV or ffmpeg: Y4M + WAV, as the JAX package writes
        frames, fps = read_y4m(out)
        assert fps == 25.0 and os.path.exists(out[:-4] + ".wav")
    elif out.endswith(".npz"):
        with np.load(out) as z:
            frames = z["frames"]
        rgb, fps, _, sr = read_video_npz(out)   # the JAX package reads the container
        assert rgb.shape == (len(motions), SIZE, SIZE, 3) and (fps, sr) == (25.0, 16000)
        port = port_read_video_npz(out)         # and the port's own reader alike
        np.testing.assert_array_equal(port[0], rgb)
        assert (port[1], port[3]) == (fps, sr)
    else:  # an encoded video (PyAV or ffmpeg present): compare the renderer's frames
        verts = teng.flame.motion_to_verts(torch.zeros(len(motions), 300),
                                           torch.from_numpy(motions))
        frames = teng.mesh_renderer.render_frames(verts)
    verts = jeng._flame_verts(jnp.zeros((len(motions), 300)), jnp.asarray(motions))
    want = jeng.mesh_renderer.render_frames(verts, colorspace="yuv420")
    assert frames.shape == want.shape == (len(motions), SIZE * 3 // 2, SIZE)
    diff = np.abs(frames.astype(np.int16) - want.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999, (diff > 1).mean()
    # an avatar id needs the GAGAvatar renderer, which this engine did not load
    with pytest.raises(RuntimeError, match="load_gaga=True"):
        teng.rendering(audio, motions, shape_id="someone.jpg")


def test_cli_mesh_path(engines, tmp_path, monkeypatch):
    _, _, assets = engines
    monkeypatch.setattr(tcli, "ARTAvatarInferEngine", functools.partial(
        ARTAvatarInferEngine, config=torch_config(CFG), output_dir=str(tmp_path),
        device="cpu"))
    wav = _write_wav(tmp_path / "clip.wav", seconds=0.3)
    out = tcli.main(["-a", wav, "--assets", str(assets), "--image_size", "64"])
    assert os.path.exists(out) and os.path.basename(out).startswith("clip_default_mesh")
