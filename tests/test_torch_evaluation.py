"""FLAME landmarks and the motion metrics of artalk_tpu_torch
(models/flame.py, evaluation.py) against the JAX package on the CPU.

The synthetic FLAME asset carries only the dynamic-contour tables, so the
70-point tables are made here with numpy. Landmarks, contours and vertices
agree to atol 1e-5, the FLAME tolerance of tests/test_torch_flame_renderer.py;
the test yaws keep clear of x.5 degrees, where the rounding of the contour
table index could go either way, and reach beyond +-39 degrees (the clamp and
the bucket below -39). The metrics are the same numpy code on both sides and
agree to float rounding; ``evaluate_motion`` through the two FLAMEs to 1e-5."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artalk_tpu import evaluation as jev
from artalk_tpu.models.flame import FlameModel as JaxFlame
from artalk_tpu.models.flame import find_dynamic_lmk_idx_and_bcoords as jax_find
from artalk_tpu.utils.assets import synthetic_flame

from artalk_tpu_torch import evaluation as tev
from artalk_tpu_torch.models.flame import FlameModel, find_dynamic_lmk_idx_and_bcoords

from test_evaluation import _click_track
from test_torch_params import torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _with_landmarks(data, seed=0):
    """The asset plus numpy-made 70-point landmark tables: random faces, but
    the brows (17:27) and the lips (48:68) on the faces nearest a brow and a
    mouth point of the head's front."""
    rng = np.random.default_rng(seed)
    centroid = data["v_template"][data["faces"]].mean(axis=1)
    faces = rng.integers(0, len(data["faces"]), 70)
    for (lo, hi), point in (((17, 27), (0.0, 0.05, 0.08)), ((48, 68), (0.0, -0.05, 0.08))):
        near = np.argsort(np.linalg.norm(centroid - np.array(point), axis=1))
        faces[lo:hi] = near[:hi - lo]
    bary = rng.random((70, 3)).astype(np.float32)
    return {**data, "full_lmk_faces_idx": faces,
            "full_lmk_bary_coords": bary / bary.sum(-1, keepdims=True)}


@pytest.fixture(scope="module")
def assets():
    """(asset without, asset with the 70-point tables): the 5023-vertex
    synthetic head, so the eye refinement applies."""
    data = synthetic_flame(num_verts=5023, seed=1)
    return data, _with_landmarks(data)


def _pair(data):
    return JaxFlame(data), FlameModel(data)


def test_landmarks_match_jax(assets, rng):
    jflame, tflame = _pair(assets[1])
    verts = (rng.standard_normal((3, 5023, 3)) * 0.1).astype(np.float32)
    for refine in (True, False):
        want = np.asarray(jflame.landmarks(jnp.asarray(verts), refine_eyes=refine))
        got = tflame.landmarks(torch.from_numpy(verts), refine_eyes=refine)
        assert got.shape == (3, 70, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    refined = tflame.landmarks(torch.from_numpy(verts))
    plain = tflame.landmarks(torch.from_numpy(verts), refine_eyes=False)
    assert not torch.equal(refined[:, 37:48], plain[:, 37:48])
    with pytest.raises(ValueError, match="landmark tables"):
        FlameModel(assets[0]).landmarks(torch.from_numpy(verts))


def test_dynamic_landmarks_match_jax(assets, rng):
    jflame, tflame = _pair(assets[0])
    yaw_deg = np.array([-60.0, -39.4, -12.2, -0.4, 0.0, 0.4, 12.7, 39.4, 60.0])
    pose = (rng.standard_normal((len(yaw_deg), 6)) * 0.05).astype(np.float32)
    pose[:, 1] = np.deg2rad(yaw_deg)
    verts = np.asarray(jflame(jnp.zeros((len(pose), 300)), jnp.zeros((len(pose), 100)),
                              jnp.asarray(pose)))
    for p in (pose, pose[:, 3:]):     # [global, jaw] and jaw-only
        want = np.asarray(jflame.dynamic_landmarks(jnp.asarray(verts), jnp.asarray(p)))
        got = tflame.dynamic_landmarks(torch.from_numpy(verts.copy()), torch.from_numpy(p))
        assert got.shape == (len(pose), 17, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    full = np.zeros((len(pose), 15), np.float32)
    full[:, :3], full[:, 3:6] = pose[:, :3], pose[:, 3:] * 0.5     # neck yaw composes too
    want_idx, want_bary = jax_find(jnp.asarray(full), assets[0]["dynamic_lmk_faces_idx"],
                                   assets[0]["dynamic_lmk_bary_coords"], jflame.neck_kin_chain)
    got_idx, got_bary = find_dynamic_lmk_idx_and_bcoords(
        torch.from_numpy(full), tflame.dynamic_lmk_faces_idx, tflame.dynamic_lmk_bary_coords,
        tflame.neck_kin_chain)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_bary.numpy(), np.asarray(want_bary))


def test_forward_and_motion_to_verts_match_jax(assets, rng):
    jflame, tflame = _pair(assets[0])
    b = 4
    shape = (rng.standard_normal((b, 300)) * 0.5).astype(np.float32)
    expr = (rng.standard_normal((b, 100)) * 0.5).astype(np.float32)
    pose = (rng.standard_normal((b, 6)) * 0.3).astype(np.float32)
    eyes = (rng.standard_normal((b, 6)) * 0.2).astype(np.float32)
    for args in ((), (pose,), (pose[:, 3:],), (pose, eyes)):
        want = np.asarray(jflame(jnp.asarray(shape), jnp.asarray(expr),
                                 *(jnp.asarray(a) for a in args)))
        got = tflame(torch.from_numpy(shape), torch.from_numpy(expr),
                     *(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    motion = (rng.standard_normal((b, 106)) * 0.3).astype(np.float32)
    for with_global in (True, False):
        want = np.asarray(jflame.motion_to_verts(jnp.asarray(shape), jnp.asarray(motion),
                                                 with_global=with_global))
        got = tflame.motion_to_verts(torch.from_numpy(shape), torch.from_numpy(motion),
                                     with_global=with_global)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("tables", ["geometric", "landmarks"])
def test_region_indices_match_jax(assets, tables):
    jflame, tflame = _pair(assets[tables == "landmarks"])
    lips, upper = tev.lip_vertex_indices(tflame), tev.upper_face_vertex_indices(tflame)
    np.testing.assert_array_equal(lips, jev.lip_vertex_indices(jflame))
    np.testing.assert_array_equal(upper, jev.upper_face_vertex_indices(jflame))
    assert 0 < len(lips) < 5023 and 0 < len(upper) < 5023


def test_metrics_match_jax(rng):
    pred = rng.standard_normal((6, 50, 3)).astype(np.float32)
    gt = rng.standard_normal((6, 50, 3)).astype(np.float32)
    idx = np.arange(10, 30)
    assert tev.lip_vertex_error(pred, gt, idx) == jev.lip_vertex_error(pred, gt, idx)
    assert (tev.upper_face_dynamics_deviation(pred, gt, idx)
            == jev.upper_face_dynamics_deviation(pred, gt, idx))
    audio = _click_track([0.5, 1.5, 2.5, 3.5])
    np.testing.assert_array_equal(tev.audio_onsets(audio), jev.audio_onsets(audio))
    motion = np.cumsum(rng.standard_normal((100, 8)), axis=0).astype(np.float32)
    np.testing.assert_array_equal(tev.motion_beats(motion), jev.motion_beats(motion))
    assert tev.beat_alignment(motion, audio) == jev.beat_alignment(motion, audio)
    assert tev.beat_alignment(np.zeros((2, 4)), np.zeros(100)) == 0.0
    clips = rng.standard_normal((3, 10, 6))
    assert tev.diversity(clips) == jev.diversity(clips)
    assert tev.diversity(clips[:1]) == 0.0


@pytest.mark.parametrize("tables", ["geometric", "landmarks"])
def test_evaluate_motion_matches_jax(assets, rng, tables):
    data = assets[tables == "landmarks"]
    gt = (rng.standard_normal((8, 106)) * 0.1).astype(np.float32)
    pred = gt + (rng.standard_normal((8, 106)) * 0.05).astype(np.float32)
    audio = _click_track([0.1, 0.2])
    want = jev.evaluate_motion(pred, gt, JaxFlame(data), audio=audio)
    got = tev.evaluate_motion(pred, gt, FlameModel(data), audio=audio, device=CPU)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=1e-5, err_msg=key)
    same = tev.evaluate_motion(gt, gt, FlameModel(data), device=CPU)
    assert same["lve"] == 0.0 and same["fdd"] == 0.0 and same["frames"] == 8
    verts = tev.motion_to_vertices(FlameModel(data), gt, CPU)
    np.testing.assert_allclose(verts, np.asarray(jev.motion_to_vertices(JaxFlame(data), gt)),
                               atol=1e-5)


def test_evaluate_motion_leaves_the_flame_where_it_is(assets):
    """A FLAME on another device than the one asked for raises; the caller's
    model is not moved."""
    flame = FlameModel(assets[0])
    motion = np.zeros((3, 106), np.float32)
    with pytest.raises(ValueError, match="not on meta"):
        tev.evaluate_motion(motion, motion, flame, device="meta")
    assert flame.v_template.device == CPU


def test_cli_prints_the_same_json_keys(tmp_path, capsys):
    rng = np.random.default_rng(5)
    gt = (rng.standard_normal((5, 106)) * 0.1).astype(np.float32)
    p1, p2, wav = tmp_path / "pred.npy", tmp_path / "gt.npy", tmp_path / "audio.npy"
    np.save(p1, gt + 0.01)
    np.save(p2, gt)
    np.save(wav, _click_track([0.1]))
    argv = [str(p1), str(p2), "--audio", str(wav), "--assets", str(tmp_path / "assets")]
    jev.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tev.main(argv, device="cpu")
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys() and got["frames"] == 5
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=1e-5, err_msg=key)
