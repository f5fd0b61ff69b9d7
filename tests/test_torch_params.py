"""Parameter bridge (JAX flat-key params -> artalk_tpu_torch modules), the
committed seed-0 fixture that the GPU smoke run replays, and the helpers the
other ``test_torch_*`` files share."""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax

from artalk_tpu.models.ar_model import BitwiseARModel as JaxARModel
from artalk_tpu.utils.checkpoint import _flatten

from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch.models.ar_model import BitwiseARModel
from artalk_tpu_torch.utils.params import flat_from_module as flat_from_model
from artalk_tpu_torch.utils.params import load_flat_into, load_params_npz, params_from_flat

from test_ar_model import CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_golden_small_params.npz")


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """One torch thread while a parity module runs: the suite runs several
    pytest workers on one machine, and torch's default of one OpenMP thread
    per core in each of them oversubscribes the cores many times over (the
    other ``test_torch_*`` modules import this fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torch_config(cfg):
    """The port's ModelConfig for a JAX ModelConfig (same fields)."""
    return tcfg.ModelConfig(
        ar=tcfg.ARConfig(**dataclasses.asdict(cfg.ar)),
        vae=tcfg.VAEConfig(**dataclasses.asdict(cfg.vae)),
        wav2vec=tcfg.Wav2VecConfig(**dataclasses.asdict(cfg.wav2vec)),
        mimi=tcfg.MimiEncoderConfig(**dataclasses.asdict(cfg.mimi)),
        fps=cfg.fps, sample_rate=cfg.sample_rate)


@functools.lru_cache(maxsize=None)
def jax_model_and_flat(cfg, seed=0):
    """(JAX model, JAX params, flat //-keyed numpy params) for ``cfg``."""
    model = JaxARModel(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    return model, params, _flatten(params)


def port_model(cfg, seed=0):
    """The port's model holding the JAX seed-``seed`` params of ``cfg``."""
    return params_from_flat(jax_model_and_flat(cfg, seed)[2], torch_config(cfg))


def with_jax_params(module, jax_params):
    """``module`` (a port module) holding a JAX module's parameter tree."""
    return load_flat_into(module, _flatten(jax_params)).requires_grad_(False)


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_bridge_roundtrip_is_exact():
    flat = jax_model_and_flat(CFG)[2]
    back = flat_from_model(port_model(CFG))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_bridge_missing_key_raises():
    flat = dict(jax_model_and_flat(CFG)[2])
    del flat["blocks//q//w"]
    with pytest.raises(KeyError, match="blocks//q//w"):
        params_from_flat(flat, torch_config(CFG))


def test_bridge_wrong_shape_raises():
    flat = dict(jax_model_and_flat(CFG)[2])
    flat["vae//encoder//inp//w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="vae//encoder//inp//w"):
        params_from_flat(flat, torch_config(CFG))


def test_random_init_covers_the_jax_tree():
    """``init`` fills every parameter the JAX tree has, at the same shapes,
    with finite values (torch.empty garbage would show as a mismatch in the
    deterministic tables or as non-finite values)."""
    model = BitwiseARModel(torch_config(CFG)).init(torch.Generator().manual_seed(0))
    got = flat_from_model(model)
    want = jax_model_and_flat(CFG)[2]
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k, v in got.items():
        assert np.isfinite(v).all(), k
    # deterministic entries equal JAX's exactly
    for k in ("style_encoder//pe", "style_encoder//motion_mean",
              "vae//motion_std", "blocks//scale_mul"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_committed_fixture_matches_fresh_jax_init():
    """tests/fixtures/torch_golden_small_params.npz (written by
    tools/export_torch_fixture.py) is exactly the seed-0 JAX init of
    test_ar_model.CFG, so the GPU golden replay cannot drift from the goldens."""
    committed = load_params_npz(FIXTURE)
    fresh = jax_model_and_flat(CFG)[2]
    assert set(committed) == set(fresh)
    for k, v in fresh.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)


def test_load_config_reads_reference_json(tmp_path):
    """Same reference-format config.json, same typed config as JAX's loader."""
    from artalk_tpu.config import load_config as jax_load_config

    from artalk_tpu_torch.config import load_config

    path = tmp_path / "config.json"
    path.write_text('{"AR_CONFIG": {"T_DEPTH": 6, "T_NUM_HEADS": 8, "PREV_RATIO": 2}, '
                    '"VAE_CONFIG": {"V_CODE_DIM": 16, "V_PATCH_NUMS": [1, 4, 16]}}')
    assert load_config(str(path)) == torch_config(jax_load_config(str(path)))


def test_chip_smoke_golden_config_is_the_test_config():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.GOLDEN_SMALL_CFG == torch_config(CFG)
