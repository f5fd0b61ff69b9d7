"""artalk_tpu_torch.utils.checkpoint against artalk_tpu.utils.checkpoint
(counterpart of tests/test_checkpoint.py), the config's JSON form, and the
smaller API the port carries for the JAX package's: ``bits_to_ar_feat``,
``ARTAvatarInferEngine.smooth_motion_savgol``, ``HubertEncoder.num_output_frames``.

The .npz of either package loads in the other to equal tensors. The sharded
checkpoint (``torch.distributed.checkpoint``) round-trips exactly without a
process group, and as two gloo processes at tp = 2
(``tests/torch_parallel_jobs.py``'s ``checkpoint`` job): restored into a
(1, 2) mesh, a (2, 1) mesh and an unsharded model there, and into a plain
model here, in a process with no group.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artalk_tpu.config import ModelConfig as JaxModelConfig
from artalk_tpu.config import VAEConfig as JaxVAEConfig
from artalk_tpu.config import hubert_base_config as jax_hubert_config
from artalk_tpu.config import load_config as jax_load_config
from artalk_tpu.engine import ARTAvatarInferEngine as JaxEngine
from artalk_tpu.models.bitwise_vae import BitwiseVAE as JaxVAE
from artalk_tpu.models.bsq import MultiScaleBSQ as JaxBSQ
from artalk_tpu.models.hubert import HubertEncoder as JaxHubert
from artalk_tpu.utils import checkpoint as jck

from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.models.ar_model import BitwiseARModel
from artalk_tpu_torch.models.bitwise_vae import BitwiseVAE
from artalk_tpu_torch.models.bsq import MultiScaleBSQ
from artalk_tpu_torch.models.hubert import HubertEncoder
from artalk_tpu_torch.utils import checkpoint as tck
from artalk_tpu_torch.utils.params import (flat_from_module, load_flat_into, load_params_npz,
                                           save_params_npz)

import torch_parallel_jobs as jobs
from test_torch_params import jax_model_and_flat
from test_torch_params import torch_threads  # noqa: F401 (autouse)
from test_torch_parallel import finish_job, start_job
from test_training import CFG as TRAIN_CFG

# tests/test_checkpoint.py's CFG
CFG = JaxVAEConfig(motion_dim=12, code_dim=8, depth=2, num_heads=4, hidden_dim=32,
                   patch_nums=(1, 2, 4))
TCFG = tcfg.VAEConfig(**vars(CFG))
REF_JSON = {
    "AR_CONFIG": {"T_DEPTH": 12, "T_NUM_HEADS": 12, "PREV_RATIO": 1},
    "VAE_CONFIG": {"MOTION_DIM": 106, "V_CODE_DIM": 32, "T_DEPTH": 8,
                   "T_NUM_HEADS": 8, "T_HIDDEN_DIM": 512,
                   "V_PATCH_NUMS": [1, 5, 25, 50, 100]},
}


def port_vae(seed: int, cfg=TCFG) -> BitwiseVAE:
    return BitwiseVAE(cfg).init(torch.Generator().manual_seed(seed))


def assert_flat_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module", autouse=True)
def job_started(tmp_path_factory):
    """The two-process ``checkpoint`` job, started as the module starts so
    that it runs beside the in-process tests; killed at the end if left."""
    out = tmp_path_factory.mktemp("checkpoint_job")
    flat = jax_model_and_flat(TRAIN_CFG)[2]
    inputs = {**{f"params/{k}": v for k, v in flat.items()}, "ckpt_dir": str(out / "ckpt")}
    started = start_job("checkpoint", inputs, out)
    yield flat, out / "ckpt", started
    for p in started[1]:
        if p.poll() is None:
            p.kill()
            p.communicate()


# ----------------------------------------------------------- npz, in port


def test_npz_roundtrip(tmp_path):
    params = port_vae(0)
    path = str(tmp_path / "vae.npz")
    tck.save_params(params, path)
    restored = tck.load_params(path, like=port_vae(1))
    assert_flat_equal(flat_from_module(restored), flat_from_module(params))


def test_npz_shape_validation(tmp_path):
    path = str(tmp_path / "vae.npz")
    tck.save_params(port_vae(0), path)
    other = port_vae(0, tcfg.VAEConfig(motion_dim=12, code_dim=8, depth=2, num_heads=4,
                                       hidden_dim=64, patch_nums=(1, 2, 4)))
    before = flat_from_module(other)
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.load_params(path, like=other)
    assert_flat_equal(flat_from_module(other), before)   # checked before any copy


def test_npz_missing_key(tmp_path):
    path = str(tmp_path / "vae.npz")
    partial = flat_from_module(port_vae(0))
    del partial["enc_pos_embed"]
    tck.save_params(partial, path)
    with pytest.raises(KeyError, match="checkpoint missing parameter 'enc_pos_embed'"):
        tck.load_params(path, like=port_vae(0))


def test_one_npz_writer(tmp_path):
    """``save_params`` deflates, as JAX's does; ``utils/params.save_params_npz``
    is the same writer storing the arrays as they are; both load alike."""
    model = port_vae(0)
    tck.save_params(model, str(tmp_path / "deflated.npz"))
    save_params_npz(model, str(tmp_path / "stored.npz"))
    for name, kind in (("deflated", zipfile.ZIP_DEFLATED), ("stored", zipfile.ZIP_STORED)):
        with zipfile.ZipFile(tmp_path / f"{name}.npz") as z:
            assert {i.compress_type for i in z.infolist()} == {kind}
        assert_flat_equal(load_params_npz(str(tmp_path / f"{name}.npz")),
                          flat_from_module(model))


# ------------------------------------------------------- npz, across packages


def test_jax_npz_loads_into_port(tmp_path):
    """JAX ``save_params`` of a BitwiseVAE -> the port's
    ``load_params(like=)``: the tensors equal JAX's arrays."""
    params = JaxVAE(CFG).init(jax.random.PRNGKey(0))
    path = str(tmp_path / "jax.npz")
    jck.save_params(params, path)
    restored = tck.load_params(path, like=port_vae(1))
    assert_flat_equal(flat_from_module(restored), jck._flatten(params))


def test_port_npz_loads_in_jax(tmp_path):
    """The port's ``save_params`` of a BitwiseVAE holding JAX's seed-0
    weights (carried in by ``utils/params``) -> JAX's
    ``load_params(like=)`` on another seed's template: equal arrays."""
    params = JaxVAE(CFG).init(jax.random.PRNGKey(0))
    model = load_flat_into(BitwiseVAE(TCFG), jck._flatten(params))
    path = str(tmp_path / "port.npz")
    tck.save_params(model, path)
    restored = jck.load_params(path, like=JaxVAE(CFG).init(jax.random.PRNGKey(1)))
    assert_flat_equal(jck._flatten(restored), jck._flatten(params))


def test_npz_without_template_is_jax_nested_dict(tmp_path):
    """Without ``like`` both packages rebuild the same nested dict from the
    same file, list indices (the conv stack's) as string keys."""
    path = str(tmp_path / "port.npz")
    tck.save_params(load_flat_into(BitwiseARModel(jobs.SMALL_CFG),
                                   jax_model_and_flat(TRAIN_CFG)[2]), path)
    got, want = tck.load_params(path), jck.load_params(path)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert_flat_equal(jck._flatten(got), jck._flatten(want))
    assert set(got["audio_encoder"]["feature_extractor"]) == {"0", "1"}


def test_nested_tree_saves_with_jax_keys(tmp_path):
    """A nested tree of dicts and lists (as JAX's pytrees and
    ``utils/convert.py``'s output are) is keyed as JAX's ``_flatten`` keys it."""
    tree = {"b": [np.zeros(2, np.float32), {"w": np.ones((2, 3), np.float32)}],
            "a": np.arange(3, dtype=np.int32), "skip": None}
    tck.save_params(tree, str(tmp_path / "tree.npz"))
    assert_flat_equal(load_params_npz(str(tmp_path / "tree.npz")), jck._flatten(tree))


# ---------------------------------------------------------------- sharded


def test_sharded_roundtrip_without_a_group(tmp_path):
    """A plain module in a process with no process group: every tensor back
    exactly (DCP's one-process path), the checkpoint overwritten in place."""
    path = str(tmp_path / "ckpt")
    tck.save_params_sharded(port_vae(2), path)
    params = port_vae(0)
    tck.save_params_sharded(params, path)
    restored = tck.load_params_sharded(path, like=port_vae(1))
    assert_flat_equal(flat_from_module(restored), flat_from_module(params))


def test_sharded_checks_the_template(tmp_path):
    path = str(tmp_path / "ckpt")
    tck.save_params_sharded(port_vae(0), path)
    wide = port_vae(0, tcfg.VAEConfig(motion_dim=12, code_dim=8, depth=2, num_heads=4,
                                      hidden_dim=64, patch_nums=(1, 2, 4)))
    with pytest.raises(ValueError, match="shape mismatch for 'encoder//inp//w'"):
        tck.load_params_sharded(path, like=wide)
    deeper = port_vae(0, tcfg.VAEConfig(motion_dim=12, code_dim=8, depth=3, num_heads=4,
                                        hidden_dim=32, patch_nums=(1, 2, 4)))
    with pytest.raises((KeyError, ValueError)):
        tck.load_params_sharded(path, like=deeper)


def test_sharded_checkpoint_at_tp2(job_started):
    """Two gloo processes at tp = 2: each rank wrote its own shard file; the
    checkpoint restored into a (1, 2) mesh, a (2, 1) mesh, an unsharded
    model, and (the gathered .npz) into a (1, 2) mesh, each equal to the
    saved weights; and here, with no process group, into a plain model."""
    flat, ckpt, started = job_started
    ranks = finish_job(started)
    files = sorted(os.listdir(ckpt / "sharded"))
    assert files == [".metadata", "__0_0.distcp", "__1_0.distcp"], files
    q = flat["blocks//q//w"]
    np.testing.assert_array_equal(ranks[0]["q_local"], q[..., : q.shape[-1] // 2])
    np.testing.assert_array_equal(ranks[1]["q_local"], q[..., q.shape[-1] // 2:])
    for rank in ranks:
        for name in ("tp2", "dp2", "plain", "npz_tp2"):
            assert_flat_equal({k[len(name) + 1:]: v for k, v in rank.items()
                               if k.startswith(name + "/")}, flat)
    assert not torch.distributed.is_initialized()
    model = BitwiseARModel(jobs.SMALL_CFG).init(torch.Generator().manual_seed(1))
    tck.load_params_sharded(str(ckpt / "sharded"), like=model)
    assert_flat_equal(flat_from_module(model), flat)


# ----------------------------------------------------------------- config


def test_config_json_roundtrip(tmp_path):
    """Reference-format config.json loads verbatim and round-trips."""
    p = tmp_path / "config.json"
    p.write_text(json.dumps(REF_JSON))
    cfg = tcfg.load_config(str(p))
    assert cfg.ar.depth == 12 and cfg.vae.patch_nums == (1, 5, 25, 50, 100)
    assert cfg.vae.total_tokens == 181 and cfg.window_audio_samples == 64000
    out = cfg.to_json_dict()
    assert out["AR_CONFIG"]["T_DEPTH"] == 12
    assert out["VAE_CONFIG"]["V_PATCH_NUMS"] == [1, 5, 25, 50, 100]
    assert tcfg.ModelConfig.from_json_dict(out).vae == cfg.vae
    p.write_text(json.dumps(out))
    assert tcfg.load_config(str(p)) == cfg


@pytest.mark.parametrize("source", ["default", "reference", "mimi", "small_vae"])
def test_to_json_dict_equals_jax(tmp_path, source):
    if source == "default":
        got, want = tcfg.ModelConfig(), JaxModelConfig()
    elif source == "small_vae":
        got, want = tcfg.ModelConfig(vae=TCFG), JaxModelConfig(vae=CFG)
    else:
        d = json.loads(json.dumps(REF_JSON))
        if source == "mimi":
            d["AR_CONFIG"]["AUDIO_ENCODER"] = "mimi"
        p = tmp_path / "config.json"
        p.write_text(json.dumps(d))
        got, want = tcfg.load_config(str(p)), jax_load_config(str(p))
    assert json.dumps(got.to_json_dict()) == json.dumps(want.to_json_dict())
    assert got.vae.total_tokens == want.vae.total_tokens
    assert got.ar.to_json_dict() == want.ar.to_json_dict()
    assert got.vae.to_json_dict() == want.vae.to_json_dict()


# -------------------------------------------------------------- small API


@pytest.mark.parametrize("schedule,level", [((1, 5, 25, 50, 100), lvl) for lvl in range(4)]
                         + [((1, 2, 4), lvl) for lvl in range(2)])
def test_bits_to_ar_feat_equals_jax(rng, schedule, level):
    """Both classes' ``bits_to_ar_feat`` on the same bits of levels
    0..level: JAX's values, and the port's two classes equal each other."""
    code_dim = 32 if schedule[-1] == 100 else 8
    n = sum(schedule[: level + 1])
    bits = rng.integers(0, 2, (2, n, code_dim)).astype(np.int32)
    want = np.asarray(JaxBSQ(code_dim, schedule).bits_to_ar_feat(level, jnp.asarray(bits)))
    got = MultiScaleBSQ(code_dim, schedule).bits_to_ar_feat(level, torch.from_numpy(bits))
    assert got.shape == want.shape == (2, sum(schedule[1: level + 2]), code_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if schedule == TCFG.patch_nums:
        vae = BitwiseVAE(TCFG)
        np.testing.assert_array_equal(
            vae.bits_to_ar_feat(level, torch.from_numpy(bits)).numpy(), got.numpy())
        np.testing.assert_allclose(
            np.asarray(JaxVAE(CFG).bits_to_ar_feat(level, jnp.asarray(bits))), want, atol=0)


def test_bits_to_ar_feat_is_the_decode_input(rng):
    """At the last level the AR inputs equal ``bits_to_ms_feat`` of the whole
    window's bits (the teacher-forced inputs the decode loop rebuilds)."""
    bits = rng.integers(0, 2, (2, 181, 32)).astype(np.int32)
    bsq = MultiScaleBSQ(32)
    np.testing.assert_array_equal(bsq.bits_to_ar_feat(3, torch.from_numpy(bits[:, :81])).numpy(),
                                  bsq.bits_to_ms_feat(torch.from_numpy(bits)).numpy())


@pytest.mark.parametrize("t", [4, 60, 250])
def test_smooth_motion_savgol_equals_jax(rng, t):
    motion = rng.standard_normal((t, 106)).astype(np.float32)
    got = ARTAvatarInferEngine.smooth_motion_savgol(motion, device="cpu")
    want = JaxEngine.smooth_motion_savgol(motion)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_smooth_motion_savgol_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ARTAvatarInferEngine.smooth_motion_savgol(np.zeros((10, 106), np.float32))


@pytest.mark.parametrize("samples", [400, 2560, 16000, 64000])
def test_hubert_num_output_frames_equals_jax(samples):
    """HuBERT base's conv frontend (narrow layers: the count reads only the
    kernels and strides)."""
    narrow = dict(conv_dim=(8,) * 7, hidden_size=16, num_hidden_layers=1,
                  num_attention_heads=2, intermediate_size=32, num_conv_pos_embeddings=4,
                  num_conv_pos_embedding_groups=2)
    got = HubertEncoder(tcfg.hubert_base_config(**narrow)).num_output_frames(samples)
    assert got == JaxHubert(jax_hubert_config(**narrow)).num_output_frames(samples)
    assert got == JaxHubert().num_output_frames(samples)
