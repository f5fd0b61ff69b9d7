"""Checkpoint conversion without jax: ``artalk_tpu_torch.utils.convert``,
``utils.params.save_params_npz`` and ``python -m
artalk_tpu_torch.convert_checkpoint`` against the JAX package's converter and
``tools/convert_checkpoint.py`` (loaded with importlib).

Reference-layout state dicts come from the JAX tests' own factories (the small
HF wav2vec2, HuBERT and Mimi models, the VAE and style-encoder oracles) and
from seeded arrays for the keys the AR blocks, head, embeddings and the
GAGAvatar networks read. Every comparison is exact: the same keys, and each
array equal in dtype, shape and bytes. End to end, the port's engine on the
port's ``artalk`` archive (CPU) equals the JAX engine on JAX's archive to
atol 1e-5, ``tests/test_torch_engine.py``'s tolerance."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import artalk_tpu.utils.convert as jconv
from artalk_tpu.engine import ARTAvatarInferEngine as JaxEngine
from artalk_tpu.models.bitwise_vae import BitwiseVAE as JaxVAE
from artalk_tpu.utils.checkpoint import _flatten

from artalk_tpu_torch import convert_checkpoint as tool
from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.utils import convert as tconv
from artalk_tpu_torch.utils.assets import save_flame_npz, synthetic_flame
from artalk_tpu_torch.utils.params import (flatten_params, load_params_npz,
                                           params_from_flat, save_params_npz)

from test_ar_model import CFG
from test_bitwise_vae import TorchVAEOracle, _state_dict_in_reference_layout
from test_hubert import SMALL as HUBERT_SMALL, make_hf as make_hf_hubert
from test_mimi import SMALL as MIMI_SMALL, _hf_model as make_hf_mimi
from test_style_encoder import TorchOracle
from test_wav2vec import make_hf_model
from test_torch_params import torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint_jax", os.path.join(REPO, "tools", "convert_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _numpy_sd(module: torch.nn.Module, prefix: str = "") -> dict:
    return {prefix + k: v.detach().numpy() for k, v in module.state_dict().items()}


def _assert_flat_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        assert g.tobytes() == w.tobytes(), key


def _assert_npz_equal(got_path: str, want_path: str) -> None:
    _assert_flat_equal(load_params_npz(got_path), load_params_npz(want_path))


# ------------------------------------------------------- reference state dicts


def _arr(rng, *shape, scale=0.05):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def artalk_state_dict(seed: int = 0) -> dict:
    """A reference ``ARTalk_wav2vec.pt`` state dict at test_ar_model's CFG."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    ar, vae = CFG.ar, CFG.vae
    sd = _numpy_sd(make_hf_model(CFG.wav2vec), "audio_encoder.")
    vae_sd = _state_dict_in_reference_layout(TorchVAEOracle(vae).eval(), JaxVAE(vae), rng)
    sd.update({f"basic_vae.{k}": v for k, v in vae_sd.items()})
    style = TorchOracle(motion_dim=vae.motion_dim, d=ar.style_dim, heads=4, layers=4, ff=512)
    style_sd = _numpy_sd(style)
    style_sd["PE.pe"] = style_sd.pop("pe")      # the reference's buffer name
    sd.update({f"style_encoder.{k}": v for k, v in style_sd.items()})
    d, cd, h = ar.embed_dim, ar.audio_feature_dim, ar.num_heads
    hidden = round(d * ar.mlp_ratio)
    total = sum(vae.patch_nums)

    def lin(name, out, inp, bias=True):
        sd[f"{name}.weight"] = _arr(rng, out, inp)
        if bias:
            sd[f"{name}.bias"] = _arr(rng, out)

    for i in range(ar.depth):
        pre = f"attn_blocks.{i}"
        lin(f"{pre}.ada_lin.1", 6 * d, cd)
        lin(f"{pre}.attn.query", d, d)
        lin(f"{pre}.attn.key", d, d, bias=False)
        lin(f"{pre}.attn.value", d, d)
        lin(f"{pre}.attn.proj", d, d)
        sd[f"{pre}.attn.scale_mul_1H11"] = np.log(4.0).astype(np.float32) + _arr(rng, 1, h, 1, 1)
        lin(f"{pre}.ffn.0", hidden, d)
        lin(f"{pre}.ffn.2", d, hidden)
    lin("vqfeat_embed", d, vae.code_dim)
    lin("style_cond_embed", d, ar.style_dim)
    lin("cond_logits_head.ada_lin.1", 2 * d, cd)
    lin("logits_head", 2 * vae.code_dim, d)
    sd["null_style_cond"] = _arr(rng, 1, 1, d, scale=0.5)
    sd["pos_embed"] = _arr(rng, 1, total, d)
    sd["prev_pos_embed"] = _arr(rng, 1, total * ar.prev_ratio, d)
    sd["lvl_embed.weight"] = _arr(rng, len(vae.patch_nums), d)
    return sd


def gaga_state_dict(seed: int = 0, n_up: int = 2) -> dict:
    """A ``GAGAvatar.pt`` 'model' state dict holding every key the GAGAvatar
    converters read (tiny seeded arrays; conversion only moves them)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def lin(pre, bias=True):
        sd[f"{pre}.weight"] = _arr(rng, 3, 2)
        if bias:
            sd[f"{pre}.bias"] = _arr(rng, 3)

    def conv(pre, bias=True):
        sd[f"{pre}.weight"] = _arr(rng, 3, 2, 1, 1)
        if bias:
            sd[f"{pre}.bias"] = _arr(rng, 3)

    def ln(pre):
        sd[f"{pre}.weight"], sd[f"{pre}.bias"] = _arr(rng, 4), _arr(rng, 4)

    vit = "base_model.dino_model."
    conv(f"{vit}patch_embed.proj")
    sd[f"{vit}cls_token"], sd[f"{vit}pos_embed"] = _arr(rng, 1, 1, 4), _arr(rng, 1, 5, 4)
    ln(f"{vit}norm")
    for i in range(2):
        pre = f"{vit}blocks.{i}"
        for name in ("norm1", "norm2"):
            ln(f"{pre}.{name}")
        for name in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            lin(f"{pre}.{name}")
        sd[f"{pre}.ls1.gamma"], sd[f"{pre}.ls2.gamma"] = _arr(rng, 4), _arr(rng, 4)
    for i in range(4):
        conv(f"base_model.projects.{i}")
        conv(f"base_model.layer_rn.{i}", bias=False)
        for unit in ("resConfUnit1", "resConfUnit2"):
            for c in ("conv1", "conv2"):
                conv(f"base_model.refinenet.{i}.{unit}.{c}")
        conv(f"base_model.refinenet.{i}.out_conv")
    for i in (0, 1, 3):
        conv(f"base_model.resize_layers.{i}")
    conv("base_model.output_conv")
    sd["head_base"] = _arr(rng, 5, 4)
    for i in (0, 2, 4, 6):
        lin(f"gs_generator_g.feature_layers.{i}")
        for gen in ("gs_generator_l0", "gs_generator_l1"):
            conv(f"{gen}.gaussian_conv.{i}")
    for name in ("color", "opacity", "scale", "rotation"):
        for i in (0, 2):
            lin(f"gs_generator_g.{name}_layers.{i}")
    up = "upsampler"
    conv(f"{up}.conv_body_first")
    conv(f"{up}.final_conv")
    lin(f"{up}.final_linear")
    for i in range(n_up):
        for body in ("conv_body_down", "conv_body_up"):
            conv(f"{up}.{body}.{i}.conv1")
            conv(f"{up}.{body}.{i}.conv2")
            conv(f"{up}.{body}.{i}.skip", bias=False)
        conv(f"{up}.toRGB.{i}")
        for cond in ("condition_scale", "condition_shift"):
            conv(f"{up}.{cond}.{i}.0")
            conv(f"{up}.{cond}.{i}.2")
    gan = f"{up}.stylegan_decoder"
    for i in range(2):
        lin(f"{gan}.style_mlp.{1 + 2 * i}")
    sd[f"{gan}.constant_input.weight"] = _arr(rng, 1, 3, 4, 4)

    def modconv(pre):
        lin(f"{pre}.modulated_conv.modulation")
        sd[f"{pre}.modulated_conv.weight"] = _arr(rng, 1, 3, 2, 3, 3)

    for pre in [f"{gan}.style_conv1"] + [f"{gan}.style_convs.{j}" for j in range(2 * n_up)]:
        modconv(pre)
        sd[f"{pre}.weight"], sd[f"{pre}.bias"] = _arr(rng, 1), _arr(rng, 1, 3, 1, 1)
    for pre in [f"{gan}.to_rgb1"] + [f"{gan}.to_rgbs.{j}" for j in range(n_up)]:
        modconv(pre)
        sd[f"{pre}.bias"] = _arr(rng, 1, 3, 1, 1)
    for i in range(2 * n_up + 1):
        sd[f"{gan}.noises.noise{i}"] = _arr(rng, 1, 1, 4, 4)
    return sd


@pytest.fixture(scope="module")
def dicts():
    torch.manual_seed(1)
    return {"artalk": artalk_state_dict(),
            "gaga": gaga_state_dict(),
            "hubert": _numpy_sd(make_hf_hubert(HUBERT_SMALL)),
            "mimi": _numpy_sd(make_hf_mimi(MIMI_SMALL))}


# converter name -> (state dict, how both packages call it)
CONVERTERS = {
    "wav2vec": ("artalk", lambda m, sd: m.convert_wav2vec(m._subdict(sd, "audio_encoder."))),
    "hubert": ("hubert", lambda m, sd: m.convert_wav2vec(sd)),
    "mimi": ("mimi", lambda m, sd: m.convert_mimi(sd, num_layers=MIMI_SMALL.num_hidden_layers)),
    "vae": ("artalk", lambda m, sd: m.convert_vae(m._subdict(sd, "basic_vae."))),
    "style_encoder": ("artalk", lambda m, sd: m.convert_style_encoder(
        m._subdict(sd, "style_encoder."), feature_dim=CFG.ar.style_dim)),
    "ar_model": ("artalk", lambda m, sd: m.convert_ar_model(sd)),
    "dino_vit": ("gaga", lambda m, sd: m.convert_dino_vit(
        m._subdict(sd, "base_model.dino_model."))),
    "dino_dpt": ("gaga", lambda m, sd: m.convert_dino_dpt(m._subdict(sd, "base_model."))),
    "gs_generator_linear": ("gaga", lambda m, sd: m.convert_gs_generator_linear(
        m._subdict(sd, "gs_generator_g."))),
    "gs_generator_conv": ("gaga", lambda m, sd: m.convert_gs_generator_conv(
        m._subdict(sd, "gs_generator_l1."))),
    "style_unet": ("gaga", lambda m, sd: m.convert_style_unet(m._subdict(sd, "upsampler."))),
    "gagavatar": ("gaga", lambda m, sd: m.convert_gagavatar(sd)),
}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_equals_jax(dicts, name):
    """Each sub-converter's tree, flattened by each package's own flattener."""
    which, call = CONVERTERS[name]
    _assert_flat_equal(flatten_params(call(tconv, dicts[which])),
                       _flatten(call(jconv, dicts[which])))


def test_stack_rejects_mismatched_trees():
    with pytest.raises(ValueError, match="keys"):
        tconv._stack([{"a": np.zeros(1)}, {"b": np.zeros(1)}])
    stacked = tconv._stack([{"a": [np.zeros(2), np.ones(2)]}] * 3)
    assert stacked["a"][1].shape == (3, 2)


def test_flatten_and_save_round_trip(tmp_path):
    """``flatten_params`` keys a tree as JAX's ``_flatten`` does (sorted
    dict keys, list and tuple indices, ``None`` dropped, dtypes kept), and
    ``save_params_npz`` round-trips through ``load_params_npz``, from the
    tree and from its flat dict alike."""
    rng = np.random.default_rng(0)
    tree = {"b": [rng.standard_normal((2, 3)).astype(np.float32),
                  {"k": np.arange(4, dtype=np.int64), "none": None}],
            "a": (np.float16(1.5), np.array(3, np.int32)),
            "c": {"10": np.ones(1, np.float32), "2": np.zeros((1, 1), np.float64)}}
    flat = flatten_params(tree)
    _assert_flat_equal(flat, _flatten(tree))
    assert list(flat) == list(_flatten(tree))
    for i, src in enumerate((tree, flat)):
        path = str(tmp_path / f"p{i}" / "params.npz")
        save_params_npz(src, path)
        _assert_flat_equal(load_params_npz(path), flat)


# --------------------------------------------------------------- the tool


def _save_pt(obj, path) -> str:
    torch.save(obj, str(path))
    return str(path)


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def test_artalk_archive_equals_jax_and_runs(dicts, jax_tool, tmp_path):
    src = _save_pt(_tensors(dicts["artalk"]), tmp_path / "ARTalk_wav2vec.pt")
    assets = {}
    for side in ("jax", "torch"):
        assets[side] = tmp_path / f"assets_{side}"
        assets[side].mkdir()
        save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                       str(assets[side] / "flame_synthetic.npz"))
    jax_tool.convert_artalk(src, str(assets["jax"] / "artalk_params.npz"))
    tool.main(["artalk", src, str(assets["torch"] / "artalk_params.npz")])
    _assert_npz_equal(str(assets["torch"] / "artalk_params.npz"),
                      str(assets["jax"] / "artalk_params.npz"))

    jeng = JaxEngine(assets_dir=str(assets["jax"]), output_dir=str(tmp_path / "jout"),
                     config=CFG, image_size=64, interpret=True)
    teng = ARTAvatarInferEngine(assets_dir=str(assets["torch"]),
                                output_dir=str(tmp_path / "tout"),
                                config=torch_config(CFG), image_size=64, device="cpu")
    audio = (np.random.default_rng(4).standard_normal(11200) * 0.1).astype(np.float32)
    want = jeng.inference(audio)
    got = teng.inference(audio)
    assert got.shape == want.shape == (18, CFG.vae.motion_dim)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the archive holds the model's parameters and nothing the bridge rejects
    params_from_flat(load_params_npz(str(assets["torch"] / "artalk_params.npz")),
                     torch_config(CFG))


def test_gaga_archive_equals_jax(dicts, jax_tool, tmp_path):
    model = _tensors(dicts["gaga"])
    model["percep_loss.vgg.0.weight"] = torch.zeros(2, 2)     # dropped by both
    src = _save_pt({"model": model}, tmp_path / "GAGAvatar.pt")
    jax_tool.convert_gaga(src, str(tmp_path / "jax.npz"))
    tool.main(["gaga", src, str(tmp_path / "torch.npz")])
    _assert_npz_equal(str(tmp_path / "torch.npz"), str(tmp_path / "jax.npz"))
    assert not any("percep" in k for k in load_params_npz(str(tmp_path / "torch.npz")))


def flame_checkpoint(j_regressor_sparse: bool) -> dict:
    """A synthetic ``FLAME_with_eye.pt``: the FLAME tables as tensors in the
    reference layout, and the landmark embeddings."""
    data = synthetic_flame(num_verts=400, num_faces=512, seed=2)
    v, p = data["v_template"].shape[0], data["posedirs"].shape[0]
    rng = np.random.default_rng(5)
    j_reg = torch.from_numpy(np.where(data["J_regressor"] > 1e-3, data["J_regressor"], 0.0))
    fm = {"v_template": torch.from_numpy(data["v_template"]),
          "shapedirs": torch.from_numpy(data["shapedirs"]),
          "posedirs": torch.from_numpy(data["posedirs"].T.reshape(v, 3, p).copy()),
          "J_regressor": j_reg.to_sparse() if j_regressor_sparse else j_reg,
          "kintree_table": torch.from_numpy(np.stack([data["parents"], np.arange(5)])
                                            .astype(np.int64)),
          "weights": torch.from_numpy(data["lbs_weights"]),
          "f": torch.from_numpy(data["faces"].astype(np.int64))}
    lmk = {"full_lmk_faces_idx_with_eye": torch.from_numpy(rng.integers(0, 512, (1, 70))),
           "full_lmk_bary_coords_with_eye": torch.from_numpy(
               rng.dirichlet(np.ones(3), (1, 70)).astype(np.float32)),
           "dynamic_lmk_faces_idx": torch.from_numpy(rng.integers(0, 512, (79, 17))),
           "dynamic_lmk_bary_coords": torch.from_numpy(
               rng.dirichlet(np.ones(3), (79, 17)).astype(np.float32))}
    return {"flame_model": fm, "lmk_embeddings": lmk}


def test_flame_archive_equals_jax(jax_tool, tmp_path):
    """Dense J_regressor: the two tools write the same archive. A sparse
    tensor (which the JAX tool cannot turn into an array) converts to the
    same archive in the port."""
    dense = _save_pt(flame_checkpoint(False), tmp_path / "FLAME_with_eye.pt")
    sparse = _save_pt(flame_checkpoint(True), tmp_path / "FLAME_sparse.pt")
    jax_tool.convert_flame(dense, str(tmp_path / "jax.npz"))
    tool.main(["flame", dense, str(tmp_path / "torch.npz")])
    tool.main(["flame", sparse, str(tmp_path / "torch_sparse.npz")])
    _assert_npz_equal(str(tmp_path / "torch.npz"), str(tmp_path / "jax.npz"))
    _assert_npz_equal(str(tmp_path / "torch_sparse.npz"), str(tmp_path / "jax.npz"))
    assert "dynamic_lmk_bary_coords" in load_params_npz(str(tmp_path / "jax.npz"))


def _assert_dirs_equal(got_dir, want_dir) -> None:
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for name in names:
        if name.endswith(".npz"):
            _assert_npz_equal(os.path.join(got_dir, name), os.path.join(want_dir, name))
        else:
            g, w = np.load(os.path.join(got_dir, name)), np.load(os.path.join(want_dir, name))
            _assert_flat_equal({name: g}, {name: w})


def test_tracked_and_style_equal_jax(jax_tool, tmp_path):
    rng = np.random.default_rng(6)
    bank = {f"avatar_{i}.jpg": {"image": torch.from_numpy(_arr(rng, 3, 8, 8)),
                                "shapecode": torch.from_numpy(_arr(rng, 300)),
                                "transform_matrix": [[1.0, 0.0], [0.0, 1.0]]}
            for i in range(2)}
    src = _save_pt(bank, tmp_path / "tracked.pt")
    jax_tool.convert_tracked(src, str(tmp_path / "tracked_jax"))
    tool.main(["tracked", src, str(tmp_path / "tracked_torch")])
    _assert_dirs_equal(tmp_path / "tracked_torch", tmp_path / "tracked_jax")

    style_src = tmp_path / "style_pt"
    style_src.mkdir()
    for name in ("calm", "lively"):
        _save_pt(torch.from_numpy(_arr(rng, 50, 106)), style_src / f"{name}.pt")
    (style_src / "notes.txt").write_text("not a motion")
    jax_tool.convert_style(str(style_src), str(tmp_path / "style_jax"))
    proc = subprocess.run([sys.executable, "-m", "artalk_tpu_torch.convert_checkpoint", "style",
                           str(style_src), str(tmp_path / "style_torch")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 2 style motions" in proc.stdout
    _assert_dirs_equal(tmp_path / "style_torch", tmp_path / "style_jax")
