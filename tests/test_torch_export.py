"""The window-step export of artalk_tpu_torch (counterpart of
tests/test_export.py): the saved and reloaded ``torch.export`` program
reproduces the live window step exactly over two windows with the carry
threaded through, on tests/test_export.py's small config, and so does the
program loaded with another checkpoint's weights (a missing or misshapen one
raises); the configurations whose step launches a ctypes kernel raise; the
CLI writes the program and a ``params.npz`` that loads back into the port. The window step itself is held
to JAX's by tests/test_torch_ar_model.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from artalk_tpu_torch import export_model
from artalk_tpu_torch.models.ar_model import BitwiseARModel
from artalk_tpu_torch.utils.params import (flat_from_module, load_params_npz, params_from_flat,
                                           save_params_npz)

from test_export import CFG
from test_torch_params import torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)

TCFG = torch_config(CFG)


@pytest.fixture(scope="module")
def model():
    return BitwiseARModel(TCFG).init(torch.Generator().manual_seed(0))


def assert_steps_equal(step, model: BitwiseARModel) -> None:
    """Two windows of ``step`` (batch 2) equal ``model``'s eager window step
    bit for bit, carry and motions."""
    rng = np.random.default_rng(0)
    style = torch.from_numpy(rng.standard_normal((2, 1, CFG.ar.embed_dim)).astype(np.float32)
                             * 0.1)
    with torch.no_grad():
        want = got = model.initial_state(style, batch_size=2)
        for _ in range(2):
            chunk = torch.from_numpy(rng.standard_normal((2, model.window_samples))
                                     .astype(np.float32) * 0.1)
            want, want_motion = model.window_step(want, chunk, style)
            got, got_motion = step(got, chunk, style)
            assert torch.equal(got.prev_bits, want.prev_bits)
            assert torch.equal(got.prev_attn_feat, want.prev_attn_feat)
            assert torch.equal(got_motion, want_motion)
    assert want_motion.shape == (2, CFG.vae.window, CFG.vae.motion_dim)


@pytest.fixture(scope="module")
def saved_program(model, tmp_path_factory):
    """The window step of ``model`` (weights A) exported at batch 2 and saved."""
    path = str(tmp_path_factory.mktemp("exported") / "window_step_b2.pt2")
    torch.export.save(export_model.export_window_step(model, batch=2, device="cpu"), path)
    return path


def test_exported_window_step_roundtrip(model, saved_program):
    """Export at batch 2, save, load: two windows of the loaded program equal
    the eager window step bit for bit, carry and motions."""
    assert_steps_equal(export_model.load_window_step(saved_program), model)


@pytest.mark.parametrize("form", ["dict", "npz"])
def test_loaded_program_takes_other_weights(saved_program, tmp_path, form):
    """The program traced with weights A, loaded with weights B (a flat dict,
    or params.npz as ``main`` writes it): two windows equal B's eager window
    step bit for bit."""
    other = BitwiseARModel(TCFG).init(torch.Generator().manual_seed(1))
    flat = flat_from_module(other)
    params = flat
    if form == "npz":
        params = str(tmp_path / "params.npz")
        save_params_npz(flat, params)
    assert_steps_equal(export_model.load_window_step(saved_program, params), other)


def test_loaded_program_refuses_incomplete_weights(saved_program, model):
    flat = flat_from_module(model)
    del flat["blocks//q//w"]
    with pytest.raises(KeyError, match="blocks//q//w"):
        export_model.load_window_step(saved_program, flat)
    flat = flat_from_module(model)
    flat["pos_embed"] = flat["pos_embed"][:, :-1]
    with pytest.raises(ValueError, match="pos_embed"):
        export_model.load_window_step(saved_program, flat)


@pytest.mark.parametrize("change,name", [
    ({"fused_ar": True}, "fused_ar"),
    ({"int8_ar": True, "fused_ar": True}, "int8_ar"),
    ({"wav2vec": dataclasses.replace(TCFG.wav2vec, use_flash_attention=True)},
     "use_flash_attention"),
])
def test_kernel_configurations_raise(change, name):
    model = BitwiseARModel(dataclasses.replace(TCFG, **change))
    with pytest.raises(ValueError, match=name):
        export_model.export_window_step(model, device="cpu")


def test_main_writes_program_and_params(tmp_path, monkeypatch):
    """``python -m artalk_tpu_torch.export_model`` without a checkpoint (the
    small config in place of ModelConfig()): the program and a params.npz
    that loads into the port's model with the exported weights."""
    monkeypatch.setattr(export_model, "ModelConfig", lambda: TCFG)
    out = tmp_path / "exported"
    path = export_model.main(["--out", str(out), "--checkpoint", str(tmp_path / "none.npz"),
                              "--device", "cpu"])
    assert os.path.basename(path) == "window_step_b1.pt2" and os.path.exists(path)
    flat = load_params_npz(str(out / "params.npz"))
    loaded = params_from_flat(flat, TCFG)
    want = flat_from_module(BitwiseARModel(TCFG).init(torch.Generator().manual_seed(0)))
    got = flat_from_module(loaded)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    program = torch.export.load(path)
    assert {p.shape for p in program.state_dict.values()} >= {v.shape for v in want.values()}
