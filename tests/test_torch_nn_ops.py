"""Numeric primitives of artalk_tpu_torch against their JAX twins on the same
inputs: nn helpers, exact resize matrices, Savitzky-Golay, yuv420.

Tolerance 1e-6 absolute (float32 on O(1) values: the two frameworks may sum
in another order) unless a test says otherwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artalk_tpu.models import nn as jnn
from artalk_tpu.ops import colorspace as jcs
from artalk_tpu.ops import resample1d as jrs
from artalk_tpu.ops import savgol as jsg

from artalk_tpu_torch.models import nn as tnn
from artalk_tpu_torch.ops import colorspace as tcs
from artalk_tpu_torch.ops import resample1d as trs
from artalk_tpu_torch.ops import savgol as tsg

from test_torch_params import torch_threads  # noqa: F401 (autouse)

ATOL = 1e-6


def _pair(rng, *shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_layer_norm_and_gelus(rng):
    xj, xt = _pair(rng, 3, 7, 48, scale=2.0)
    sj, st = _pair(rng, 48)
    bj, bt = _pair(rng, 48)
    for eps in (1e-5, 1e-6):
        np.testing.assert_allclose(
            tnn.layer_norm(xt, eps, st, bt).numpy(),
            np.asarray(jnn.layer_norm(xj, eps, sj, bj)), atol=ATOL)
    np.testing.assert_allclose(tnn.gelu_tanh(xt).numpy(), np.asarray(jnn.gelu_tanh(xj)), atol=ATOL)
    np.testing.assert_allclose(tnn.gelu_erf(xt).numpy(), np.asarray(jnn.gelu_erf(xj)), atol=ATOL)
    np.testing.assert_allclose(tnn.silu(xt).numpy(), np.asarray(jnn.silu(xj)), atol=ATOL)


def test_attention_helpers(rng):
    xj, xt = _pair(rng, 2, 9, 32)
    heads_t = tnn.split_heads(xt, 4)
    np.testing.assert_array_equal(heads_t.numpy(), np.asarray(jnn.split_heads(xj, 4)))
    np.testing.assert_array_equal(tnn.merge_heads(heads_t).numpy(), xt.numpy())
    np.testing.assert_allclose(tnn.l2_normalize(xt).numpy(),
                               np.asarray(jnn.l2_normalize(xj)), atol=ATOL)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, 2, 4, 9, 8) for _ in range(3))
    mask = np.where(rng.random((9, 9)) < 0.3, -np.inf, 0.0).astype(np.float32)
    mask[:, 0] = 0.0  # every row sees at least one key
    got = tnn.sdpa(qt, kt, vt, scale=0.35, bias=torch.from_numpy(mask)[None, None])
    want = jnn.sdpa(qj, kj, vj, scale=0.35, bias=jnp.asarray(mask)[None, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(tnn.sinusoidal_pe(50, 16), jnn.sinusoidal_pe(50, 16))


@pytest.mark.parametrize("in_size,out_size", [
    (100, 1), (100, 5), (100, 25), (100, 50), (1, 100), (5, 100), (25, 100),
    (50, 100), (199, 1), (199, 5), (199, 25), (199, 50), (199, 100), (255, 7)])
def test_resize_matrices_and_apply(rng, in_size, out_size):
    for t_fn, j_fn, t_mat, j_mat in (
            (trs.resize_area, jrs.resize_area, trs.area_resize_matrix, jrs.area_resize_matrix),
            (trs.resize_linear, jrs.resize_linear, trs.linear_resize_matrix,
             jrs.linear_resize_matrix)):
        np.testing.assert_array_equal(t_mat(in_size, out_size), j_mat(in_size, out_size))
        xj, xt = _pair(rng, 2, in_size, 8)
        np.testing.assert_allclose(t_fn(xt, out_size).numpy(),
                                   np.asarray(j_fn(xj, out_size)), atol=ATOL)


@pytest.mark.parametrize("t", [2, 4, 7, 60, 250])
def test_savgol_matches_jax(rng, t):
    xj, xt = _pair(rng, 1, t, 106)
    np.testing.assert_allclose(tsg.smooth_motion_savgol(xt).numpy(),
                               np.asarray(jsg.smooth_motion_savgol(xj)), atol=ATOL)


def test_yuv420_matches_jax(rng):
    """Bytes equal, except where a float product lands on a rounding edge in
    one framework and not the other: then they differ by 1, on < 0.1% of
    samples."""
    rgb = rng.random((2, 16, 24, 3)).astype(np.float32)
    got = tcs.rgb_to_yuv420p(torch.from_numpy(rgb), channel_axis=-1).numpy()
    want = np.asarray(jcs.rgb_to_yuv420p(jnp.asarray(rgb), channel_axis=-1))
    assert got.shape == want.shape == (2, 24, 24) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    chw = np.ascontiguousarray(rgb.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(
        tcs.rgb_to_yuv420p(torch.from_numpy(chw), channel_axis=1).numpy(), got)


def _conv_site(site: str):
    """A call of one of the port's convolution sites on small CPU inputs."""
    from artalk_tpu_torch.models import wav2vec as tw2v
    from artalk_tpu_torch.models.gagavatar import dino as tdino

    g = torch.Generator().manual_seed(0)
    if site == "wav2vec.conv1d":
        x, w = torch.randn(1, 4, 40, generator=g), torch.randn(8, 4, 3, generator=g)
        tw2v.conv1d(x, w, torch.zeros(8), stride=2)
        tw2v.conv1d(x.bfloat16(), w.bfloat16(), torch.zeros(8).bfloat16(), stride=2)
    elif site == "nn.conv2d":
        x, w = torch.randn(1, 4, 9, 9, generator=g), torch.randn(8, 4, 3, 3, generator=g)
        tnn.conv2d(x, w, torch.zeros(8), padding=1)
        tnn.conv2d(x.bfloat16(), w.bfloat16(), torch.zeros(8).bfloat16(), padding=1)
    else:
        cfg = tdino.DinoConfig(patch_size=14, hidden_size=32, depth=4, num_heads=4,
                               image_size=56)
        model = tdino.DinoDPT(output_dim=16, dino_cfg=cfg).init(g).requires_grad_(False)
        model(torch.rand(1, 3, 56, 56, generator=g))


@pytest.mark.parametrize("site", ["wav2vec.conv1d", "nn.conv2d", "dino"])
def test_convolutions_run_with_tf32_off(site, monkeypatch):
    """With TF32 on (torch's default for cuDNN convolutions), every
    convolution the port's sites call sees both TF32 flags off, and the
    caller's flags are on again afterwards: a float32 convolution does not
    depend on what the caller imported or set."""
    seen = []
    for name in ("conv1d", "conv2d", "conv_transpose2d"):
        def spy(*args, _real=getattr(torch.nn.functional, name), _name=name, **kwargs):
            seen.append((_name, torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return _real(*args, **kwargs)
        monkeypatch.setattr(torch.nn.functional, name, spy)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _conv_site(site)
        after = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen and all(not cudnn and not matmul for _, cudnn, matmul in seen), seen
    assert after == (True, True)
    if site == "dino":   # the patch embedding, both transposed convs and the DPT's convs
        assert {name for name, _, _ in seen} == {"conv2d", "conv_transpose2d"}
        assert sum(name == "conv_transpose2d" for name, _, _ in seen) == 2
