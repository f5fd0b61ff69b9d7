"""Flash attention of artalk_tpu_torch (the plain version on the CPU) against
the JAX Pallas kernel in interpret mode, on every case of
tests/test_attention.py and at its tolerances: 2e-5 forward, 3e-5 for the
gradients of q, k, v and the bias (the bias gradient in the bias's broadcast
shape). Also a wholly masked row (0, not NaN, as in JAX), bf16 inputs (bf16
output within 1 bf16 ulp of the largest value: both sides compute in float32
and round once), and the wrapper's device routing."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artalk_tpu.ops.attention import flash_attention as jax_flash

from artalk_tpu_torch.ops import attention as tatt

from test_torch_params import to_np
from test_torch_params import torch_threads  # noqa: F401 (autouse)


def _qkv(rng, b=2, h=3, lq=181, lk=362, hd=64):
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, lq, hd), (b, h, lk, hd), (b, h, lk, hd)))


def _both(q, k, v, bias=None, *, scale):
    """(port, JAX) outputs as numpy float32 arrays."""
    tb = None if bias is None else torch.from_numpy(bias)
    jb = None if bias is None else jnp.asarray(bias)
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v)), tb, scale=scale)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), jb, scale=scale, interpret=True)
    return to_np(got), np.asarray(want)


def _var_bias():
    lvl = np.array([0, 1, 1, 2, 2, 2, 3, 3])
    mask = np.where(lvl[:, None] >= lvl[None, :], 0.0, -np.inf)
    return np.concatenate([np.zeros((8, 8)), mask], axis=1).astype(np.float32)[None, None]


@pytest.mark.parametrize("case", ["no_bias", "var_mask", "pad_100_100", "pad_181_362",
                                  "pad_57_300", "long_256_640"])
def test_forward_matches_jax(rng, case):
    shapes = {"no_bias": {}, "var_mask": dict(lq=8, lk=16),
              "pad_100_100": dict(b=1, h=2, lq=100, lk=100),
              "pad_181_362": dict(b=1, h=2, lq=181, lk=362),
              "pad_57_300": dict(b=1, h=2, lq=57, lk=300),
              "long_256_640": dict(b=1, h=1, lq=256, lk=640, hd=32)}[case]
    scale = {"no_bias": 0.125, "var_mask": 1.0, "long_256_640": 0.1}.get(case, 0.2)
    bias = _var_bias() if case == "var_mask" else None
    q, k, v = _qkv(rng, **shapes)
    got, want = _both(q, k, v, bias, scale=scale)
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_gradients_match_jax(rng):
    """Gradients through the custom VJP, q/k/v and a (1, 1, Lq, Lk) bias."""
    q, k, v = _qkv(rng, b=1, h=2, lq=32, lk=48, hd=16)
    bias = rng.standard_normal((1, 1, 32, 48)).astype(np.float32)

    def jax_loss(q, k, v, bias):
        o = jax_flash(q, k, v, bias=bias, scale=0.25, interpret=True)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    o = tatt.flash_attention(*leaves[:3], leaves[3], scale=0.25)
    (o * torch.cos(o)).sum().backward()
    for t, w in zip(leaves, want):
        assert t.grad.shape == w.shape
        np.testing.assert_allclose(to_np(t.grad), np.asarray(w), atol=3e-5)


def test_gradients_no_bias_match_jax(rng):
    q, k, v = _qkv(rng, b=1, h=1, lq=16, lk=16, hd=8)
    want = jax.grad(lambda q: jnp.sum(jax_flash(q, jnp.asarray(k), jnp.asarray(v), scale=1.0,
                                                interpret=True) ** 2))(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    (tatt.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v), scale=1.0) ** 2
     ).sum().backward()
    np.testing.assert_allclose(to_np(tq.grad), np.asarray(want), atol=3e-5)


def test_wholly_masked_row_is_zero(rng):
    """A row whose every key a -inf bias masks returns 0 in JAX (the running
    max starts at -1e30); the port returns 0 too, with no NaN elsewhere."""
    q, k, v = _qkv(rng, b=1, h=2, lq=20, lk=70, hd=64)
    bias = np.zeros((1, 1, 20, 70), np.float32)
    bias[..., 3, :] = -np.inf
    bias[..., 7, 40:] = -np.inf
    got, want = _both(q, k, v, bias, scale=0.125)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, :, 3], 0.0)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_bf16_within_one_ulp_of_jax(rng):
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(rng, b=1, h=4, lq=199, lk=199, hd=64))
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), scale=0.125, interpret=True)
                      ).astype(np.float32)
    got = tatt.flash_attention(*(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                                 for a in (q, k, v)), scale=0.125)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


def test_plain_version_is_the_cpu_route(rng):
    """On CPU tensors flash_attention is flash_attention_plain and launches
    nothing; its gradient is 0, not NaN, on a wholly masked row (the plain
    recompute's, which the kernel's backward shares)."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(rng, b=1, h=2, lq=40, lk=90,
                                                                    hd=32))
    bias = torch.zeros((1, 1, 40, 90))
    bias[..., 5, :] = float("-inf")
    before = tatt.LAUNCHES
    got = tatt.flash_attention(q, k, v, bias, scale=0.3)
    assert tatt.LAUNCHES == before
    assert torch.equal(got, tatt.flash_attention_plain(q, k, v, bias, scale=0.3))
    got.square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    assert (q.grad[:, :, 5] == 0).all()


def test_other_devices_raise():
    t = torch.zeros((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.flash_attention(t, t, t, scale=1.0)
