"""The port's int32 key sort (artalk_tpu_torch/ops/sort.py) on the CPU:
``sort_keys_plain`` equals the JAX Pallas bitonic sort of
tools/exp_pallas_sort.py run in interpret mode, bit for bit, and ``np.sort``
on ragged lengths over the full int32 range; ``sort_keys`` routes CPU tensors
to it and raises on what the kernel does not take. The CUDA kernel itself is
held to the plain version on the card by tests/test_torch_cuda.py."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artalk_tpu_torch.ops import sort as tsort
from artalk_tpu_torch.ops._nvcc import launches

from test_torch_params import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _full_range(rng, n):
    """Random int32 keys over the full range, with duplicates and both ends."""
    keys = rng.integers(-(2 ** 31), 2 ** 31 - 1, size=n, dtype=np.int64, endpoint=True)
    if n >= 4:
        keys[: n // 4] = keys[n // 4: 2 * (n // 4)]      # duplicates
        keys[0], keys[-1] = -(2 ** 31), 2 ** 31 - 1
    return keys.astype(np.int32)


@pytest.fixture(scope="module")
def pallas_sort():
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_sort", os.path.join(REPO, "tools", "exp_pallas_sort.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.bitonic_sort


@pytest.mark.parametrize("m", [10, 13])
def test_plain_matches_pallas_interpret(pallas_sort, m):
    keys = _full_range(np.random.default_rng(m), 1 << m)
    want = np.asarray(pallas_sort(jnp.asarray(keys), m=m, interpret=True))
    got = tsort.sort_keys_plain(torch.from_numpy(keys))
    assert got.dtype == torch.int32 and got.shape == (1 << m,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 3, 1000, 4097])
def test_plain_matches_np_sort_on_ragged_lengths(n):
    keys = _full_range(np.random.default_rng(n), n)
    got = tsort.sort_keys_plain(torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


def test_cpu_tensors_take_the_plain_version():
    keys = torch.from_numpy(_full_range(np.random.default_rng(5), 300))
    before = launches()
    assert torch.equal(tsort.sort_keys(keys), tsort.sort_keys_plain(keys))
    assert launches() == before


def test_padded_length():
    """The network's length: the next power of two, at least 2."""
    assert [tsort.padded_length(n) for n in (0, 1, 2, 3, 2048, 2049, 879_296)] == \
        [2, 2, 2, 4, 2048, 4096, 1 << 20]


@pytest.mark.parametrize("keys,match", [
    (torch.zeros(8, dtype=torch.int64), "int32"),
    (torch.zeros((2, 4), dtype=torch.int32), "1-D"),
    (torch.zeros(16, dtype=torch.int32)[::2], "contiguous"),
    (torch.zeros(8, dtype=torch.int32, device="meta"), "unsupported device"),
])
def test_bad_inputs_raise(keys, match):
    with pytest.raises(ValueError, match=match):
        tsort.sort_keys(keys)
