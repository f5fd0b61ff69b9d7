"""The pool step the load tools time, and the HTTP load test as a whole,
against the JAX package on the CPU, with the small golden config's seed-0
weights (``tests/fixtures/torch_golden_small_params.npz`` through
``utils/params.py``):

- ``StreamPool.device_step`` and the host copy equal ``StreamPool.step``
  bit for bit, at B = 4 with 2 sessions stepped and 2 idle, carries too;
  that pool step equals the JAX ``StreamPool.step`` to 1e-5 (the pool
  tolerance of ``tests/test_torch_precision.py``);
- ``tools/bench_http_serving`` with 1 and 2 clients x 2 windows (exact):
  every chunk answers 200, and the motion rows each client receives (its
  warm-up and timed chunks of seed 100 + i) equal the JAX pool stepping the
  same audio from a fresh session to 1e-5; a chunk the server refuses makes
  the tool raise."""

import shutil

import numpy as np
import pytest
import torch

from artalk_tpu.models.ar_model import BitwiseARModel as JaxARModel
from artalk_tpu.serving import StreamPool as JaxStreamPool
from artalk_tpu.utils.assets import save_flame_npz, synthetic_flame

from artalk_tpu_torch.serving import StreamPool
from artalk_tpu_torch.tools import bench_http_serving
from artalk_tpu_torch.utils.params import load_params_npz, params_from_flat

from conftest import no_persistent_compile_cache_fixture
from test_ar_model import CFG
from test_torch_params import FIXTURE, jax_model_and_flat, torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)

_no_persistent_compile_cache = no_persistent_compile_cache_fixture()

SMALL = torch_config(CFG)
POOL_TOL = 1e-5


@pytest.fixture
def exact_env(monkeypatch):
    for k in ("ARTALK_AR_PRECISION", "ARTALK_AR_FUSED"):
        monkeypatch.delenv(k, raising=False)


def _port_model():
    return params_from_flat(load_params_npz(FIXTURE), SMALL)


def _audio(seed: int, n: int, ws: int) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(ws) * 0.1).astype(np.float32) for _ in range(n)]


def test_device_step_is_step_and_matches_the_jax_pool():
    """Two pools of capacity 4, 4 sessions open, sessions 1 and 2 stepped
    over 3 ticks: one through ``step``, one through ``device_step`` and the
    host copy; then the JAX pool on the same weights and audio."""
    model = _port_model()
    ws = model.window_samples
    ticks = {1: _audio(1, 3, ws), 2: _audio(2, 3, ws)}
    by_step, by_device = StreamPool(model, max_sessions=4), StreamPool(model, max_sessions=4)
    for pool in (by_step, by_device):
        assert [pool.open_session() for _ in range(4)] == [0, 1, 2, 3]
    jm = JaxARModel(CFG)
    jpool = JaxStreamPool(jm, jax_model_and_flat(CFG)[1], max_sessions=4)
    assert [jpool.open_session() for _ in range(4)] == [0, 1, 2, 3]
    stepped = torch.tensor([False, True, True, False])
    with torch.no_grad():
        for t in range(3):
            chunks = {sid: ticks[sid][t] for sid in ticks}
            want = by_step.step(chunks)
            buf = np.zeros((4, ws), np.float32)
            for sid, chunk in chunks.items():
                buf[sid] = chunk
            state, motion = by_device.device_step(torch.from_numpy(buf), stepped)
            got = motion.cpu().numpy()
            assert state is by_device._state
            for sid in ticks:
                np.testing.assert_array_equal(got[sid], want[sid])
            for a, b in zip(by_step._state, by_device._state):
                # the wav2vec2 carry holds no audio context: None in both pools
                assert a is b is None or torch.equal(a, b)
            jax_out = jpool.step(chunks)
            for sid in ticks:
                np.testing.assert_allclose(want[sid], np.asarray(jax_out[sid]), atol=POOL_TOL)


def test_http_tool_rows_equal_the_jax_pool(tmp_path, monkeypatch, exact_env, capsys):
    """The whole slice: the tool's server on the golden weights, exact; each
    client's rows against the JAX pool from a fresh session."""
    shutil.copy(FIXTURE, tmp_path / "artalk_params.npz")
    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(tmp_path / "flame_synthetic.npz"))
    monkeypatch.setattr(bench_http_serving, "ASSETS", tmp_path)
    windows = 2
    out = bench_http_serving.main(["--clients", "1", "2", "--windows", str(windows),
                                   "--precision", "exact"], device="cpu", config=SMALL)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "device: cpu"
    assert sum(line.startswith("N=  1  chunk p50") for line in printed) == 1
    assert sum(line.startswith("N=  2  chunk p50") for line in printed) == 1
    assert sum("pool step p50" in line for line in printed) == 2
    assert list(out) == [1, 2]

    jm = JaxARModel(CFG)
    jp = jax_model_and_flat(CFG)[1]
    ws = SMALL.window_audio_samples
    for n, result in out.items():
        assert result["p90_ms"] >= result["p50_ms"] > 0 and result["windows_per_s"] > 0
        assert result["pool_step_p50_ms"] > 0
        assert sorted(result["rows"]) == [100 + i for i in range(n)]
        jpool = JaxStreamPool(jm, jp, max_sessions=2)
        sids = {seed: jpool.open_session() for seed in result["rows"]}
        pcm = {seed: (np.random.default_rng(seed).standard_normal(ws).astype(np.float32)
                      * 0.1) for seed in sids}
        want = [jpool.step({sid: pcm[seed] for seed, sid in sids.items()})
                for _ in range(1 + windows)]
        for seed, rows in result["rows"].items():
            assert rows.shape == (1 + windows, SMALL.vae.window, SMALL.vae.motion_dim)
            for t in range(1 + windows):
                np.testing.assert_allclose(rows[t], np.asarray(want[t][sids[seed]]),
                                           atol=POOL_TOL, err_msg=f"N={n} seed {seed} tick {t}")


def test_http_tool_raises_on_a_refused_chunk(tmp_path, monkeypatch, exact_env):
    """A chunk one sample longer than the window: the server answers 413,
    and the tool raises instead of timing it."""
    save_flame_npz(synthetic_flame(num_verts=400, num_faces=512, seed=2),
                   str(tmp_path / "flame_synthetic.npz"))
    monkeypatch.setattr(bench_http_serving, "ASSETS", tmp_path)
    real = bench_http_serving.run_clients
    monkeypatch.setattr(bench_http_serving, "run_clients",
                        lambda port, n, windows, ws: real(port, n, windows, ws + 1))
    with pytest.raises(RuntimeError, match="clients failed") as info:
        bench_http_serving.main(["--clients", "2", "--windows", "1", "--precision", "exact"],
                                device="cpu", config=SMALL)
    assert "HTTP 413" in str(info.value.__cause__)
