"""A run with the timed path broken underneath must come out not correct.

Each test drives the rest of a run (set-up, window, check) of a cell shrunk
to the CPU, skipping only the look for a card, with one fault planted in the
program: a code bit altered where the decode produces it, a window step that
returns its state unchanged, an answer altered where it is produced, and
(for the pool) half of the batch left out. A sound run passes beside them.
One chip only: no exchange between chips to leave out.
"""

import time

import pytest

from benchmark import run
from benchmark.tests.small import small_context

MESH = ("mesh-offline-exact", {"clip_seconds": [0.2, 1.0], "strata": 4}, 1.0)
STREAM = ("stream-int8-http", {"sessions": 4, "client_processes": 2, "chunk_seconds": 0.16,
                               "period_s": 1.0, "phase_spread_s": 1.0}, 4.0)


def _run(cell):
    workload, traffic, seconds = cell
    ctx = small_context(workload, seed=2**31 + 99, seconds=seconds, traffic=traffic)
    result, numbers = run.execute(ctx, time.perf_counter())
    return result["correct"], numbers


def _flip_bits(monkeypatch):
    from artalk_tpu_torch.models.ar_model import BitwiseARModel

    orig = BitwiseARModel.decode_window
    monkeypatch.setattr(BitwiseARModel, "decode_window",
                        lambda self, *a, **k: 1 - orig(self, *a, **k))


def _stale_state(monkeypatch):
    from artalk_tpu_torch.models.ar_model import BitwiseARModel

    orig = BitwiseARModel.window_step_cond

    def step(self, state, *a, **k):
        _, motion = orig(self, state, *a, **k)
        return state, motion

    monkeypatch.setattr(BitwiseARModel, "window_step_cond", step)


@pytest.mark.parametrize("cell", [MESH, STREAM], ids=["mesh", "stream"])
def test_sound_run_is_correct(cell):
    correct, numbers = _run(cell)
    assert correct, numbers


@pytest.mark.parametrize("cell", [MESH, STREAM], ids=["mesh", "stream"])
@pytest.mark.parametrize("fault", [_flip_bits, _stale_state], ids=["bits", "state"])
def test_broken_decode_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    correct, numbers = _run(cell)
    assert not correct, numbers


def test_altered_motion_is_not_correct(monkeypatch):
    from artalk_tpu_torch.engine import ARTAvatarInferEngine

    orig = ARTAvatarInferEngine._postprocess
    monkeypatch.setattr(ARTAvatarInferEngine, "_postprocess",
                        lambda self, m, fix: orig(self, m, fix) * 1.01)
    correct, numbers = _run(MESH)
    assert not correct, numbers


def test_altered_frames_are_not_correct(monkeypatch):
    from artalk_tpu_torch.models.renderer import MeshRenderer

    orig = MeshRenderer.render_frames

    def frames(self, *a, **k):
        out = orig(self, *a, **k).copy()
        out[:, ::7] = 255 - out[:, ::7]
        return out

    monkeypatch.setattr(MeshRenderer, "render_frames", frames)
    correct, numbers = _run(MESH)
    assert not correct, numbers


def test_pool_leaving_out_half_the_batch_is_not_correct(monkeypatch):
    from artalk_tpu_torch.serving import StreamPool

    orig = StreamPool.device_step

    def step(self, audio, stepped):
        state, motion = orig(self, audio, stepped)
        motion = motion.clone()
        motion[motion.shape[0] // 2:] = 0.0
        return state, motion

    monkeypatch.setattr(StreamPool, "device_step", step)
    correct, numbers = _run(STREAM)
    assert not correct, numbers
