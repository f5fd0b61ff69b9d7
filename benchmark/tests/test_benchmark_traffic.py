"""The seeded traffic: clip lengths, session phases and chunk due times."""

import numpy as np

from benchmark import traffic

OFFLINE = {"clip_seconds": [4.0, 30.0], "strata": 16}
STREAM = {"sessions": 140, "period_s": 4.0, "chunk_seconds": 4.0, "phase_spread_s": 4.0,
          "distinct_chunks": 16}
BIG_SEED = 2**31 + 12345


def test_clip_lengths_are_the_same_set_on_every_seed():
    # the same list in the same order, so that a window ending inside it
    # times the same mix of lengths on every seed
    a = traffic.clip_seconds(OFFLINE)
    assert [len(x) for x in traffic.clip_audio(OFFLINE, 1)] == \
        [len(x) for x in traffic.clip_audio(OFFLINE, BIG_SEED)] == [round(x * 16000) for x in a]
    assert a != sorted(a)
    # short and long alternate: each half and each quarter of the list holds
    # an even share of the strata
    rank = {x: i for i, x in enumerate(sorted(a))}
    for part in (8, 4):
        for k in range(0, 16, part):
            ranks = sorted(rank[x] for x in a[k:k + part])
            assert ranks == list(range(ranks[0] % (16 // part), 16, 16 // part))


def test_clip_lengths_are_log_uniform_quantiles_within_the_range():
    lengths = sorted(traffic.clip_seconds(OFFLINE))
    assert len(lengths) == 16
    assert 4.0 < lengths[0] < lengths[-1] < 30.0
    logs = np.log(lengths)
    assert np.allclose(np.diff(logs), np.diff(logs)[0])     # even steps in log space
    # at most 750 frames (the engine's clip_length) and at least one window
    assert all(100 <= s * 25 <= 750 for s in lengths)


def test_clip_audio_is_seeded_and_sized():
    a = traffic.clip_audio({"clip_seconds": [0.5, 1.0], "strata": 3}, BIG_SEED)
    b = traffic.clip_audio({"clip_seconds": [0.5, 1.0], "strata": 3}, BIG_SEED)
    lengths = traffic.clip_seconds({"clip_seconds": [0.5, 1.0], "strata": 3})
    for x, y, s in zip(a, b, lengths):
        assert x.dtype == np.float32 and len(x) == round(s * 16000)
        assert np.array_equal(x, y)
        assert 0.0 < np.abs(x).max() <= 0.1 + 1e-6


def test_session_phases_spread_evenly_over_the_period():
    phases = traffic.session_phases(STREAM, BIG_SEED)
    assert len(phases) == 140
    assert np.allclose(np.sort(phases), (np.arange(140) + 0.5) / 140 * 4.0)
    assert not np.allclose(phases, np.sort(phases))       # dealt in the seed's order


def test_chunk_dues_follow_the_period_and_stop_at_the_window():
    for s in (0, 17, 139):
        dues = traffic.chunk_dues(STREAM, BIG_SEED, s, 40.0)
        first = traffic.session_phases(STREAM, BIG_SEED)[s]
        assert dues[0] == first
        assert np.allclose(np.diff(dues), 4.0)
        assert dues[-1] < 40.0 <= dues[-1] + 4.0
    assert sum(len(traffic.chunk_dues(STREAM, 5, s, 40.0)) for s in range(140)) == 1400


def test_chunks_come_from_the_seeded_pool():
    pool = {traffic.chunk_audio(STREAM, BIG_SEED, s, k).tobytes()
            for s in range(20) for k in range(5)}
    assert 1 < len(pool) <= 16
    c = traffic.chunk_audio(STREAM, BIG_SEED, 3, 2)
    assert c.shape == (64000,) and c.dtype == np.float32
