"""Work models from shapes of the Mimi encoder, and of the window step of the
motion model on it.

``mimi_window_work`` walks the encoder's products for one 4-s window: the
resampler's 61-tap filter, every SEANet convolution, the transformer's
matmuls and attention, the downsample, each RVQ stage's distances to its
2048 codewords and the projections and decode. FLOPs are 2 per multiply-add
of those products (torch's FLOP counter counts the same: a CPU test holds
them equal). Bytes are each product's float32 input read once and output
written once per row, and the encoder's weights once per launch, whatever
the rows: the least the un-fused stages move. ``window_step_flops`` is
``work.window_step_flops`` with the wav2vec2 encoder and its resizes
replaced by Mimi and the resizes of its 50 frames.
"""

from __future__ import annotations

import math

from benchmark import work
from benchmark.reference.params_mimi import NO_WAV2VEC, mimi_spec


def _causal_frames(n: int, k: int, stride: int, dilation: int = 1) -> int:
    k_eff = (k - 1) * dilation + 1
    return math.ceil((n - k_eff + (k_eff - stride)) / stride + 1)


def resampled(samples: int) -> int:
    """24 kHz samples the resampler gives for ``samples`` at 16 kHz."""
    return (3 * samples - 3) // 2 + 1


def mimi_window_work(cfg: dict, samples: int, rows: int = 1) -> work.Work:
    """The Mimi encoder on ``rows`` windows of ``samples`` 16 kHz samples
    (``cfg`` the configuration's ``mimi`` group)."""
    flops, acts = 0.0, 0.0

    def conv(cin: int, cout: int, k: int, n_in: int, n_out: int) -> None:
        nonlocal flops, acts
        flops += 2 * n_out * cout * cin * k
        acts += 4 * (cin * n_in + cout * n_out)

    n24 = resampled(samples)
    flops += 2 * n24 * 61
    acts += 4 * (samples + n24)
    f, d = cfg["num_filters"], cfg["hidden_size"]
    conv(1, f, cfg["kernel_size"], n24, n24)
    n = n24
    for i, ratio in enumerate(reversed(cfg["ratios"])):
        c = f * 2 ** i
        for j in range(cfg["num_residual_layers"]):
            h = c // cfg["compress"]
            conv(c, h, cfg["residual_kernel_size"], n, n)
            conv(h, c, 1, n, n)
        m = _causal_frames(n, 2 * ratio, ratio)
        conv(c, 2 * c, 2 * ratio, n, m)
        n = m
    conv(f * 2 ** len(cfg["ratios"]), d, cfg["last_kernel_size"], n, n)
    hd, ffn = cfg["num_heads"] * cfg["head_dim"], cfg["intermediate_size"]
    for _ in range(cfg["num_hidden_layers"]):
        for fi, fo in ((d, 3 * hd), (hd, d), (d, ffn), (ffn, d)):
            flops += 2 * n * fi * fo
            acts += 4 * n * (fi + fo)
        flops += 2 * 2 * n * n * hd
        acts += 4 * (4 * n * hd)
    m = _causal_frames(n, 4, 2)
    conv(d, d, 4, n, m)
    cd, size = cfg["codebook_dim"], cfg["codebook_size"]
    for _ in range(2):                       # the semantic and the acoustic RVQ
        conv(d, cd, 1, m, m)                 # input projection
        conv(cd, d, 1, m, m)                 # output projection of the decode
    stages = cfg["num_quantizers"]
    flops += stages * 2 * m * cd * size
    acts += stages * 4 * (m * cd + m * size)
    weights = 4 * sum(math.prod(shape) for _, shape, _ in mimi_spec(cfg, 1.0))
    return work.Work(flops * rows, weights + acts * rows)


def window_step_flops(m: dict, samples: int) -> float:
    """One window step of the Mimi-conditioned motion model at one row."""
    pns = m["vae"]["patch_nums"]
    base = dict(m, wav2vec=NO_WAV2VEC)
    frames = work.conv_frames(samples, NO_WAV2VEC["conv_kernel"], NO_WAV2VEC["conv_stride"])
    f = work.window_step_flops(base, samples) - work.encoder_flops(NO_WAV2VEC, samples)
    f -= sum(work._resize_flops(frames, pn, NO_WAV2VEC["hidden_size"]) for pn in pns)
    n = _causal_frames(_mimi_frames(m["mimi"], samples), 4, 2)
    f += mimi_window_work(m["mimi"], samples).flops
    return f + sum(work._resize_flops(n, pn, m["mimi"]["hidden_size"]) for pn in pns)


def _mimi_frames(cfg: dict, samples: int) -> int:
    """25 Hz frames out of the SEANet for a window."""
    n = resampled(samples)
    for ratio in reversed(cfg["ratios"]):
        n = _causal_frames(n, 2 * ratio, ratio)
    return n
