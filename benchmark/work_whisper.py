"""Work models from shapes of the Whisper encoder, of its attention kernel,
and of the window step of the motion model on it.

``whisper_window_work`` walks the encoder's products for one window's 30-s
context: the mel projection of the power spectrum, the two stem
convolutions, and per layer the q, k, v and output projections, both
attention products and the two FFN products. FLOPs are 2 per multiply-add of
those products (torch's FLOP counter counts the same, and no FLOPs for the
FFT: a CPU test holds them equal). Bytes are the front's float32 spectrum
and mel, each product's input read once and output written once per row at
``itemsize`` (2: bfloat16, as the cell runs it), and the encoder's weights
once per call, whatever the rows: the least the un-fused stages move.

``flash_work`` is the flash-attention kernel's: per head 2 Lq Lk hd for
Q K^T and twice 2 Lq Lk hd for P V (the bf16 kernel multiplies p as bf16
hi + lo, two products: PERF.md section 6's convention), and q, k, v and the
output once each. ``window_step_flops`` is ``work.window_step_flops`` with
the wav2vec2 encoder and its resizes replaced by Whisper and the resizes of
the window's 200 positions.
"""

from __future__ import annotations

import math

from benchmark import work
from benchmark.reference.params_mimi import NO_WAV2VEC
from benchmark.reference.params_whisper import whisper_spec


def shapes(cfg: dict) -> dict:
    """The encoder's lengths for the ``whisper`` group ``cfg``: samples,
    mel frames, positions, frequency bins, head size."""
    samples = int(round(cfg["chunk_length"] * cfg["sampling_rate"]))
    frames = samples // cfg["hop_length"]
    return {"samples": samples, "frames": frames, "positions": frames // 2,
            "bins": cfg["n_fft"] // 2 + 1,
            "head_dim": cfg["d_model"] // cfg["encoder_attention_heads"]}


def whisper_window_work(cfg: dict, rows: int = 1, itemsize: int = 2) -> work.Work:
    """The Whisper encoder on ``rows`` 30-s contexts (``cfg`` the
    configuration's ``whisper`` group), its stem and layers computing in
    ``itemsize``-byte values."""
    s = shapes(cfg)
    t, p, bins = s["frames"], s["positions"], s["bins"]
    mels, d, ffn = cfg["num_mel_bins"], cfg["d_model"], cfg["encoder_ffn_dim"]
    flops = 2 * mels * bins * t
    acts = 4 * (s["samples"] + 2 * bins * t + 2 * mels * t)
    flops += 2 * d * mels * 3 * t + 2 * d * d * 3 * p
    acts += itemsize * (mels * t + d * t + d * t + d * p)
    for _ in range(cfg["encoder_layers"]):
        for fi, fo in ((d, d), (d, d), (d, d), (d, d), (d, ffn), (ffn, d)):
            flops += 2 * p * fi * fo
            acts += itemsize * p * (fi + fo)
        flops += 2 * 2 * p * p * d
        acts += itemsize * 4 * p * d
    weights = itemsize * sum(math.prod(shape) for _, shape, _ in whisper_spec(cfg))
    return work.Work(flops * rows, weights + acts * rows)


def flash_work(cfg: dict, rows: int, itemsize: int = 2) -> work.Work:
    """One launch of the flash-attention kernel over ``rows`` contexts:
    every head of every row, Lq = Lk = the positions."""
    s = shapes(cfg)
    p, hd, h = s["positions"], s["head_dim"], cfg["encoder_attention_heads"]
    per_head = work.Work(2 * p * p * hd + 2 * (2 * p * p * hd), itemsize * 4 * p * hd)
    return per_head * (rows * h)


def window_step_flops(m: dict, samples: int) -> float:
    """One window step of the Whisper-conditioned motion model at one row."""
    pns = m["vae"]["patch_nums"]
    base = dict(m, wav2vec=NO_WAV2VEC)
    frames = work.conv_frames(samples, NO_WAV2VEC["conv_kernel"], NO_WAV2VEC["conv_stride"])
    f = work.window_step_flops(base, samples) - work.encoder_flops(NO_WAV2VEC, samples)
    f -= sum(work._resize_flops(frames, pn, NO_WAV2VEC["hidden_size"]) for pn in pns)
    w = m["whisper"]
    keep = samples // (2 * w["hop_length"])
    f += whisper_window_work(w).flops
    return f + sum(work._resize_flops(keep, pn, w["d_model"]) for pn in pns)
