"""Work models from shapes, and the H100's published peaks.

The operations a layer's inputs need, whatever kernel computes them: the
FLOPs of every matrix product and convolution of the step (2 per multiply-
add), and for the two block-stack kernels the bytes they must move. Nothing
here looks at the program: the numbers follow from the configuration's
widths and the shapes of the traffic.

``ar_level_work`` and ``encoder_window_work`` are frozen from the port's
``utils/roofline.py`` (one AR level and one encoder window at one row) and
extended to ``rows`` rows that share one read of the weights. The whole-step
models (``window_step_flops``, ``clip_motion_flops``, ``mesh_frame_flops``)
count the products of the motion model's window step and of the mesh frame;
a CPU test holds them to ``torch.utils.flop_counter`` over the port's plain
path.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

HBM_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM
FP32_FLOP_PER_S = 67e12      # fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12     # bf16 tensor cores, dense
PEAKS = {"fp32": FP32_FLOP_PER_S, "bf16": BF16_FLOP_PER_S}


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)

    def bound_s(self, flop_per_s: float) -> float:
        """The least time the chip could take: the slower of the two."""
        return max(self.flops / flop_per_s, self.bytes / HBM_BYTES_PER_S)


def pack_bytes(depth: int, d: int, hidden: int, itemsize: int, floats: int,
               int8: bool) -> int:
    """Bytes of a block-stack weight pack: per layer the (d, 3d), (d, d),
    (d, hidden) and (hidden, d) weights, ``floats`` float32 values, and for
    int8 the float32 scale of each d-deep chunk of each output column."""
    weights = depth * (4 * d * d + 2 * d * hidden)
    scales = depth * (4 * d + 2 * hidden) * 4 if int8 else 0
    return weights * itemsize + depth * floats * 4 + scales


def ar_level_work(depth: int, d: int, hidden: int, num_heads: int, pn: int, start: int,
                  itemsize: int, int8: bool, cache_bytes: int, rows: int = 1) -> Work:
    """One AR block-stack launch: one scale level of ``pn`` tokens for each
    of ``rows`` rows, ``start`` cached keys before them. The pack is read
    once; per row the tokens, the AdaLN rows and the cache prefix are read
    and the features and the level's k/v written; 2 FLOP per weight per
    token, and q.k^T and P.V over ``start + pn`` keys."""
    weights = depth * (4 * d * d + 2 * d * hidden)
    moved = pack_bytes(depth, d, hidden, itemsize, 5 * d + hidden + num_heads, int8)
    per_row = (pn * d * 4 + depth * pn * 6 * d * 4 + 2 * depth * start * d * cache_bytes
               + pn * d * 4 + 2 * depth * pn * d * cache_bytes)
    flops = 2 * weights * pn + depth * 2 * 2 * pn * (start + pn) * d
    return Work(flops * rows, moved + per_row * rows)


def encoder_window_work(depth: int, d: int, hidden: int, frames: int, itemsize: int,
                        int8: bool, rows: int = 1) -> Work:
    """One encoder block-stack launch over ``rows`` windows of ``frames``
    tokens: the pack read once, each row's float32 tokens read and written
    once; 2 FLOP per weight per token, and q.k^T and P.V over the window."""
    weights = depth * (4 * d * d + 2 * d * hidden)
    moved = pack_bytes(depth, d, hidden, itemsize, 9 * d + hidden, int8)
    flops = 2 * weights * frames + depth * 2 * 2 * frames * frames * d
    return Work(flops * rows, moved + 2 * frames * d * 4 * rows)


# ------------------------------------------------------------ whole steps


def conv_frames(samples: int, kernels: Sequence[int], strides: Sequence[int]) -> int:
    n = samples
    for k, s in zip(kernels, strides):
        n = (n - k) // s + 1
    return n


def encoder_flops(w2v: dict, samples: int) -> float:
    """wav2vec2 on one window: the conv frontend, the feature projection,
    the grouped positional conv and the transformer layers."""
    f = 0.0
    n, cin = samples, 1
    for co, k, s in zip(w2v["conv_dim"], w2v["conv_kernel"], w2v["conv_stride"]):
        n = (n - k) // s + 1
        f += 2 * n * co * cin * k
        cin = co
    d, ffn = w2v["hidden_size"], w2v["intermediate_size"]
    f += 2 * n * cin * d
    k, g = w2v["num_conv_pos_embeddings"], w2v["num_conv_pos_embedding_groups"]
    f += 2 * (n + 2 * (k // 2) - k + 1) * d * (d // g) * k
    f += w2v["num_hidden_layers"] * (2 * n * (4 * d * d + 2 * d * ffn) + 4 * n * n * d)
    return f


def _tower_flops(tokens: int, h: int, depth: int) -> float:
    return depth * (2 * tokens * (4 * h * h + 3 * h * h) + 4 * tokens * tokens * h)


def _resize_flops(n_in: int, n_out: int, c: int) -> float:
    return 0.0 if n_in == n_out else 2 * n_out * n_in * c


def window_step_flops(m: dict, samples: int) -> float:
    """One window step of the motion model at one row: the audio condition,
    the AR decode of every level (with its KV-cache prefix and the next
    level's inputs), the VAE decode of the window and its re-encoding into
    the carry bits, and the carry's attention prefix."""
    w2v, ar, vae = m["wav2vec"], m["ar"], m["vae"]
    pns = list(vae["patch_nums"])
    win, cd, h = pns[-1], vae["code_dim"], vae["hidden_dim"]
    d, depth, ca = ar["embed_dim"], ar["depth"], ar["audio_dim"]
    hidden = round(d * ar["mlp_ratio"])
    tokens = sum(pns)
    prev = tokens * ar["prev_ratio"]
    frames = conv_frames(samples, w2v["conv_kernel"], w2v["conv_stride"])
    f = encoder_flops(w2v, samples)
    f += sum(_resize_flops(frames, pn, w2v["hidden_size"]) for pn in pns)
    # AdaLN rows of every block and of the head, the cache prefix's k and v
    f += 2 * tokens * ca * 6 * d * depth + 2 * tokens * ca * 2 * d
    f += depth * 2 * 2 * prev * d * d
    start = prev
    for lvl, pn in enumerate(pns):
        end = start + pn
        f += depth * (2 * pn * (4 * d * d + 2 * d * hidden) + 4 * pn * end * d)
        f += 2 * pn * d * 2 * cd
        if lvl < len(pns) - 1:
            nxt = pns[lvl + 1]
            f += _resize_flops(pn, win, cd) + _resize_flops(win, nxt, cd) + 2 * nxt * cd * d
        start = end
    # VAE: decode [prev | this], re-encode this window, the carry's prefix
    levels = pns[:-1]
    f += 2 * sum(_resize_flops(pn, win, cd) for pn in levels)
    f += 2 * 2 * win * cd * h + _tower_flops(2 * win, h, vae["depth"]) + 2 * 2 * win * h * vae["motion_dim"]
    f += 2 * win * vae["motion_dim"] * h + _tower_flops(win, h, vae["depth"]) + 2 * win * h * cd
    f += sum(_resize_flops(win, pn, cd) + _resize_flops(pn, win, cd) for pn in pns)
    f += _prefix_flops(pns, cd, d)
    return f


def _prefix_flops(pns: Sequence[int], cd: int, d: int) -> float:
    win = pns[-1]
    f = 0.0
    for lvl, pn in enumerate(pns[:-1]):
        f += _resize_flops(pn, win, cd) + _resize_flops(win, pns[lvl + 1], cd)
    return f + 2 * (sum(pns) - 1) * cd * d


def initial_state_flops(m: dict) -> float:
    """The bootstrap carry of a clip: a window of zero motion encoded to
    bits, and their prefix."""
    vae, d = m["vae"], m["ar"]["embed_dim"]
    pns = list(vae["patch_nums"])
    win, cd, h = pns[-1], vae["code_dim"], vae["hidden_dim"]
    f = 2 * win * vae["motion_dim"] * h + _tower_flops(win, h, vae["depth"]) + 2 * win * h * cd
    f += sum(_resize_flops(win, pn, cd) + _resize_flops(pn, win, cd) for pn in pns)
    return f + _prefix_flops(pns, cd, d)


def savgol_flops(frames: int, motion_dim: int) -> float:
    """The two smoothing products over a clip's frames (every dim, then the
    three rotation dims), where the clip is long enough for their windows."""
    f = 0.0
    for window, dims in ((5, motion_dim), (9, 3)):
        n_win = window if frames >= window else (frames if frames % 2 else frames - 1)
        if n_win >= 3:
            f += 2 * frames * frames * dims
    return f


def clip_motion_flops(m: dict, windows: int, frames: int) -> float:
    """``engine.inference`` of one clip: the bootstrap carry, its windows and
    the smoothing of its frames."""
    return (initial_state_flops(m) + windows * window_step_flops(m, m["window_samples"])
            + savgol_flops(frames, m["vae"]["motion_dim"]))


def flame_flops(m: dict) -> float:
    """FLAME on one frame: blend shapes, joints, pose correctives, the
    kinematic chain and the skinning."""
    fl = m["flame"]
    v, j = fl["num_verts"], 5
    comps = fl["n_shape"] + fl["n_exp"]
    f = 2 * v * 3 * comps + 2 * j * v * 3 + 2 * (j - 1) * 9 * v * 3
    return f + 2 * j * 27 + 2 * (j - 1) * 64 + 2 * j * 16 + 2 * v * j * 16 + 2 * v * 16


def mesh_frame_flops(m: dict) -> float:
    """One mesh frame: FLAME and the shading's two perspective-correct
    interpolations per pixel."""
    size = m["renderer"]["image_size"]
    return flame_flops(m) + 2 * 2 * size * size * 9


UNET_CH = {4: 256, 8: 256, 16: 256, 32: 256, 64: 128, 128: 64, 256: 32, 512: 16, 1024: 8}
GAN_CH = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64, 512: 32, 1024: 16}


def _conv(cin: int, cout: int, k: int, res: int) -> float:
    return 2 * cin * cout * k * k * res * res


def _resize2d(c: int, n_in: int, n_out: int) -> float:
    return 2 * c * n_out * n_in * n_in + 2 * c * n_out * n_in * n_out


def styleunet_flops(size: int, in_dim: int = 32, style: int = 512, n_mlp: int = 8) -> float:
    """GAGAvatar's StyleUNet on one frame: the UNet's convolutions and
    resizes, the SFT condition convs, the style MLP, and the StyleGAN2
    generator's modulated convolutions (with their modulation products)."""
    log = size.bit_length() - 1
    ch, gch = UNET_CH, GAN_CH
    f = _conv(in_dim, ch[size], 1, size)
    cin = ch[size]
    for i in range(log, 2, -1):
        hi, lo, cout = 2 ** i, 2 ** (i - 1), ch[2 ** (i - 1)]
        f += _conv(cin, cin, 3, hi) + 2 * _resize2d(cin, hi, lo) + _conv(cin, cout, 3, lo)
        f += _conv(cin, cout, 1, lo)
        cin = cout
    f += _conv(ch[8], ch[4], 3, 4) + 2 * ch[4] * 16 * style
    cin = ch[4]
    for i in range(3, log + 1):
        lo, hi, cout = 2 ** (i - 1), 2 ** i, ch[2 ** i]
        f += _conv(cin, cin, 3, lo) + 2 * _resize2d(cin, lo, hi) + _conv(cin, cout, 3, hi)
        f += _conv(cin, cout, 1, hi) + 2 * (_conv(cout, cout, 3, hi) + _conv(cout, 2 * cout, 3, hi))
        cin = cout
    f += n_mlp * 2 * style * style

    def mod(ci, co, k, res):
        return 2 * style * ci + _conv(ci, co, k, res)

    f += mod(gch[4], gch[4], 3, 4) + mod(gch[4], 3, 1, 4)
    cin = gch[4]
    for i in range(3, log + 1):
        lo, hi, cout = 2 ** (i - 1), 2 ** i, gch[2 ** i]
        f += _resize2d(cin, lo, hi) + mod(cin, cout, 3, hi) + mod(cout, cout, 3, hi)
        f += mod(cout, 3, 1, hi) + _resize2d(3, lo, hi)
        cin = cout
    return f


def gaga_frame_flops(m: dict) -> float:
    """One GAGAvatar frame: FLAME and the super-resolution (the splat's
    compositing and the per-clip avatar encode are left out, so the share
    of the peak this feeds is a lower bound)."""
    return flame_flops(m) + styleunet_flops(m["renderer"]["image_size"])
