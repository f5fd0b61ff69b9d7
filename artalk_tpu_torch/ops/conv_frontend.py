"""The wav2vec2 conv front of the "layer" layout (XLS-R): the feature convs,
each with its channel LayerNorm and erf-GELU, the feature projection between
them and the grouped positional conv with its residual add.

``conv_frontend`` runs the eight convolutions of a bfloat16 window as eight
launches of the CUDA kernels in ``csrc/conv_frontend.cu`` (one per conv, on
the bf16 tensor cores) for CUDA tensors, and ``conv_frontend_plain`` for CPU
tensors; for a CUDA tensor it launches the kernels or raises. The feature
projection between them (a LayerNorm and a bf16 matrix product) stays with
the caller, who passes it in as ``project``.

The plain version is the eager path's arithmetic, which the kernels repeat
value for value but for the order of each float32 sum: ``conv1d`` convolves
bf16 values in float32 and rounds once, then adds the bf16 bias; the
LayerNorm is ``models/nn.layer_norm`` over the channels; the GELU is erf's.
A row's result does not depend on the batch, in the kernels and in the plain
version.

Weights are packed once per model (``pack_frontend``): each feature conv's
weight (out, in, k) as (out, k * in), ``w[o][j * in + c]``, and the
positional conv's (d, d / groups, k) as (d, k * d / groups), all bf16, so
that a contraction step of 64 is one tap's 64 channels.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..models import nn as tnn
from ..parallel.sharding import whole
from ._nvcc import CSRC, Library
from .ar_block_stack import check_launch, ptr

CHANNELS = 512     # the kernels' feature-conv width
GROUP = 64         # the kernels' positional-conv channels per group
MAX_K0 = 16        # conv0's largest kernel in csrc/conv_frontend.cu


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           **kwargs) -> torch.Tensor:
    """``F.conv1d``; bfloat16 inputs are convolved in float32 and rounded
    once, then the bias is added in bfloat16, as XLA computes a bf16
    convolution. (PyTorch's CPU bf16 grouped convolution loses most of its
    precision, and the plain versions must run on the CPU too.) TF32 is off
    (``nn.no_tf32``), as in the JAX reference. A tensor-parallel model's
    operands (replicated by the sharding rules) go in whole: DTensor's
    convolution rule takes only a sequence sharded with a halo exchange."""
    x, w = whole(x), whole(w)
    b = None if b is None else whole(b)
    with tnn.no_tf32():
        if x.dtype != torch.bfloat16:
            return F.conv1d(x, w, b, **kwargs)
        y = F.conv1d(x.float(), w.float(), **kwargs).to(torch.bfloat16)
    return y if b is None else y + b[:, None]


def pos_conv_embed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """The positional embedding of (B, T, d) features: the grouped conv over
    time (padding k // 2; SamePad drops the trailing step of an even
    kernel), then erf-GELU."""
    k = w.shape[-1]
    h = conv1d(x.transpose(1, 2), w, b, padding=k // 2, groups=groups)
    if k % 2 == 0:
        h = h[..., :-1]
    return tnn.gelu_erf(h.transpose(1, 2))


# --------------------------------------------------------------------- packs

PackDict = Dict[str, object]


@torch.no_grad()
def pack_frontend(encoder) -> PackDict:
    """The bf16 pack of a ``Wav2VecEncoder``'s conv front ("layer" layout),
    from its parameters rounded to bf16: ``w<i>`` (out, k * in) and ``b<i>``,
    ``s<i>``, ``n<i>`` (the conv bias, the LayerNorm's scale and bias) per
    feature conv, ``wp`` (d, k * d / groups) and ``bp``, with ``stride``,
    ``eps`` and ``groups``."""
    cfg = encoder.cfg
    pack: PackDict = {"stride": tuple(cfg.conv_stride), "eps": float(cfg.layer_norm_eps),
                      "groups": int(cfg.num_conv_pos_embedding_groups)}

    def bf16(t):
        return whole(t).to(torch.bfloat16).contiguous()

    for i, layer in enumerate(encoder.feature_extractor):
        pack[f"w{i}"] = pack_weight(bf16(layer.conv.w))
        pack[f"b{i}"] = bf16(layer.conv.b)
        pack[f"s{i}"], pack[f"n{i}"] = bf16(layer.norm.scale), bf16(layer.norm.bias)
    p = encoder.encoder.pos_conv
    pack["wp"], pack["bp"] = pack_weight(bf16(p.w)), bf16(p.b)
    return pack


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(out, in, k) -> (out, k * in): ``packed[o][j * in + c] = w[o][c][j]``."""
    return w.permute(0, 2, 1).reshape(w.shape[0], -1).contiguous()


def unpack_weight(packed: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of ``pack_weight`` for a kernel of ``k`` taps."""
    return packed.reshape(packed.shape[0], k, -1).permute(0, 2, 1)


def num_convs(pack: PackDict) -> int:
    return len(pack["stride"])


def kernel_taps(pack: PackDict, i: int) -> int:
    """Taps of feature conv ``i`` (``"p"``: the positional conv)."""
    if i == "p":
        return pack["wp"].shape[1] * pack["groups"] // pack["wp"].shape[0]
    w = pack[f"w{i}"]
    return w.shape[1] // (1 if i == 0 else pack[f"w{i - 1}"].shape[0])


def layout_takes(cfg) -> bool:
    """Is this ``Wav2VecConfig``'s conv front the one ``conv_frontend``
    computes: the "layer" layout (XLS-R) with conv biases?"""
    return cfg.feat_extract_norm == "layer" and cfg.conv_bias


def supports(cfg) -> bool:
    """Do the kernels take this ``Wav2VecConfig``'s conv front: its layout
    (``layout_takes``), 512 channels in every feature conv, conv0 of at most
    ``MAX_K0`` taps, 64 channels in each positional group?"""
    return (layout_takes(cfg) and set(cfg.conv_dim) == {CHANNELS}
            and cfg.conv_kernel[0] <= MAX_K0
            and cfg.hidden_size == GROUP * cfg.num_conv_pos_embedding_groups)


def launches_per_call(pack: PackDict) -> int:
    """Launches of one ``conv_frontend`` call on the card: one per conv."""
    return num_convs(pack) + 1


# --------------------------------------------------------------- the routes


def conv_layer_plain(x: torch.Tensor, pack: PackDict, i: int) -> torch.Tensor:
    """Plain-torch version of ``conv_layer``: feature conv ``i`` of (B, S)
    audio (i = 0) or (B, T, C) features, its LayerNorm and GELU."""
    x = x[:, None, :] if i == 0 else x.transpose(1, 2)
    w = unpack_weight(pack[f"w{i}"], kernel_taps(pack, i))
    x = conv1d(x, w, pack[f"b{i}"], stride=pack["stride"][i]).transpose(1, 2)
    return tnn.gelu_erf(tnn.layer_norm(x, pack["eps"], pack[f"s{i}"], pack[f"n{i}"]))


def pos_conv_residual_plain(x: torch.Tensor, pack: PackDict) -> torch.Tensor:
    """Plain-torch version of ``pos_conv_residual``."""
    wp = unpack_weight(pack["wp"], kernel_taps(pack, "p"))
    return x + pos_conv_embed(x, wp, pack["bp"], pack["groups"])


def conv_frontend_plain(audio: torch.Tensor, pack: PackDict,
                        project: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Plain-torch version of ``conv_frontend``: the eager path's arithmetic
    on the pack's weights."""
    x = audio
    for i in range(num_convs(pack)):
        x = conv_layer_plain(x, pack, i)
    return pos_conv_residual_plain(project(x), pack)


class _Conv0Params(ctypes.Structure):
    """Mirror of ``Conv0Params`` in csrc/conv_frontend.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "w", "bias", "lns", "lnb", "y")] + [
        (n, ctypes.c_int) for n in ("B", "S", "T", "rows", "k", "stride")] + [
        ("eps", ctypes.c_float)]


class _ConvParams(ctypes.Structure):
    """Mirror of ``ConvParams`` in csrc/conv_frontend.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "w", "bias", "lns", "lnb", "y")] + [
        (n, ctypes.c_int) for n in ("B", "in_rows", "T", "rows", "k", "stride")] + [
        ("eps", ctypes.c_float)]


class _PosParams(ctypes.Structure):
    """Mirror of ``PosParams`` in csrc/conv_frontend.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "w", "bias", "y")] + [
        (n, ctypes.c_int) for n in ("B", "T", "d", "k")]


# conv_frontend() counts each launch under "conv_frontend"
LIB = Library(CSRC / "conv_frontend.cu", {
    "artalk_conv0": (ctypes.c_int, [ctypes.POINTER(_Conv0Params), ctypes.c_void_p]),
    "artalk_conv_layer": (ctypes.c_int, [ctypes.POINTER(_ConvParams), ctypes.c_void_p]),
    "artalk_pos_conv": (ctypes.c_int, [ctypes.POINTER(_PosParams), ctypes.c_void_p])},
    headers=(CSRC / "wgmma_gemm.cuh", CSRC / "block_stack_common.cuh", CSRC / "mma_ptx.cuh"),
    kernel="conv_frontend")


def _rows(t: int, stride: int) -> int:
    """Rows of an activation that the next conv (of ``stride``) reads as
    (rows / stride, stride) steps: ``t`` rounded up to the stride."""
    return -(-t // stride) * stride


def check_pack(pack: PackDict, device: torch.device) -> None:
    for key, t in pack.items():
        if isinstance(t, torch.Tensor) and (t.device != device or t.dtype != torch.bfloat16
                                            or not t.is_contiguous()):
            raise ValueError(f"conv_frontend: pack {key} is {t.dtype} on {t.device}, want "
                             f"contiguous bfloat16 on {device}")


def conv_layer(x: torch.Tensor, pack: PackDict, i: int) -> torch.Tensor:
    """Feature conv ``i`` on the card, one launch: (B, S) bf16 audio (i = 0)
    or (B, T, 512) bf16 features -> (B, T_out, 512) bf16, with its
    LayerNorm and GELU. The output may be a view of the first T_out rows of
    a buffer with rows up to the next conv's stride, which the next call
    reads through (``_rows``)."""
    lib = LIB.get()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    strides = pack["stride"]
    k, stride = kernel_taps(pack, i), strides[i]
    b, t_in = x.shape[:2]
    t = (t_in - k) // stride + 1
    nxt = strides[i + 1] if i + 1 < len(strides) else 1
    y = torch.empty((b, _rows(t, nxt), CHANNELS), dtype=torch.bfloat16, device=x.device)
    weights = dict(w=ptr(pack[f"w{i}"]), bias=ptr(pack[f"b{i}"]), lns=ptr(pack[f"s{i}"]),
                   lnb=ptr(pack[f"n{i}"]), y=ptr(y), B=b, T=t, rows=y.shape[1], k=k,
                   stride=stride, eps=pack["eps"])
    if i == 0:
        x = x.contiguous()
        params = _Conv0Params(x=ptr(x), S=t_in, **weights)
        check_launch("conv_frontend conv0", lib.artalk_conv0(ctypes.byref(params), stream))
    else:
        # the input's buffer, rows rounded up to this conv's stride
        base = x if x.is_contiguous() and t_in % stride == 0 else _strided_rows(x, stride)
        params = _ConvParams(x=ptr(base), in_rows=base.shape[1], **weights)
        check_launch(f"conv_frontend conv{i}",
                     lib.artalk_conv_layer(ctypes.byref(params), stream))
    LIB.count()
    return y[:, :t]


def _strided_rows(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The rows of (B, T, C) ``x`` in a buffer of ``_rows(T, stride)`` rows:
    its own buffer where ``x`` is a view of one (``conv_layer``'s outputs),
    else a padded copy."""
    b, t, c = x.shape
    rows = _rows(t, stride)
    if x.stride() == (rows * c, c, 1) and x.storage_offset() == 0 and \
            x.untyped_storage().nbytes() >= b * rows * c * x.element_size():
        return torch.as_strided(x, (b, rows, c), (rows * c, c, 1))
    out = x.new_zeros((b, rows, c))
    out[:, :t] = x
    return out


def pos_conv_residual(x: torch.Tensor, pack: PackDict) -> torch.Tensor:
    """x + the positional embedding of (B, T, d) bf16 features on the card,
    one launch."""
    x = x.contiguous()
    b, t, d = x.shape
    y = torch.empty_like(x)
    params = _PosParams(x=ptr(x), w=ptr(pack["wp"]), bias=ptr(pack["bp"]), y=ptr(y),
                        B=b, T=t, d=d, k=kernel_taps(pack, "p"))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check_launch("conv_frontend pos_conv",
                 LIB.get().artalk_pos_conv(ctypes.byref(params), stream))
    LIB.count()
    return y


def conv_frontend(audio: torch.Tensor, pack: PackDict,
                  project: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """(B, S) z-normed bf16 audio -> (B, T, d) bf16: the feature convs (each
    with its LayerNorm and GELU), ``project`` ((B, T, 512) -> (B, T, d)),
    then + the positional embedding. A CPU tensor goes through
    ``conv_frontend_plain``; a DTensor goes in whole."""
    audio = whole(audio)
    if audio.device.type == "cpu":
        return conv_frontend_plain(audio, pack, project)
    if audio.device.type != "cuda":
        raise ValueError(f"conv_frontend: unsupported device {audio.device}")
    if audio.dtype != torch.bfloat16 or audio.ndim != 2:
        raise ValueError(f"conv_frontend: want (B, S) bfloat16 audio, got {audio.dtype} "
                         f"{tuple(audio.shape)}")
    check_pack(pack, audio.device)
    if any(pack[f"w{i}"].shape[0] != CHANNELS for i in range(num_convs(pack))) or \
            kernel_taps(pack, 0) > MAX_K0:
        raise ValueError(f"conv_frontend: the kernels take {CHANNELS} channels in every feature "
                         f"conv and conv0 of at most {MAX_K0} taps")
    if pack["wp"].shape[0] != GROUP * pack["groups"]:
        raise ValueError(f"conv_frontend: the kernels take {GROUP} channels a positional group")
    x = audio
    for i in range(num_convs(pack)):
        x = conv_layer(x, pack, i)
    return pos_conv_residual(whole(project(x)).to(torch.bfloat16), pack)
