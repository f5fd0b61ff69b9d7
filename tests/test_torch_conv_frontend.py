"""The wav2vec2 conv front's plain version, weight pack and routing
(``ops/conv_frontend.py``) on the CPU; the kernels themselves are held to the
plain version on the card (``tests/test_torch_cuda.py``).

The plain version is the eager path's arithmetic moved, so it must equal
``extract_features`` + the projection + ``_pos_conv_embed`` bit for bit; the
routing sends bfloat16 "layer" audio without gradients to the op, and
everything else (float32, the "group" layout, inputs that need a gradient)
to the eager path, whose results must not move."""

import dataclasses

import pytest
import torch

from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch.models.ar_model import BitwiseARModel
from artalk_tpu_torch.models.wav2vec import Wav2VecEncoder, normalize_audio
from artalk_tpu_torch.ops import conv_frontend as cf
from artalk_tpu_torch.utils.metrics import GLOBAL_METRICS

# small widths with the production layout's shape: three feature convs of
# strides 5, 2, 2 (kernels 10, 3, 2), a grouped positional conv of even kernel
SMALL = tcfg.Wav2VecConfig(conv_dim=(24, 24, 24), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2),
                           hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=64, num_conv_pos_embeddings=8,
                           num_conv_pos_embedding_groups=4)
ODD_POS = dataclasses.replace(SMALL, num_conv_pos_embeddings=7)
SAMPLES = 1200


def _encoder(cfg=SMALL, seed=0, dtype=torch.bfloat16) -> Wav2VecEncoder:
    enc = Wav2VecEncoder(cfg).init(torch.Generator().manual_seed(seed))
    with torch.no_grad():   # LayerNorms and biases away from their defaults
        for name, p in enc.named_parameters():
            if name.endswith(("norm.scale", "norm.bias", "conv.b")):
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(seed + 1))
                       * 0.3)
    return enc.to(dtype).requires_grad_(False)


def _audio(b: int, seed: int = 3, dtype=torch.bfloat16) -> torch.Tensor:
    return (torch.randn((b, SAMPLES), generator=torch.Generator().manual_seed(seed))
            * 0.2).to(dtype)


def _eager(enc: Wav2VecEncoder, audio: torch.Tensor) -> torch.Tensor:
    """The eager path: the conv stack, the projection, + the positional conv."""
    return enc._embed(enc.extract_features(normalize_audio(audio)))


def test_weight_pack_round_trips_exactly():
    enc = _encoder()
    pack = enc.pack_frontend()
    for i, layer in enumerate(enc.feature_extractor):
        w = layer.conv.w
        got = pack[f"w{i}"]
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert got.shape == (w.shape[0], w.shape[2] * w.shape[1])
        assert cf.kernel_taps(pack, i) == w.shape[2]
        assert torch.equal(cf.unpack_weight(got, w.shape[2]), w)
        # one contraction step is one tap's channels: packed[o][j * in + c] = w[o][c][j]
        o, c, j = w.shape[0] - 1, w.shape[1] - 1, w.shape[2] - 1
        assert torch.equal(got[o, j * w.shape[1] + c], w[o, c, j])
        for key, t in (("b", layer.conv.b), ("s", layer.norm.scale), ("n", layer.norm.bias)):
            assert torch.equal(pack[f"{key}{i}"], t)
    p = enc.encoder.pos_conv
    assert cf.kernel_taps(pack, "p") == SMALL.num_conv_pos_embeddings
    assert torch.equal(cf.unpack_weight(pack["wp"], p.w.shape[2]), p.w)
    assert torch.equal(pack["bp"], p.b)
    assert pack["stride"] == tuple(SMALL.conv_stride) and pack["groups"] == 4
    assert cf.launches_per_call(pack) == len(SMALL.conv_dim) + 1


@pytest.mark.parametrize("cfg", [SMALL, ODD_POS], ids=["even_pos", "odd_pos"])
@pytest.mark.parametrize("b", [1, 3])
def test_plain_equals_the_eager_path_bit_for_bit(cfg, b):
    enc = _encoder(cfg)
    audio = _audio(b)
    want = _eager(enc, audio)
    got = cf.conv_frontend_plain(normalize_audio(audio), enc.pack_frontend(), enc._project)
    assert got.dtype == torch.bfloat16 and got.shape == (b, cfg.num_output_frames(SAMPLES),
                                                          cfg.hidden_size)
    assert torch.equal(got, want)
    # a row's result does not depend on the batch
    alone = cf.conv_frontend_plain(normalize_audio(audio[-1:]), enc.pack_frontend(),
                                   enc._project)
    assert torch.equal(got[-1:], alone)


def test_routing_by_dtype_layout_and_gradient(monkeypatch):
    calls = []
    real = cf.conv_frontend
    monkeypatch.setattr(cf, "conv_frontend", lambda *a: calls.append(1) or real(*a))
    enc = _encoder()
    audio = _audio(2)
    assert enc.frontend_takes(audio)
    # bf16 "layer" audio without gradients goes to the op, and the encoder's
    # output is the eager path's, bit for bit
    got = enc(audio)
    assert calls == [1]
    with monkeypatch.context() as m:
        m.setattr(enc, "frontend_takes", lambda a: False)
        want = enc(audio)
    assert torch.equal(got, want) and calls == [1]

    # float32 audio and parameters keep the eager path
    enc32 = _encoder(dtype=torch.float32)
    a32 = _audio(2, dtype=torch.float32)
    assert not enc32.frontend_takes(a32) and not enc.frontend_takes(a32)
    enc32(a32)
    # the "group" layout (base / HuBERT) and layouts without conv biases
    group = _encoder(dataclasses.replace(SMALL, feat_extract_norm="group",
                                         do_stable_layer_norm=False))
    assert not group.frontend_takes(audio)
    group(audio)
    assert not _encoder(dataclasses.replace(SMALL, conv_bias=False)).frontend_takes(audio)
    # an input that needs a gradient: the audio, or a parameter of the front
    assert not enc.frontend_takes(audio.clone().requires_grad_(True))
    for p in (enc.feature_extractor[1].conv.w, enc.feature_projection.norm.scale,
              enc.encoder.pos_conv.b):
        p.requires_grad_(True)
        assert not enc.frontend_takes(audio)
        with torch.no_grad():
            assert enc.frontend_takes(audio)
        p.requires_grad_(False)
    assert calls == [1]
    # on the card only the kernels' widths go to the op
    assert not cf.supports(SMALL) and cf.supports(tcfg.Wav2VecConfig())
    assert not cf.supports(tcfg.hubert_base_config())


def test_float32_forward_unchanged():
    """The exact mode's encoder runs the eager path: its output equals the
    conv stack + ``encode`` composed by hand, bit for bit."""
    enc = _encoder(dtype=torch.float32)
    audio = _audio(2, dtype=torch.float32)
    want = enc.encode(enc.extract_features(normalize_audio(audio)))
    assert torch.equal(enc(audio), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_frontend_span_in_both_routes(dtype):
    enc = _encoder(dtype=dtype)
    GLOBAL_METRICS.reset()
    enc(_audio(1, dtype=dtype))
    (span,) = GLOBAL_METRICS.spans("wav2vec.frontend")
    assert "device_us" not in span.attrs   # CUDA events only on a card


def test_model_packs_the_frontend_once():
    """In a bf16 mode the AR model packs its conv front once (with the block
    stacks' packs, or at first use) and hands that pack to every window; an
    exact model holds none."""
    cfg = tcfg.ModelConfig(ar=tcfg.ARConfig(depth=1, num_heads=2, embed_dim=32, style_dim=16,
                                            audio_dim=32, prev_ratio=1),
                           vae=tcfg.VAEConfig(motion_dim=8, code_dim=4, depth=1, num_heads=2,
                                              hidden_dim=16, patch_nums=(1, 5)),
                           wav2vec=SMALL)
    model = BitwiseARModel(cfg).init(torch.Generator().manual_seed(0))
    assert model.frontend_pack() is None
    fast = dataclasses.replace(cfg, bf16_audio=True, bf16_ar=True)
    model.set_precision(fast)
    pack = model.frontend_pack()
    assert pack is not None and pack["w0"].dtype == torch.bfloat16
    assert torch.equal(pack["w1"], cf.pack_weight(
        model.audio_encoder.feature_extractor[1].conv.w.to(torch.bfloat16)))
    seen = []
    real = cf.conv_frontend
    try:
        cf.conv_frontend = lambda audio, p, project: seen.append(p) or real(audio, p, project)
        chunk = torch.randn((2, model.window_samples), generator=torch.Generator().manual_seed(1))
        for _ in range(2):
            model.audio_condition(chunk)
    finally:
        cf.conv_frontend = real
    assert len(seen) == 2 and all(p is pack for p in seen)
    model.set_precision(cfg)
    assert model.frontend_pack() is None
