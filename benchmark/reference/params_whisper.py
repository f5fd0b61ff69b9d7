"""The parameters of the motion model on the Whisper encoder: their names and
shapes, as the port loads ARTalk's checkpoint with ``AUDIO_ENCODER:
"whisper"`` (``utils/params.params_from_flat``), and the rule of each seeded
value.

The motion model's entries are ``params.motion_spec``'s without its
``audio_encoder//`` keys (the wav2vec2 group it reads is a placeholder whose
entries are dropped); the AR AdaLN's input is the configuration's
``audio_dim``, 1280. The Whisper tree follows HF's ``WhisperEncoder``: two
convolutions ``(out, in, 3)`` with biases, the layers' linears ``(in, out)``
stacked by layer (q, v, out, fc1 and fc2 with a bias, k without), two
LayerNorms a layer and a final one. Weights and biases are uniform within
the fan-in bound (torch's ``nn.Linear`` / ``nn.Conv1d`` defaults), LayerNorm
scales 1 and biases 0. The mel filters and the 1500 x 1280 sinusoidal
positions are computed from their formulas and are not parameters.
"""

from __future__ import annotations

import math

from .params import Spec, _linear, _norm, motion_spec
from .params_mimi import NO_WAV2VEC

A = "audio_encoder"


def whisper_spec(cfg: dict) -> Spec:
    """The Whisper encoder's parameters, ``audio_encoder//``-keyed, for the
    ``whisper`` group ``cfg`` of a configuration file."""
    spec: Spec = []
    d, n = cfg["d_model"], (cfg["encoder_layers"],)
    for name, cin in (("conv1", cfg["num_mel_bins"]), ("conv2", d)):
        bound = 1.0 / math.sqrt(cin * 3)
        spec += [(f"{A}//{name}//w", (d, cin, 3), ("uniform", bound)),
                 (f"{A}//{name}//b", (d,), ("uniform", bound))]
    L = f"{A}//layers"
    for name, fi, fo, bias in (("q", d, d, True), ("k", d, d, False), ("v", d, d, True),
                               ("out", d, d, True), ("fc1", d, cfg["encoder_ffn_dim"], True),
                               ("fc2", cfg["encoder_ffn_dim"], d, True)):
        _linear(spec, f"{L}//{name}", fi, fo, n, bias=bias)
    _norm(spec, f"{L}//norm1", d, n)
    _norm(spec, f"{L}//norm2", d, n)
    _norm(spec, f"{A}//final_norm", d)
    return spec


def whisper_motion_spec(model: dict) -> Spec:
    """Every parameter of the Whisper-conditioned motion model of ``model``
    (the ``model`` group of a configuration file)."""
    base = [e for e in motion_spec(dict(model, wav2vec=NO_WAV2VEC))
            if not e[0].startswith(f"{A}//")]
    return base + whisper_spec(model["whisper"])
