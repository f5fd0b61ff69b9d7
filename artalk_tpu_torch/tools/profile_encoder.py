"""Per-stage device timing of the wav2vec2 audio encoder.

Counterpart of the repository's ``tools/profile_encoder.py``. Splits the
batched-windows encode (the largest stage of the offline clip path) into
the conv feature extractor, the positional conv embed and ``encode`` (the
feature projection and the 24-layer stack), beside the full call, at
float32 (exact mode) and bf16 (fast mode: the encoder's float parameters
and the audio cast to bf16), then with ``--fused`` the full call with the
bf16 and the int8 weight pack (the encoder block-stack kernel of
``ops/encoder_block_stack.py``, one launch per call at any batch):

    python -m artalk_tpu_torch.tools.profile_encoder [--iters 10] [--windows 8]
                                                     [--fused] [--only_fused]

Left out: the JAX tool's ``--convdetail`` rows (the conv frontend prefix by
prefix, "no norms", "transpose-free chan-LN"). They time rewrites of the
frontend that were never the system's code. The weights are random from
seed 0.
"""

from __future__ import annotations

import argparse
import copy
from typing import Optional, Union

import numpy as np
import torch

from ..config import ModelConfig
from ..engine import resolve_device
from ..models.wav2vec import Wav2VecEncoder, normalize_audio
from ..utils.timing import timed
from . import device_line


@torch.no_grad()
def main(argv: Optional[list] = None, device: Union[str, torch.device] = "cuda",
         config: Optional[ModelConfig] = None) -> None:
    """Profile the encoder of ``config`` (default the production
    ``ModelConfig()``) on ``device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--only_fused", action="store_true",
                    help="skip the standard sections")
    ap.add_argument("--fused", action="store_true",
                    help="also time the full call with the bf16 and int8 weight packs "
                         "(the encoder block-stack kernel)")
    args = ap.parse_args(argv)
    it = args.iters
    b = args.windows
    dev = resolve_device(device)
    print(f"{device_line(dev)}   iters: {it}   windows: {b}\n", flush=True)

    cfg = config or ModelConfig()
    enc = Wav2VecEncoder(cfg.wav2vec).init(torch.Generator().manual_seed(0)).to(dev)
    enc.requires_grad_(False)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.standard_normal(
        (b, cfg.window_audio_samples)).astype(np.float32) * 0.1).to(dev)

    def stage(name, fn, *args):
        return timed(name, fn, *args, iters=it, device=dev)

    for mode in ("f32", "bf16"):
        if mode == "bf16":
            e, aud = copy.deepcopy(enc).to(torch.bfloat16), audio.to(torch.bfloat16)
        else:
            e, aud = enc, audio
        print(f"--- {mode} (batched {b} windows) ---")
        if not args.only_fused:
            stage("full __call__", lambda a: e(a).sum(), aud)
            stage("conv feature extractor",
                  lambda a: e.extract_features(normalize_audio(a)).sum(), aud)
            feats = e.extract_features(normalize_audio(aud))
            stage("pos conv embed", lambda x: e._pos_conv_embed(x).sum(),
                  torch.zeros((b, feats.shape[1], cfg.wav2vec.hidden_size),
                              dtype=feats.dtype, device=dev))
            stage("encode (proj + 24-layer stack)", lambda f: e.encode(f).sum(), feats)

        if args.fused and mode == "bf16":
            for pack_dtype, name in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
                pack = enc.pack_fused(pack_dtype)
                stage(f"full __call__ fused {name} pack",
                      lambda a: e(a, fused_pack=pack).sum(), aud)
        print()


if __name__ == "__main__":
    main()
