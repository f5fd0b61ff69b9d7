"""TF32 probe, run on a machine with an NVIDIA GPU in a fresh process:

    python3 -c "$(cat tests/tf32_probe.py)"

It imports only ``artalk_tpu_torch.models.hubert`` (nothing that turns TF32
off as a side effect, such as the engine), runs HuBERT base on seeded weights
and 4 s of seeded audio, and wav2vec2's conv frontend on its own, with
torch's default flags (cuDNN may convolve float32 in TF32), then the same
calls after ``full_float32()``. It prints one JSON line: whether TF32 was on
after the import, whether the engine was imported, the flags after the first
calls (the caller's, restored), the max abs difference of each output
between the two runs (the port's convolutions run with TF32 off, so only
rounding-level differences of another cuDNN algorithm remain), and, so that
the probe's sensitivity shows, the difference TF32 makes to one of the
frontend's convolutions called directly with the flag on and off.
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` run it and hold the
differences to 1e-5.
"""

import json
import sys

import torch

from artalk_tpu_torch.models import hubert

dev = torch.device("cuda")
tf32_after_import = [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]
enc = hubert.HubertEncoder().init(torch.Generator().manual_seed(0)).requires_grad_(False).to(dev)
audio = (torch.randn((1, 64000), generator=torch.Generator().manual_seed(1)) * 0.1).to(dev)


def run():
    with torch.no_grad():
        out = enc(audio)
        feats = enc.extract_features(hubert.normalize_audio(audio))
    torch.cuda.synchronize()
    return out, feats


default_out, default_feats = run()
flags_after_calls = [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]
x = torch.randn((1, 512, 3199), generator=torch.Generator().manual_seed(2)).to(dev)
w = enc.feature_extractor[1].conv.w
with torch.no_grad():
    conv_tf32 = torch.nn.functional.conv1d(x, w, stride=2)
    torch.backends.cudnn.allow_tf32 = False
    conv_f32 = torch.nn.functional.conv1d(x, w, stride=2)

from artalk_tpu_torch.models.nn import full_float32  # noqa: E402 (after the default run)

full_float32()
exact_out, exact_feats = run()
print(json.dumps({
    "tf32_after_import": tf32_after_import,
    "engine_imported": "artalk_tpu_torch.engine" in sys.modules,
    "flags_after_calls": flags_after_calls,
    "hubert_diff": (default_out - exact_out).abs().max().item(),
    "frontend_diff": (default_feats - exact_feats).abs().max().item(),
    "tf32_effect": (conv_tf32 - conv_f32).abs().max().item(),
    "finite": bool(torch.isfinite(default_out).all()),
    "shape": list(default_out.shape),
}))
