"""Export the streaming window step as a serialized ``torch.export`` program.

Counterpart of ``tools/export_model.py``: ``torch.export`` traces
``BitwiseARModel.window_step`` (4 s audio chunk -> 100 motion frames + the
new carry) once at a fixed batch, and the saved program runs in a serving
process that ships no model source, only ``torch.export.load`` and the
program's file. The program carries the weights it was traced with;
``load_window_step(path, params)`` runs it with any other checkpoint of the
same shapes instead (a flat ``//`` dict or an .npz, such as the
``params.npz`` written beside it), as the JAX artifact takes its parameters
at call time. The ``WindowState`` carry is an input and an output, as its
two tensors (``prev_bits``, ``prev_attn_feat``): ``load_window_step`` wraps
them back into a ``WindowState``.

    python -m artalk_tpu_torch.export_model --out exported/ [--batch 8] \\
        [--checkpoint assets/artalk_params.npz] [--device cuda]

Produces ``<out>/window_step_b<B>.pt2`` + ``<out>/params.npz``. The exact
(default) step is exported, as the JAX tool exports it: the fused and int8
configurations and the flash-attention encoders (wav2vec2 with its switch,
Whisper) launch their CUDA kernels through ctypes, which ``torch.export``
cannot trace, and raise.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from .config import ModelConfig
from .engine import resolve_device
from .models import nn as tnn
from .models.ar_model import BitwiseARModel, WindowState
from .utils.params import (flat_from_module, load_flat_into, load_model, load_params_npz,
                           save_params_npz)


class _WindowStep(nn.Module):
    """``window_step`` with the carry as two tensors in and out."""

    def __init__(self, model: BitwiseARModel):
        super().__init__()
        self.model = model

    def forward(self, prev_bits: torch.Tensor, prev_attn_feat: torch.Tensor,
                audio_chunk: torch.Tensor, style_cond: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        state, motion = self.model.window_step(WindowState(prev_bits, prev_attn_feat),
                                               audio_chunk, style_cond)
        return state.prev_bits, state.prev_attn_feat, motion


def export_window_step(model: BitwiseARModel, batch: int = 1,
                       device: Union[str, torch.device, None] = None
                       ) -> torch.export.ExportedProgram:
    """Trace the exact window step for ``batch`` concurrent streams on
    ``device`` (default: the model's). Raises ValueError for a configuration
    whose step launches a kernel through ctypes."""
    cfg = model.cfg
    kernels = [name for name, on in (
        ("fused_ar", cfg.fused_ar), ("int8_ar", cfg.int8_ar),
        ("wav2vec.use_flash_attention",
         cfg.ar.audio_encoder == "wav2vec" and cfg.wav2vec.use_flash_attention),
        ("the whisper encoder's flash attention", cfg.ar.audio_encoder == "whisper")) if on]
    if kernels:
        raise ValueError(f"export_window_step: {', '.join(kernels)} launch CUDA kernels through "
                         "ctypes, which torch.export cannot trace; export the exact step")
    device = torch.device(device) if device is not None else model.pos_embed.device
    style = torch.zeros((batch, 1, cfg.ar.embed_dim), device=device)
    chunk = torch.zeros((batch, model.window_samples), device=device)
    with torch.no_grad(), tnn.no_tf32():
        state = model.initial_state(style, batch_size=batch)
        # one eager step first: the resize matrices are cached on first use,
        # and one first made while tracing would be a fake tensor
        model.window_step(state, chunk, style)
        return torch.export.export(_WindowStep(model).eval(),
                                   (state.prev_bits, state.prev_attn_feat, chunk, style),
                                   strict=False)


def load_window_step(path: str, params: Union[str, Dict[str, np.ndarray], None] = None
                     ) -> Callable:
    """Load a saved program; returns ``step(state, chunk, style) ->
    (WindowState, motion)`` (run it with TF32 off, as the engine runs).

    ``params`` (a flat ``//``-keyed dict, or the path of an .npz of one)
    replaces the weights the program was traced with: every parameter of the
    model is loaded, strictly; a missing key raises KeyError and a shape
    mismatch ValueError, as in ``params_from_flat``."""
    module = torch.export.load(path).module()
    if params is not None:
        flat = load_params_npz(params) if isinstance(params, str) else params
        load_flat_into(module.model, flat)  # _WindowStep's model.-prefixed keys

    def step(state: WindowState, audio_chunk: torch.Tensor, style_cond: torch.Tensor):
        prev_bits, prev_attn_feat, motion = module(state.prev_bits, state.prev_attn_feat,
                                                   audio_chunk, style_cond)
        return WindowState(prev_bits, prev_attn_feat), motion

    return step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="exported")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--checkpoint", default="assets/artalk_params.npz",
                    help="converted params npz (python -m artalk_tpu_torch.convert_checkpoint)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if not os.path.exists(args.checkpoint):
        print("WARNING: exporting RANDOM-INIT weights (smoke-test artifact only, do not deploy)")
    model = load_model(ModelConfig(), checkpoint=args.checkpoint,
                       device=resolve_device(args.device))
    program = export_window_step(model, batch=args.batch)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"window_step_b{args.batch}.pt2")
    torch.export.save(program, path)
    save_params_npz(flat_from_module(model), os.path.join(args.out, "params.npz"))
    print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB) + params.npz")
    return path


if __name__ == "__main__":
    main()
