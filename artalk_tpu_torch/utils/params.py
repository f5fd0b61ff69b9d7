"""Parameter bridge: JAX parameter pytrees -> the port's modules.

The JAX package saves its parameter pytree as a flat-key ``.npz`` whose keys
join the pytree path with ``//`` (``artalk_tpu/utils/checkpoint.py``:
``save_params``), e.g. ``blocks//q//w`` or
``audio_encoder//feature_extractor//0//conv//w``. The port's modules mirror
that tree name for name and shape for shape (linear weights ``(in, out)``,
layer stacks along a leading depth axis), so a flat key maps to a state-dict
key by replacing ``//`` with ``.`` and nothing else changes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..models.ar_model import BitwiseARModel

SEP = "//"


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a flat ``//``-keyed .npz as written by the JAX ``save_params``."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def params_from_flat(flat: Dict[str, np.ndarray], cfg: ModelConfig) -> BitwiseARModel:
    """Build a ``BitwiseARModel`` for ``cfg`` (on the CPU) holding the given
    JAX parameters. Raises KeyError for a parameter the dict lacks and
    ValueError for one whose shape differs; keys the model has no use for are
    ignored, as the JAX loader ignores them."""
    return load_flat_into(BitwiseARModel(cfg), flat)


def load_flat_into(model: torch.nn.Module, flat: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Load flat ``//``-keyed JAX parameters into any of the port's modules
    (e.g. a ``BitwiseVAE`` with the JAX ``BitwiseVAE.init`` tree), checking
    every key and shape as ``params_from_flat`` does. Returns ``model``."""
    state = {}
    for key, ref in model.state_dict().items():
        flat_key = key.replace(".", SEP)
        if flat_key not in flat:
            raise KeyError(f"parameters lack {flat_key!r}")
        arr = np.asarray(flat[flat_key])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {flat_key!r}: got {arr.shape}, "
                             f"model wants {tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    model.load_state_dict(state, strict=True)
    return model
