"""Parameter bridge: JAX parameter pytrees -> the port's modules.

The JAX package saves its parameter pytree as a flat-key ``.npz`` whose keys
join the pytree path with ``//`` (``artalk_tpu/utils/checkpoint.py``:
``save_params``), e.g. ``blocks//q//w`` or
``audio_encoder//feature_extractor//0//conv//w``. The port's modules mirror
that tree name for name and shape for shape (linear weights ``(in, out)``,
layer stacks along a leading depth axis), so a flat key maps to a state-dict
key by replacing ``//`` with ``.`` and nothing else changes.

The archive itself is written and read by ``utils/checkpoint.py`` (the
counterpart of the JAX module); its ``flatten_params``, ``save_params_npz``,
``flat_from_module``, ``load_params_npz`` and ``load_flat_into`` are
re-exported here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..models.ar_model import BitwiseARModel
from .checkpoint import (SEP, flat_from_module, flatten_params, load_flat_into, load_params_npz,
                         save_params_npz)

__all__ = ["SEP", "flatten_params", "save_params_npz", "flat_from_module", "load_params_npz",
           "params_from_flat", "gagavatar_from_flat", "load_flat_into"]


def params_from_flat(flat: Dict[str, np.ndarray], cfg: ModelConfig) -> BitwiseARModel:
    """Build a ``BitwiseARModel`` for ``cfg`` (on the CPU) holding the given
    JAX parameters. Raises KeyError for a parameter the dict lacks and
    ValueError for one whose shape differs; keys the model has no use for are
    ignored, as the JAX loader ignores them."""
    return load_flat_into(BitwiseARModel(cfg), flat)


def gagavatar_from_flat(flat: Dict[str, np.ndarray]) -> torch.nn.Module:
    """The port's GAGAvatar networks (``GAGAvatarNets``, on the CPU) holding
    the parameters of a JAX ``GAGAvatar.init`` tree, checked as
    ``params_from_flat`` checks them."""
    # imported here: models/gagavatar/avatar.py imports this module
    from ..models.gagavatar.avatar import GAGAvatarNets

    return load_flat_into(GAGAvatarNets(), flat)
