"""Parameter bridge: JAX parameter pytrees -> the port's modules.

The JAX package saves its parameter pytree as a flat-key ``.npz`` whose keys
join the pytree path with ``//`` (``artalk_tpu/utils/checkpoint.py``:
``save_params``), e.g. ``blocks//q//w`` or
``audio_encoder//feature_extractor//0//conv//w``. The port's modules mirror
that tree name for name and shape for shape (linear weights ``(in, out)``,
layer stacks along a leading depth axis), so a flat key maps to a state-dict
key by replacing ``//`` with ``.`` and nothing else changes.

``flatten_params`` / ``save_params_npz`` write such an archive from a nested
tree of dicts and lists (``utils/convert.py``'s output) with the keys of the
JAX ``save_params``, without jax; ``flat_from_module`` gives a module's
parameters in that form (the trainer's and the exporter's archives).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..models.ar_model import BitwiseARModel
from ..parallel.sharding import whole

SEP = "//"


def flatten_params(tree: Any) -> Dict[str, np.ndarray]:
    """Flat ``//``-keyed arrays of a nested tree, as the JAX ``_flatten``
    keys a pytree: dict keys by name (in sorted order), list and tuple items
    by index, ``None`` leaves dropped, each leaf ``np.asarray`` of itself
    (dtype kept)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Any, path: tuple) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (str(key),))
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, path + (str(i),))
        else:
            flat[SEP.join(path)] = np.asarray(node)

    walk(tree, ())
    return flat


def save_params_npz(tree: Any, path: str) -> None:
    """Save a nested parameter tree as a flat-key .npz with the keys of the
    JAX ``save_params``. The archive is stored uncompressed (JAX deflates
    its own; both load either): float32 weights barely deflate, and
    deflating the production model's 2 GB takes minutes."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flatten_params(tree))


def flat_from_module(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A port module's parameters as flat ``//``-keyed float arrays on the
    host: the inverse of ``load_flat_into``, the keys of the JAX tree. A
    tensor-parallel module's DTensors are gathered (a collective: every
    rank of its mesh calls this)."""
    return {k.replace(".", SEP): whole(v).detach().cpu().numpy()
            for k, v in module.state_dict().items()}


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


def gagavatar_from_flat(flat: Dict[str, np.ndarray]) -> torch.nn.Module:
    """The port's GAGAvatar networks (``GAGAvatarNets``, on the CPU) holding
    the parameters of a JAX ``GAGAvatar.init`` tree, checked as
    ``params_from_flat`` checks them."""
    # imported here: models/gagavatar/avatar.py imports this module
    from ..models.gagavatar.avatar import GAGAvatarNets

    return load_flat_into(GAGAvatarNets(), flat)


def load_flat_into(model: torch.nn.Module, flat: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Load flat ``//``-keyed JAX parameters into any of the port's modules
    (e.g. a ``BitwiseVAE`` with the JAX ``BitwiseVAE.init`` tree, a
    ``HubertEncoder`` or ``MimiEncoder`` with theirs), checking every key and
    shape as ``params_from_flat`` does. Returns ``model``."""
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
