"""Parameter persistence: flat-key .npz (portable) and a sharded checkpoint.

Counterpart of ``artalk_tpu/utils/checkpoint.py``. A module's parameters (or
a nested tree of dicts and lists of arrays) are saved under the flat keys of
the JAX ``save_params``: the tree path joined with ``//``, which for a port
module is its state-dict key with ``.`` replaced by ``//`` (the port's modules
mirror the JAX tree name for name). Either package loads the other's .npz.

``save_params_sharded`` / ``load_params_sharded`` take the place of the JAX
package's orbax pair: ``torch.distributed.checkpoint`` writes each rank's
shards of the DTensor parameters that ``parallel.shard_params`` made, and a
load restores into the placements of the module it is given, whatever the
layout the checkpoint was saved from (another (dp, tp) mesh, or none).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed.checkpoint as dcp
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ..parallel.sharding import whole

SEP = "//"


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # a DTensor gathered whole (a collective: every rank of its mesh calls this)
        return whole(leaf).detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_params(tree: Any) -> Dict[str, np.ndarray]:
    """Flat ``//``-keyed host arrays of a nested tree, as the JAX
    ``_flatten`` keys a pytree: dict keys by name (in sorted order), list and
    tuple items by index, ``None`` leaves dropped, dtypes kept."""
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
            flat[SEP.join(path)] = _host(node)

    walk(tree, ())
    return flat


def flat_from_module(module: nn.Module) -> Dict[str, np.ndarray]:
    """A module's parameters as flat ``//``-keyed host arrays, the keys of
    the JAX tree: the inverse of ``load_flat_into``. A tensor-parallel
    module's DTensors are gathered (a collective: every rank of its mesh
    calls this)."""
    return {k.replace(".", SEP): _host(v) for k, v in module.state_dict().items()}


def _write(params: Any, path: str, savez) -> None:
    flat = flat_from_module(params) if isinstance(params, nn.Module) else flatten_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    savez(path, **flat)


def save_params(params: Any, path: str) -> None:
    """Save a module's parameters, or a parameter tree, as a deflated
    flat-key .npz, as the JAX package writes it."""
    _write(params, path, np.savez_compressed)


def save_params_npz(params: Any, path: str) -> None:
    """``save_params`` with the arrays stored as they are: float32 weights
    barely deflate, and deflating the production model's 2 GB takes
    minutes. Both load alike."""
    _write(params, path, np.savez)


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat ``//``-keyed arrays of an .npz that either package wrote."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _check(like: nn.Module, shapes: Dict[str, tuple]) -> None:
    """Every parameter of ``like`` must be among ``shapes`` (flat key ->
    shape) at its own shape: KeyError / ValueError, with the JAX loader's
    messages. Keys ``like`` has no use for are ignored."""
    for key, t in like.state_dict().items():
        key = key.replace(".", SEP)
        if key not in shapes:
            raise KeyError(f"checkpoint missing parameter {key!r}")
        if tuple(shapes[key]) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key!r}: ckpt {tuple(shapes[key])} "
                             f"vs model {tuple(t.shape)}")


@torch.no_grad()
def load_flat_into(like: nn.Module, flat: Dict[str, Any]) -> nn.Module:
    """Copy flat ``//``-keyed arrays into every parameter of ``like`` (any of
    the port's modules), in place, after checking all of them: KeyError for
    a missing key, ValueError for a wrong shape. Each value is cast to the
    parameter's dtype on its device; a DTensor parameter takes its own shard
    of the value (no communication). Returns ``like``."""
    _check(like, {k: np.shape(v) for k, v in flat.items()})
    for key, t in like.state_dict().items():
        src = torch.from_numpy(np.array(flat[key.replace(".", SEP)]))
        if isinstance(t, DTensor):
            src = distribute_tensor(src.to(t.device, t.dtype), t.device_mesh, t.placements,
                                    src_data_rank=None)
        t.copy_(src)
    return like


def load_params(path: str, like: Optional[nn.Module] = None) -> Any:
    """Load a flat-key .npz (written by either package).

    With ``like`` (a module, e.g. a freshly built model) every parameter is
    checked and copied into it (``load_flat_into``) and ``like`` is
    returned; without it, a nested dict of the arrays is rebuilt from the
    flat keys (list indices become string keys)."""
    flat = load_params_npz(path)
    if like is not None:
        return load_flat_into(like, flat)
    tree: dict = {}
    for key, arr in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state under flat ``//`` keys; the values alias its
    parameters (plain tensors or DTensors)."""
    return {k.replace(".", SEP): v for k, v in module.state_dict().items()}


def save_params_sharded(module: nn.Module, path: str) -> None:
    """Write ``module``'s parameters as a ``torch.distributed.checkpoint``
    directory at ``path`` (replacing one that is there). Under a process
    group every rank calls it and writes its own shards of the DTensor
    parameters (a replicated tensor once); without one, the process writes
    them all. Returns when the files are written."""
    dcp.save(_state(module),
             storage_writer=dcp.FileSystemWriter(os.path.abspath(path), overwrite=True))


def load_params_sharded(path: str, like: nn.Module) -> nn.Module:
    """Restore a ``save_params_sharded`` directory into ``like``, in place, in
    ``like``'s own placements: DTensors on any (dp, tp) mesh or plain
    tensors, with or without a process group, whatever layout the
    checkpoint was saved from. Every parameter is checked first, as
    ``load_params`` checks it. Returns ``like``."""
    path = os.path.abspath(path)
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    _check(like, {k: tuple(m.size) for k, m in meta.items() if hasattr(m, "size")})
    dcp.load(_state(like), checkpoint_id=path)
    return like
