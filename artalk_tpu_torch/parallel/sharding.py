"""Parameter sharding rules (counterpart of ``artalk_tpu/parallel/sharding.py``).

Tensor-parallel layout for the transformer stacks (Megatron-style column/row
split), expressed as ``DTensor`` placements on the mesh's ``tp`` axis and
keyed on the flat ``//`` parameter names of the JAX tree
(``utils/params.flat_from_module`` gives them):

- q/k/v projections: shard the output (head) dimension (``Shard(ndim - 1)``)
- attention output projection: shard the input dimension (``Shard(ndim - 2)``;
  DTensor reduces the partial sums)
- MLP: fc1 column-split, fc2 row-split
- everything else (embeddings, norms, the tiny VAE/style towers): replicated

Every parameter is replicated on ``dp``. A sharded model runs under
``torch.distributed.tensor.experimental.implicit_replication()``, which
treats the plain tensors it meets (inputs, buffers) as replicated.
The CUDA kernels launch through ctypes on plain tensors: ``whole`` gives a
DTensor's full value for them (its local tensor where that is whole, else
the gathered ``full_tensor()``), so a kernel never runs on one shard.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

SEP = "//"


def _spec_for(path: str, ndim: int) -> Placement:
    """The ``tp`` placement of a parameter from its flat ``//`` path."""
    # AR transformer blocks: stacked (depth, in, out) weights
    if "blocks" in path:
        if any(f"{n}//w" in path for n in ("q", "k", "v", "fc1")):
            return Shard(ndim - 1)                           # column parallel
        if any(f"{n}//b" in path for n in ("q", "v", "fc1")):
            return Shard(ndim - 1)
        if "proj//w" in path or "fc2//w" in path:
            return Shard(ndim - 2)                           # row parallel
        return Replicate()
    # wav2vec encoder layers: same pattern
    if "audio_encoder" in path and "layers" in path:
        if any(f"{n}//w" in path for n in ("q", "k", "v", "fc1")):
            return Shard(ndim - 1)
        if any(f"{n}//b" in path for n in ("q", "k", "v", "fc1")):
            return Shard(ndim - 1)
        if "out//w" in path or "fc2//w" in path:
            return Shard(ndim - 2)
        return Replicate()
    return Replicate()  # replicated


def param_shardings(model: nn.Module, mesh: DeviceMesh) -> Dict[str, Tuple[Placement, ...]]:
    """``{flat name: (dp placement, tp placement)}`` of every parameter of
    ``model`` on ``mesh``'s (dp, tp) axes."""
    return {name.replace(".", SEP): (Replicate(), _spec_for(name.replace(".", SEP), p.ndim))
            for name, p in model.named_parameters()}


@torch.no_grad()
def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Replace every parameter of ``model``, in place, by a ``DTensor`` on
    ``mesh`` placed by the rules, keeping ``requires_grad``. Every rank must
    hold the same values (the same seed or checkpoint): each keeps its own
    shard of its own copy, with no communication. Returns ``model``."""
    shardings = param_shardings(model, mesh)
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        dt = distribute_tensor(p.detach(), mesh, shardings[name.replace(".", SEP)],
                               src_data_rank=None)
        model.get_submodule(owner)._parameters[attr] = nn.Parameter(
            dt, requires_grad=p.requires_grad)
    return model


def batch_sharding(mesh: DeviceMesh, ndim: int, axis: int = 0) -> Tuple[Placement, ...]:
    """Placements of an ``ndim``-d batch sharded on dp along ``axis``,
    replicated on tp."""
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for a {ndim}-d batch")
    return (Shard(axis % ndim), Replicate())


def is_whole(t: DTensor) -> bool:
    """Does every rank's local tensor of ``t`` hold all of its values
    (replicated, or sharded over a mesh axis of one)?"""
    return all(p.is_replicate() or t.device_mesh.size(i) == 1
               for i, p in enumerate(t.placements))


def whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a plain tensor holding all of its values: a DTensor's local
    tensor where that is whole, else its ``full_tensor()`` (a collective:
    every rank of the mesh calls it). A plain tensor is returned as it is.
    Differentiable, as ``to_local`` and ``full_tensor`` are."""
    if not isinstance(t, DTensor):
        return t
    return t.to_local() if is_whole(t) else t.full_tensor()
