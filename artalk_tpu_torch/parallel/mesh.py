"""Device mesh construction (counterpart of ``artalk_tpu/parallel/mesh.py``).

The port scales through ``torch.distributed``: one process (rank) drives one
device, and a 2-D ``DeviceMesh`` over the ranks of the default process group
names the two axes the JAX package's ``Mesh`` has:

- ``dp``: data parallel (independent clips / batch elements)
- ``tp``: tensor parallel (attention heads + MLP shards within a layer)

The process group is started by ``parallel.distributed.initialize_multihost``
(or by the caller); ``make_mesh`` never starts one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_DIMS = ("dp", "tp")


def make_mesh(dp: Optional[int] = None, tp: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """Build a (dp, tp) mesh over the ranks of the default process group.

    Defaults to all ranks on the dp axis; a mesh smaller than the world takes
    the first ``dp * tp`` ranks (every rank must call this, as every rank
    joins the mesh's groups). tp should divide the head counts in play (12 AR
    heads, 16 wav2vec heads -> tp in {1, 2, 4}). ``device_type`` is "cuda"
    unless the caller asks for "cpu"; a CUDA mesh without a card raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize_multihost() (or "
                           "torch.distributed.init_process_group) first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available; pass device_type='cpu' "
                           "explicitly for a CPU mesh")
    n = dist.get_world_size()
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} ranks not divisible by tp={tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"mesh {dp}x{tp} needs more than {n} ranks")
    # an explicit rank array: init_device_mesh takes the whole world only
    ranks = torch.arange(dp * tp).reshape(dp, tp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_DIMS)
