"""Multi-process wiring: one call turns a per-device process into a member of
a job (counterpart of ``artalk_tpu/parallel/distributed.py``).

Every process (one per device) calls ``initialize_multihost()`` at startup,
which starts the default ``torch.distributed`` process group; then
``parallel.mesh.make_mesh`` builds a job-wide mesh and the mesh-aware train
steps work unchanged, with NCCL routing the collectives over NVLink within a
host and the network across hosts.

Under ``torchrun`` the arguments come from its environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``)::

    torchrun --nproc_per_node 4 -m artalk_tpu_torch.training.train --multihost --tp 2 ...

Elsewhere pass ``coordinator_address`` ("host:port"), ``num_processes`` and
``process_id`` explicitly, as the localhost tests do.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..engine import resolve_device
from .sharding import batch_sharding


def _env(name: str) -> str:
    if name not in os.environ:
        raise RuntimeError(f"initialize_multihost: pass the argument or set {name} "
                           "(torchrun sets it)")
    return os.environ[name]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         local_device_ids: Optional[Sequence[int]] = None,
                         backend: Optional[str] = None) -> dict:
    """Join (or form) a multi-process job: start the default process group.

    Arguments default to torchrun's environment: ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, and ``LOCAL_RANK`` for the device (this rank's
    one device; ``local_device_ids`` names it instead). The backend is "nccl"
    on that CUDA device, which must exist, unless the caller asks for "gloo"
    (CPU tensors). Returns a summary dict (process index/count, local/global
    device counts) for logging."""
    if coordinator_address is None:
        coordinator_address = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT')}"
    if num_processes is None:
        num_processes = int(_env("WORLD_SIZE"))
    if process_id is None:
        process_id = int(_env("RANK"))
    if local_device_ids is None:
        local_device_ids = [int(os.environ.get("LOCAL_RANK", 0))]
    if len(local_device_ids) != 1:
        raise ValueError(f"one process drives one device; got local_device_ids "
                         f"{list(local_device_ids)}")
    backend = backend or "nccl"
    if backend == "nccl":
        torch.cuda.set_device(resolve_device(f"cuda:{local_device_ids[0]}"))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return {
        "process_id": dist.get_rank(),
        "num_processes": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def local_batch_to_global(mesh: DeviceMesh, local_batch, axis: int = 0) -> DTensor:
    """Assemble per-process batch shards into one dp-sharded global DTensor.

    Each rank passes its LOCAL slice of the batch (``global_batch / dp`` rows
    on ``axis``; the ranks of one dp row pass the same slice); returns the
    global DTensor, sharded batch-on-dp over ``mesh``, on the mesh's device
    type. With one rank it is the batch itself."""
    t = torch.as_tensor(np.asarray(local_batch) if not isinstance(local_batch, torch.Tensor)
                        else local_batch)
    t = t.to(mesh.device_type).contiguous()
    return DTensor.from_local(t, mesh, batch_sharding(mesh, t.ndim, axis), run_check=False)
