"""Multi-device scaling on ``torch.distributed``: device meshes, parameter
sharding rules (DTensor placements), frame-parallel rendering and
multi-process jobs (counterpart of ``artalk_tpu/parallel``)."""

from .mesh import make_mesh
from .sharding import param_shardings, shard_params

__all__ = ["make_mesh", "param_shardings", "shard_params"]
