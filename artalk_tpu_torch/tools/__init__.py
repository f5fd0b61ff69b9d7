"""The system's own measurement tools, on the card: counterparts of the
repository's ``tools/`` scripts of the same names.

    python -m artalk_tpu_torch.tools.bench_streampool [--sizes 1,2,4,8,16,32] [--iters 10]
    python -m artalk_tpu_torch.tools.bench_http_serving [--clients 1 4 8 16] [--windows 6]
                                                        [--precision int8|fast|exact]
    python -m artalk_tpu_torch.tools.profile_pipeline [--iters 10] [--precision exact]
    python -m artalk_tpu_torch.tools.profile_encoder [--iters 10] [--windows 8] [--fused]
    python -m artalk_tpu_torch.tools.profile_gsplat [--iters 20] [--size 512]
    python -m artalk_tpu_torch.tools.profile_gaga [--k 8]

Each keeps the JAX tool's flags, defaults, seeds and printed rows, so the two
outputs line up row for row, and prints first a ``device:`` line with the
card's name and power limit (``bench.device_info``). Each module's
``main(argv=None, device="cuda", config=None)`` runs on the card; without
CUDA it raises before any work, so the command exits non-zero. The tests
call them with ``device="cpu"`` at small sizes, where every kernel takes its
plain version and the times are the CPU's.

Timing goes through ``utils/timing`` (CUDA events around chained calls with
no sync inside: the counterpart of the JAX tools' "enqueue N, fetch once").
The tools build their own models from seed 0 and read the repository's
``assets/`` (``ASSETS``) for FLAME, the avatars and a checkpoint.
"""

from __future__ import annotations

import torch

from ..bench import device_info


def device_line(dev: torch.device) -> str:
    """``device: <name>, <power limit>`` as nvidia-smi reports them (the
    CPU's line names the CPU alone)."""
    info = device_info(dev)
    return "device: " + ", ".join(v for v in (info["name"], info["power_limit"]) if v)
