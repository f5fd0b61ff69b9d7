"""Multi-process smoke of artalk_tpu_torch.parallel (counterpart of
tests/test_multihost.py): 2 real processes on localhost, one process group,
one mesh.

Launches two subprocesses (gloo on the CPU, one rank each); both call
``parallel.distributed.initialize_multihost`` with the rendezvous taken from
the environment (MASTER_ADDR / MASTER_PORT on a port bound then freed,
WORLD_SIZE, RANK, LOCAL_RANK, as torchrun sets them), build a job-wide
(dp=2, tp=1) mesh, assemble a global dp-sharded batch from per-process local
shards, and reduce it to a number that depends on BOTH processes' data. The
children import no jax.
"""

import os
import socket
import subprocess
import sys

_CHILD = r"""
import os, sys

sys.path.insert(0, os.environ["ARTALK_REPO"])
import numpy as np
import torch
import torch.distributed as dist

from artalk_tpu_torch.parallel.distributed import (initialize_multihost, is_distributed,
                                                   local_batch_to_global)
from artalk_tpu_torch.parallel.mesh import make_mesh

info = initialize_multihost(backend="gloo")
assert info["num_processes"] == 2, info
assert info["global_devices"] == 2 and info["local_devices"] == 1, info
assert info["process_id"] == int(os.environ["RANK"]), info
assert is_distributed()

mesh = make_mesh(tp=1, device_type="cpu")
assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.shape) == (2, 1), mesh

# per-process local shard: process p contributes rows filled with p+1
local = np.full((2, 4), info["process_id"] + 1, np.float32)
batch = local_batch_to_global(mesh, local)
assert tuple(batch.shape) == (4, 4) and tuple(batch.to_local().shape) == (2, 4)
total = batch.sum().full_tensor()
print("MULTIHOST_SUM", float(total), flush=True)
dist.destroy_process_group()
assert not any(m.split(".")[0] in ("jax", "jaxlib", "artalk_tpu") for m in sys.modules)
"""


def test_two_process_localhost_smoke():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env["MASTER_ADDR"] = "127.0.0.1"
        env["MASTER_PORT"] = str(port)
        env["WORLD_SIZE"] = "2"
        env["RANK"] = str(rank)
        env["LOCAL_RANK"] = str(rank)
        env["ARTALK_REPO"] = repo
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out}"
        # rows: 2x4 of 1.0 (rank 0) + 2x4 of 2.0 (rank 1) -> sum 24
        assert "MULTIHOST_SUM 24.0" in out, f"process {rank} output:\n{out}"
