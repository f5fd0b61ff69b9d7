"""On the card: each cell's control (the plain reference one precision step
below the configuration's, in the program's place) must fail one of the
cell's compared numbers, while the program passes all of them. The cells run
at their own sizes, with a short window.

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests
"""

import json
import types
from pathlib import Path

import pytest

from benchmark import harness

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.reference.motion import Precision
    from benchmark.run import Context

    harness.set_environment()
    entry, cell, config = harness.cell_files(workload)
    driver = harness.load_module(harness.BENCH / "drivers" / f"{cell['driver']}.py", "drv")
    args = types.SimpleNamespace(seed=2**31 + 4099, seconds=8.0, trace=0)
    ctx = Context(args, entry, cell, config, torch.device("cuda", 0))
    state = driver.setup(ctx)
    driver.window(ctx, state)
    driver.release(state)
    program = driver.program_numbers(ctx, state)
    control = driver.control(ctx, state, Precision(**cell["control"]))
    limits = cell["limits"]
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
