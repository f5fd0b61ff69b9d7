"""Readings that set a cell's limits: the program's compared numbers and the
control's, seed by seed, in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed the cell's system is built and driven for ``--seconds`` as in
a run; then the check's numbers are read for the program, and for the
control: the plain reference put in the program's place at the precision
the cell's ``control`` names (TF32 for a float32 cell, fewer weight bits for
an int8 one), judged against the float32 reference on the same outputs.
One JSON line per seed. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true",
                    help="read the program's numbers only")
    args = ap.parse_args(argv)
    harness.set_environment()
    import torch

    from benchmark.reference.motion import Precision
    from benchmark.run import Context

    entry, cell, config = harness.cell_files(args.workload)
    harness.require_devices(entry["chips"])
    device = torch.device("cuda", 0)
    driver = harness.load_module(harness.BENCH / "drivers" / f"{cell['driver']}.py", "driver")
    prec = Precision(**cell["control"])
    print(f"device: {harness.power_limit()}", file=sys.stderr)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ns = types.SimpleNamespace(seed=seed, seconds=args.seconds, trace=0)
        ctx = Context(ns, entry, cell, config, device)
        state = driver.setup(ctx)
        outcome = driver.window(ctx, state)
        driver.release(state)
        torch.cuda.empty_cache()
        program = driver.program_numbers(ctx, state)
        line = {"seed": seed, "attempted": outcome["attempted"], "program": program}
        if not args.no_control:
            line["control"] = driver.control(ctx, state, prec)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
