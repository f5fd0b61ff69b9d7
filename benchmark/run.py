"""Run one cell of the benchmark on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run is one process: it builds the cell's system from the seed (set-up,
counted in ``setup_s`` from the process's start to the first measured
request), measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line of
standard output. With ``--trace 1`` a stretch of whole clips or ticks of
the window runs under ``torch.profiler`` and the line carries the per-layer
metrics instead of the end-to-end ones. A run exits non-zero and prints no result when CUDA
or enough cards are missing, when a cell or file is missing, or when JAX or
the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

TRACE_SECONDS = 3.0


class Context:
    def __init__(self, args, entry, cell, config, device):
        self.seed, self.seconds, self.traced = args.seed, args.seconds, bool(args.trace)
        self.entry, self.cell, self.config = entry, cell, config
        self.model = config["model"]
        self.device = device
        self.spans = harness.Spans(self.traced)
        self.tracer = harness.Tracer(self.traced, min(TRACE_SECONDS, args.seconds / 4))


def per_layer(ctx, driver, state) -> dict:
    """Every per-layer metric of the manifest that this cell reports, read
    by its own file under ``layer_metrics/``; a reader that finds nothing
    returns None and the metric is left out."""
    man = harness.manifest()
    reported = {m["name"] for m in man["end_to_end"]
                if "workloads" not in m or ctx.entry["name"] in m["workloads"]}
    data = driver.layer_data(ctx, state)
    out = {}
    for m in man["per_layer"]:
        cells = m.get("workloads")
        if (ctx.entry["name"] not in cells) if cells else (m["moves"] not in reported):
            continue
        mod = harness.load_module(harness.BENCH / "layer_metrics" / f"{m['name']}.py",
                                  f"layer_metric_{m['name']}")
        value = mod.read(ctx, data, ctx.spans, ctx.tracer.trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(ctx, t_process: float) -> tuple:
    """Set-up, window and check of one run: (result, compared numbers)."""
    import torch

    cell, device = ctx.cell, ctx.device
    on_card = device.type == "cuda"
    driver = harness.load_module(harness.BENCH / "drivers" / f"{cell['driver']}.py",
                                 f"driver_{cell['driver']}")
    if on_card:
        ctx.tracer.prime()
    state = driver.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_process
    outcome = driver.window(ctx, state)
    if on_card:
        torch.cuda.synchronize()
        dev = harness.device_info(device, ctx.entry["chips"])
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if ctx.traced:
        dev["busy_s"] = ctx.tracer.trace.busy_s()
        dev["window_s"] = ctx.tracer.trace.window_s
        metrics = per_layer(ctx, driver, state)
    else:
        units = {m["name"]: m["unit"] for m in harness.manifest()["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in outcome["metrics"].items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    driver.release(state)
    if on_card:
        torch.cuda.empty_cache()
    correct, numbers = driver.check(ctx, state)
    found = harness.forbidden_modules()
    if found:
        raise harness.BenchmarkError(f"modules of JAX or the JAX package loaded: {found}")
    result = {"correct": bool(correct), "attempted": outcome["attempted"],
              "failed": outcome["failed"], "metrics": metrics, "device": dev}
    if ctx.traced:
        result["breakdown"] = ctx.tracer.trace.breakdown()
    return result, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        entry, cell, config = harness.cell_files(args.workload)
        harness.set_environment()
        import torch

        torch.set_num_threads(harness.HOST_THREADS)
        harness.require_devices(entry["chips"])
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        print(f"device: {harness.power_limit()}", file=sys.stderr)
        ctx = Context(args, entry, cell, config, device)
        result, numbers = execute(ctx, T_PROCESS)
    except harness.BenchmarkError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    except Exception:  # noqa: BLE001 - a run that fails prints its traceback and no result
        traceback.print_exc()
        return 1
    harness.emit(result, numbers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
