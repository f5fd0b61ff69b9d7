"""The knee of a streaming cell: its traffic at several session counts, in
one process on one engine, with the latency of each.

    python3 benchmark/sweep_stream.py --workload stream-int8-http --seconds 16 \\
        --sessions 64 128 192 256

For each N a server of capacity N takes N real-time sessions for
``--seconds`` (as a run's window), and one line gives the chunks' p50 and
p95 latency from their due times, the failures, the median latency of the
chunks due in the window's first and last quarter (a growing backlog shows
as the second above the first) and the median pool step. The knee is the
largest N whose p95 stays at or under one window of audio with no backlog.
"""

import argparse
import json
import statistics
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="stream-int8-http")
    ap.add_argument("--seconds", type=float, default=16.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--sessions", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.set_environment()
    import copy

    import torch

    from benchmark import program
    from benchmark.run import Context

    entry, cell, config = harness.cell_files(args.workload)
    harness.require_devices(entry["chips"])
    device = torch.device("cuda", 0)
    driver = harness.load_module(harness.BENCH / "drivers" / f"{cell['driver']}.py", "driver")
    print(f"device: {harness.power_limit()}", file=sys.stderr)
    engine = program.build_engine(config["model"], cell, args.seed, device)
    for n in args.sessions:
        c = copy.deepcopy(cell)
        c["traffic"]["sessions"] = n
        ns = types.SimpleNamespace(seed=args.seed, seconds=args.seconds, trace=0)
        ctx = Context(ns, entry, c, config, device)
        state = driver.setup(ctx, engine=engine)
        out = driver.window(ctx, state)
        driver.release(state)
        chunks = state["chunks"]
        start, quarter = state["start"], args.seconds / 4
        lat = lambda lo, hi: [(d1 - due) * 1e3 for _, _, due, _, d1, st, _ in chunks
                              if st == 200 and lo <= due - start < hi]
        first, last = lat(0, quarter), lat(3 * quarter, args.seconds)
        ticks = driver.window_ticks(ctx, state)
        print(json.dumps({
            "sessions": n, "attempted": out["attempted"], "failed": out["failed"],
            **out["metrics"],
            "first_quarter_p50_ms": statistics.median(first) if first else None,
            "last_quarter_p50_ms": statistics.median(last) if last else None,
            "pool_step_p50_ms": statistics.median((t.end - t.start) * 1e3 for t in ticks),
            "rows_per_tick": statistics.mean(t.info[0] for t in ticks),
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}), flush=True)
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
