"""StreamPool batch-scaling curve on the card.

Counterpart of the repository's ``tools/bench_streampool.py``. Times the
pool's tick at B in {1, 2, 4, 8, 16, 32} sessions, every slot stepped:
``StreamPool.device_step`` (the batched window step and the carry merge, the
work ``StreamPool.step`` does before it copies the motion to the host),
chained ``--iters`` times after one warm-up step, by CUDA events with no sync
inside. Prints ms/tick, ms/session-window and the real-time streams the card
sustains at the 4-second window cadence, then the knee: the B with the most
streams.

    python -m artalk_tpu_torch.tools.bench_streampool [--sizes 1,2,4,8,16,32] [--iters 10]

The precision follows ``ARTALK_AR_PRECISION`` / ``ARTALK_AR_FUSED``, as the
serving entry point reads them (``engine._resolve_ar_precision``); the
weights are random from seed 0, one model for every B with its packs built
once. Float32 packs (``ARTALK_AR_FUSED=1`` alone) run the AR block-stack
kernel at B <= 2 and the encoder kernel at B = 1 only (the JAX package's
routing rules): at larger B the curve times plain torch. bf16 and int8
packs (``fast`` + fused, ``int8``) run both kernels at every B.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import ModelConfig
from ..engine import _resolve_ar_precision, build_fused_packs, resolve_device
from ..models.ar_model import BitwiseARModel
from ..serving import StreamPool
from ..utils.timing import pipelined_ms
from . import device_line

Row = Tuple[int, float, float, float]


def curve(ms_per_tick: Dict[int, float], window_s: float) -> Tuple[List[Row], Row]:
    """The curve's arithmetic, as the JAX tool does it: per batch size b
    with ``ms`` per tick the row (b, ms, ms per session-window ms / b,
    concurrent real-time streams window_s / (ms / 1e3) * b), and the knee,
    the row with the most streams."""
    rows = [(b, ms, ms / b, window_s / (ms / 1e3) * b) for b, ms in ms_per_tick.items()]
    return rows, max(rows, key=lambda r: r[3])


def main(argv: Optional[list] = None, device: Union[str, torch.device] = "cuda",
         config: Optional[ModelConfig] = None) -> List[Row]:
    """Run the curve on ``device`` with ``config`` (default the production
    ``ModelConfig()``; the precision switches of the environment applied);
    returns its rows."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sizes", default="1,2,4,8,16,32")
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    dev = resolve_device(device)
    print(f"{device_line(dev)}  precision={os.environ.get('ARTALK_AR_PRECISION', 'exact')}",
          flush=True)

    cfg = _resolve_ar_precision(config or ModelConfig())
    model = BitwiseARModel(cfg).init(torch.Generator().manual_seed(0)).to(dev)
    build_fused_packs(model)

    rng = np.random.default_rng(0)
    window_s = cfg.vae.window / cfg.fps
    ms_per_tick: Dict[int, float] = {}
    with torch.no_grad():
        for b in sizes:
            pool = StreamPool(model, max_sessions=b)
            audio = torch.from_numpy(
                rng.standard_normal((b, model.window_samples)).astype(np.float32) * 0.1).to(dev)
            stepped = torch.ones((b,), dtype=torch.bool, device=dev)
            ms_per_tick[b] = pipelined_ms(lambda i, prev: pool.device_step(audio, stepped)[1],
                                          args.iters, repeats=1, device=dev)[0]
            _, ms, per_session, streams = curve({b: ms_per_tick[b]}, window_s)[1]
            print(f"B={b:<3d} {ms:8.2f} ms/tick  {per_session:6.2f} ms/session-window"
                  f"  ~{streams:7.0f} concurrent RT streams", flush=True)

    rows, best = curve(ms_per_tick, window_s)
    print(f"\nknee: B={best[0]} -> {best[2]:.2f} ms/session-window, "
          f"~{best[3]:.0f} real-time streams/chip")
    return rows


if __name__ == "__main__":
    main()
