"""Write the seed-0 parameters of the small golden config for the PyTorch port.

    JAX_PLATFORMS=cpu python tools/export_torch_fixture.py

Writes ``tests/fixtures/torch_golden_small_params.npz``: the JAX init of
``tests/test_ar_model.py``'s ``CFG`` at ``PRNGKey(0)``, as the flat
``//``-keyed npz of ``artalk_tpu.utils.checkpoint.save_params``. These are the
weights behind ``tests/fixtures/golden_small.npz``; ``chip_smoke.py`` loads
them into ``artalk_tpu_torch`` on the GPU, where no JAX is installed, and
replays the golden windows. ``tests/test_torch_params.py`` checks that the
committed file equals a fresh init.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "fixtures", "torch_golden_small_params.npz")


def main() -> str:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    from artalk_tpu.models.ar_model import BitwiseARModel
    from artalk_tpu.utils.checkpoint import save_params
    from test_ar_model import CFG

    save_params(BitwiseARModel(CFG).init(jax.random.PRNGKey(0)), OUT)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return OUT


if __name__ == "__main__":
    main()
