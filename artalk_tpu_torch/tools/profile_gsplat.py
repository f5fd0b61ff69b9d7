"""Stage-level device timing of the gaussian-splat prepass and kernel.

Counterpart of the repository's ``tools/profile_gsplat.py``. Times cumulative
prefixes of ``ops/gsplat.py``'s prepass, each built from the module's own
helpers, and summed to a scalar on the device; consecutive differences
localise each stage's cost:

    S0 projection (+ slot validity)
    S1 + stable depth argsort + the permute of the rows the slots need
    S2 + the valid slots' instance keys, the sort kernel (``ops/sort.py``)
       and the ``searchsorted`` tile offsets
    S3 + the instance gather (the port counts instances per frame: the
       list holds every valid instance, not a static budget)
    S4 the whole ``rasterize_gaussians``, which adds the splat kernel

    python -m artalk_tpu_torch.tools.profile_gsplat [--iters 20] [--size 512]

The scene is the JAX tool's (``make_scene``: seed 0, the 5023 head gaussians
and two 296x296 sheets). The tool ends with the JAX tool's sanity line: S3's
staged lists must equal ``ops/gsplat.prepass``'s bit for bit, or the stage
times above time another computation (the command then exits 1). The JAX tool's ``--slot-cap`` is left
out: it sized the static slot budget, which the port does not have.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Union

import numpy as np
import torch

from ..engine import resolve_device
from ..ops import gsplat as G
from ..utils.timing import timed
from . import device_line

N_HEAD = 5023
N_EXTRA = 2 * 296 * 296
FOCAL = 12.0
STAGES = ("project", "order", "sort", "gather")


def make_scene(rng: np.random.Generator, n_extra: int, dev: torch.device) -> list:
    """The GAGAvatar-shaped workload of the JAX tool: 5023 head gaussians and
    ``n_extra`` more; (xyz, colors, opacities, scales, rotations, camera)."""
    n = N_HEAD + n_extra
    xyz = rng.normal(0, 0.12, (n, 3)).astype(np.float32)
    xyz[:, 2] += 0.15
    colors = rng.uniform(0, 1, (n, G.CHANNELS)).astype(np.float32)
    opac = rng.uniform(0.3, 0.9, (n, 1)).astype(np.float32)
    scales = np.exp(rng.normal(-5.2, 0.3, (n, 3))).astype(np.float32)
    q = rng.normal(0, 1, (n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cam = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1.0]], np.float32)
    return [torch.from_numpy(a).to(dev) for a in (xyz, colors, opac, scales, q, cam)]


def staged(stop: str, xyz, scales, rots, opacities, cam, size: int) -> tuple:
    """The prepass through stage ``stop`` (one of ``STAGES``), by the helpers
    of ``ops/gsplat.py`` in the order its ``_build_instances`` calls them.
    Returns that stage's tensors: "project" the projection, the opacities and
    the slot validity; "order" the depth order and the permuted rows; "sort"
    the sorted keys and the tile offsets; "gather" (inst, offsets), the lists
    ``prepass`` returns."""
    comp = G._project_components(xyz, scales, rots, cam, FOCAL, size)
    op = torch.where(comp["in_front"], opacities[..., 0], 0.0)
    if stop == "project":
        return (*comp.values(), op, *G._slot_validity(comp["mx"], comp["my"],
                                                       comp["radius"], op, size))
    perm, *rows = G._depth_order(comp, op)
    if stop == "order":
        return (perm, *rows)
    sorted_key, offsets = G._sorted_keys(*rows, size)
    if stop == "sort":
        return sorted_key, offsets
    return G._instances(perm, sorted_key), offsets


def total(tensors) -> torch.Tensor:
    """Every tensor summed into one float64 scalar on the device."""
    return sum(t.sum(dtype=torch.float64) for t in tensors)


@torch.no_grad()
def main(argv: Optional[list] = None, device: Union[str, torch.device] = "cuda",
         config: Optional[int] = None) -> bool:
    """Profile the prepass on ``device`` on the scene with ``config``
    gaussians beyond the head's (default the JAX tool's two sheets,
    ``N_EXTRA``). Returns whether S3 equals ``prepass``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    it, size = args.iters, args.size
    dev = resolve_device(device)

    rng = np.random.default_rng(0)
    xyz, colors, opac, scales, rots, cam = make_scene(
        rng, N_EXTRA if config is None else config, dev)
    n = xyz.shape[0]
    geo, cols, inst, offsets = G.prepass(xyz, colors, opac, scales, rots, cam, focal=FOCAL,
                                         size=size)
    print(f"{device_line(dev)}  n={n}  instances={inst.numel()} "
          f"({inst.numel() / n:.2f} per gaussian)\n", flush=True)

    def stage(name, fn):
        return timed(name, fn, xyz, scales, rots, opac, iters=it, label_width=52, device=dev)

    t = [stage(name, lambda *a, stop=stop: total(staged(stop, *a, cam, size)))
         for name, stop in zip(("S0 projection + slot validity",
                                "S1 + depth argsort + row permute",
                                "S2 + instance-key sort + offsets",
                                "S3 + instance gather"), STAGES)]
    t.append(stage("S4 full rasterize (adds the splat kernel)",
                   lambda x, s, r, o: G.rasterize_gaussians(x, colors, o, s, r, cam, focal=FOCAL,
                                                            size=size).sum()))

    print("\n--- per-stage deltas ---")
    for name, d in [("projection/validity", t[0]),
                    ("argsort + row permute", t[1] - t[0]),
                    ("key sort + offsets", t[2] - t[1]),
                    ("instance gather", t[3] - t[2]),
                    ("compositing kernel", t[4] - t[3])]:
        print(f"{name:<52s} {d:9.2f} ms")

    got_inst, got_offsets = staged("gather", xyz, scales, rots, opac, cam, size)
    same = torch.equal(got_inst, inst) and torch.equal(got_offsets, offsets)
    print(f"\nS3 sanity vs production prepass: {'OK' if same else 'DRIFT -- fix staged'} "
          f"(staged {got_inst.numel()} instances, prepass {inst.numel()}; lists "
          f"{'equal' if same else 'differ'} bit for bit)")
    return same


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
