"""Train states, the optimizer and the train steps of both stages.

Counterpart of ``artalk_tpu/training/trainer.py``. The
optimizer is optax's ``chain(clip_by_global_norm(1.0), adamw(...))`` under a
``warmup_cosine_decay_schedule``, written out with PyTorch's multi-tensor
(``foreach``) ops so that its semantics are optax's:

- the schedule's step 0 is at learning rate 0 (linear warmup from 0, then a
  cosine to 0 at ``max(total_steps, warmup_steps + 1)``);
- the gradients are scaled by 1/norm only when their global norm is at
  least 1 (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
- AdamW (b1 0.9, b2 0.95, eps 1e-8 outside the square root) updates every
  leaf of the JAX parameter tree, i.e. every parameter of the module: the
  frozen VAE and audio encoder of stage 2 have zero gradients, and the
  decoupled weight decay still shrinks them each step, as in JAX.
  (``torch.optim.AdamW`` skips a parameter whose ``.grad`` is None.)

Each step runs with TF32 off (``models.nn.no_tf32``), as the JAX reference
computes in float32. Parameters are updated in place; a step returns the
state with its counter advanced and the metrics as device tensors (the norm
in ``grad_norm`` is the one before clipping).

With a ``mesh`` (``parallel.make_mesh``; the model's parameters placed by
``parallel.shard_params``) each rank steps on its dp rows of the global
batch (``data.prefetch_to_device(mesh=...)`` gives them) under
``implicit_replication``. Data parallelism is explicit: the gradients'
local tensors are averaged over the dp group with ``all_reduce``, so the
step is the one-process step on the global batch (the loss is its mean; the
one batch statistic, BSQ's codebook entropy, is reduced inside the loss).
Tensor parallelism is DTensor's: the tp shards' partial sums are reduced by
its ops, and the optimizer works on each parameter's local shard, with the
global norm summing the squares of the shards over the tp group.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..models import nn as tnn
from ..models.ar_model import BitwiseARModel, drop_path_masks
from ..models.bitwise_vae import BitwiseVAE
from ..parallel.sharding import is_whole, whole
from .losses import ar_loss, vae_loss


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (its shard), a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(grads: Sequence[torch.Tensor], sharded: Sequence[bool], tp_group
                ) -> torch.Tensor:
    """The L2 norm of the whole gradient from local tensors, summed in
    float64 (the CPU's float32 norm of a tensor of tens of millions of
    elements is off by 1e-3 relative; the card's fused norm is not): the
    squares of each ``sharded`` tensor's shards summed over ``tp_group``,
    each replicated tensor counted once."""
    norms = torch.stack(torch._foreach_norm(list(grads), dtype=torch.float64))
    if not any(sharded):
        return torch.linalg.vector_norm(norms)
    sq = norms.square()
    mask = torch.tensor(list(sharded), device=sq.device)
    part = sq[mask].sum()
    dist.all_reduce(part, group=tp_group)
    return torch.sqrt(part + sq[~mask].sum())


def dp_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Average the tensors (the gradients' local tensors) over the ranks of
    ``group``, in place, with one all-reduce of their concatenation (a
    gradient may be a strided view, which a collective does not write
    back)."""
    if not tensors:
        return
    buf = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(buf, group=group)
    buf /= dist.get_world_size(group)
    for t, part in zip(tensors, buf.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def rank_drop_masks(rates: torch.Tensor, batch: int, generator: torch.Generator,
                    mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """DropPath masks of this rank's ``batch`` rows: with a mesh, drawn for
    the global batch (``batch`` x dp) and sliced to the rank's rows, so a dp
    step drops what the one-process step drops."""
    if mesh is None:
        return drop_path_masks(rates, batch, generator)
    r = mesh.get_local_rank("dp")
    return drop_path_masks(rates, batch * mesh.size(0), generator)[
        :, :, r * batch:(r + 1) * batch]


class AdamWState(NamedTuple):
    mu: List[torch.Tensor]   # first moments, one per parameter
    nu: List[torch.Tensor]   # second moments
    count: int               # updates applied so far (the schedule's step)


class TrainState(NamedTuple):
    model: nn.Module          # holds the parameters, updated in place
    opt_state: AdamWState
    step: int


class AdamW:
    """Global-norm clipping followed by AdamW under a warmup-cosine learning
    rate, with optax's order of operations and the JAX trainer's constants."""

    b1, b2, eps, max_norm = 0.9, 0.95, 1e-8, 1.0

    def __init__(self, lr: float = 1e-4, weight_decay: float = 0.01,
                 warmup_steps: int = 1000, total_steps: int = 100_000):
        self.peak, self.weight_decay = lr, weight_decay
        self.warmup_steps = warmup_steps
        self.decay_steps = max(total_steps, warmup_steps + 1)

    def learning_rate(self, count: int) -> float:
        """``optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps)``
        at ``count``."""
        if count < self.warmup_steps:
            frac = 1.0 - max(count, 0) / self.warmup_steps
            return -self.peak * frac + self.peak
        span = self.decay_steps - self.warmup_steps
        count = min(count - self.warmup_steps, span)
        return self.peak * 0.5 * (1.0 + math.cos(math.pi * count / span))

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        """Zero moments, shaped like each parameter's local tensor."""
        return AdamWState([torch.zeros_like(_local(p)) for p in params],
                          [torch.zeros_like(_local(p)) for p in params], 0)

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[Optional[torch.Tensor]], state: AdamWState
               ) -> tuple:
        """One update of ``params`` in place; a None gradient counts as
        zero. DTensor parameters (and their gradients, placed alike) are
        updated through their local shards. Returns (new state, the
        gradients' global norm before clipping)."""
        sharded = [isinstance(p, DTensor) and not is_whole(p) for p in params]
        tp_group = next((p.device_mesh.get_group("tp") for p, s in zip(params, sharded) if s),
                        None)
        params = [_local(p) for p in params]
        grads = [torch.zeros_like(p) if g is None else _local(g) for p, g in zip(params, grads)]
        norm = global_norm(grads, sharded, tp_group).to(grads[0].dtype)
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        grads = torch._foreach_mul(grads, scale)
        lr = self.learning_rate(state.count)
        count = state.count + 1
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                   1.0 - self.b2))
        del grads
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        return AdamWState(mu, nu, count), norm


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 1000, total_steps: int = 100_000) -> AdamW:
    return AdamW(lr, weight_decay, warmup_steps, total_steps)


def init_state(model: nn.Module, optimizer: AdamW) -> TrainState:
    """Turn grads on for every parameter of ``model`` and start the
    optimizer's state."""
    model.requires_grad_(True)
    return TrainState(model, optimizer.init(list(model.parameters())), 0)


def _apply(state: TrainState, optimizer: AdamW, loss: torch.Tensor,
           metrics: Dict[str, torch.Tensor], mesh: Optional[DeviceMesh] = None):
    """Gradients of ``loss``, averaged over dp with a mesh (each DTensor
    gradient placed as its parameter), then the optimizer's update; the
    metrics as plain tensors, averaged over dp."""
    params = list(state.model.parameters())
    grads = list(torch.autograd.grad(loss, params, allow_unused=True))
    metrics = {k: whole(v.detach()) for k, v in metrics.items()}
    if mesh is not None:
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) and g.placements != p.placements else g
                 for p, g in zip(params, grads)]
        group = mesh.get_group("dp")
        with torch.no_grad():
            dp_mean_([_local(g) for g in grads if g is not None], group)
            values = torch.stack(list(metrics.values()))
            dist.all_reduce(values, group=group)
            metrics = dict(zip(metrics, values / dist.get_world_size(group)))
    opt_state, metrics["grad_norm"] = optimizer.update(params, grads, state.opt_state)
    return TrainState(state.model, opt_state, state.step + 1), metrics


def _sharded(mesh: Optional[DeviceMesh]):
    """The context a step runs in: ``implicit_replication`` with a mesh."""
    return implicit_replication() if mesh is not None else contextlib.nullcontext()


def make_vae_train_step(vae: BitwiseVAE, optimizer: AdamW,
                        mesh: Optional[DeviceMesh] = None) -> Callable:
    """Stage-1 step: (state, prev_motion, this_motion) -> (state, metrics);
    ``state.model`` is ``vae``. With ``mesh`` the motions are this rank's dp
    rows."""
    dp_group = None if mesh is None else mesh.get_group("dp")

    def step(state: TrainState, prev_motion: torch.Tensor, this_motion: torch.Tensor):
        with tnn.no_tf32(), _sharded(mesh):
            loss, metrics = vae_loss(vae, prev_motion, this_motion, dp_group=dp_group)
            return _apply(state, optimizer, loss, metrics, mesh)

    return step


def make_ar_train_step(model: BitwiseARModel, optimizer: AdamW,
                       mesh: Optional[DeviceMesh] = None, drop_path: bool = True,
                       seed: int = 1234) -> Callable:
    """Stage-2 step: (state, audio_chunk, prev_motion, this_motion[,
    style_motion]) -> (state, metrics); ``state.model`` is ``model``. With
    ``mesh`` the batch arguments are this rank's dp rows.

    ``drop_path`` applies stochastic depth with masks drawn from a
    generator on the model's device seeded from (``seed``, step): the same
    step draws the same masks, but not JAX's (its keys come from
    ``fold_in(PRNGKey(seed), step)``)."""
    device = model.pos_embed.device

    def step(state: TrainState, audio_chunk: torch.Tensor, prev_motion: torch.Tensor,
             this_motion: torch.Tensor, style_motion: Optional[torch.Tensor] = None):
        with tnn.no_tf32(), _sharded(mesh):
            masks = None
            if drop_path:
                gen = torch.Generator(device=device).manual_seed((seed << 32) + state.step)
                masks = rank_drop_masks(model.drop_path_rates(), audio_chunk.shape[0], gen,
                                        mesh)
            loss, metrics = ar_loss(model, audio_chunk, prev_motion, this_motion,
                                    style_motion, drop_masks=masks)
            return _apply(state, optimizer, loss, metrics, mesh)

    return step
