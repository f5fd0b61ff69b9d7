"""Train states, the optimizer and the train steps of both stages.

Counterpart of ``artalk_tpu/training/trainer.py``, on one device. The
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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..models import nn as tnn
from ..models.ar_model import BitwiseARModel, drop_path_masks
from ..models.bitwise_vae import BitwiseVAE
from .losses import ar_loss, vae_loss


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
        return AdamWState([torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params], 0)

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[Optional[torch.Tensor]], state: AdamWState
               ) -> tuple:
        """One update of ``params`` in place; a None gradient counts as
        zero. Returns (new state, the gradients' global norm before
        clipping)."""
        params = list(params)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        # float64 sums: the CPU's float32 norm of a tensor of tens of millions
        # of elements is off by 1e-3 relative (the card's fused norm is not)
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, dtype=torch.float64))).to(grads[0].dtype)
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
           metrics: Dict[str, torch.Tensor]):
    params = list(state.model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    opt_state, metrics["grad_norm"] = optimizer.update(params, grads, state.opt_state)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return TrainState(state.model, opt_state, state.step + 1), metrics


def make_vae_train_step(vae: BitwiseVAE, optimizer: AdamW) -> Callable:
    """Stage-1 step: (state, prev_motion, this_motion) -> (state, metrics);
    ``state.model`` is ``vae``."""

    def step(state: TrainState, prev_motion: torch.Tensor, this_motion: torch.Tensor):
        with tnn.no_tf32():
            loss, metrics = vae_loss(vae, prev_motion, this_motion)
            return _apply(state, optimizer, loss, metrics)

    return step


def make_ar_train_step(model: BitwiseARModel, optimizer: AdamW, drop_path: bool = True,
                       seed: int = 1234) -> Callable:
    """Stage-2 step: (state, audio_chunk, prev_motion, this_motion[,
    style_motion]) -> (state, metrics); ``state.model`` is ``model``.

    ``drop_path`` applies stochastic depth with masks drawn from a
    generator on the model's device seeded from (``seed``, step): the same
    step draws the same masks, but not JAX's (its keys come from
    ``fold_in(PRNGKey(seed), step)``)."""
    device = model.pos_embed.device

    def step(state: TrainState, audio_chunk: torch.Tensor, prev_motion: torch.Tensor,
             this_motion: torch.Tensor, style_motion: Optional[torch.Tensor] = None):
        masks = None
        if drop_path:
            gen = torch.Generator(device=device).manual_seed((seed << 32) + state.step)
            masks = drop_path_masks(model.drop_path_rates(), audio_chunk.shape[0], gen)
        with tnn.no_tf32():
            loss, metrics = ar_loss(model, audio_chunk, prev_motion, this_motion,
                                    style_motion, drop_masks=masks)
            return _apply(state, optimizer, loss, metrics)

    return step
