"""Loss functions for the two training stages (counterpart of
``artalk_tpu/training/losses.py``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.ar_model import BitwiseARModel
from ..models.bitwise_vae import BitwiseVAE


def vae_loss(vae: BitwiseVAE, prev_motion: torch.Tensor, this_motion: torch.Tensor,
             dp_group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stage-1 tokenizer loss: L2 reconstruction of both windows + the BSQ
    entropy/commit aux terms, averaged over the two windows. With
    ``dp_group`` the motions are this rank's rows of the global batch: the
    codebook entropy is taken over the global batch (``bsq_entropy_loss``),
    so the mean of the ranks' losses is the global batch's loss."""
    recon_prev, recon_this, aux = vae.reconstruct(prev_motion, this_motion, dp_group)
    rec = (torch.mean((recon_prev - prev_motion) ** 2)
           + torch.mean((recon_this - this_motion) ** 2))
    aux_total = torch.sum(aux) / aux.shape[0]
    total = rec + aux_total
    return total, {"loss": total, "recon": rec, "aux": aux_total}


def ar_loss(model: BitwiseARModel, audio_chunk: torch.Tensor, prev_motion: torch.Tensor,
            this_motion: torch.Tensor, style_motion: Optional[torch.Tensor] = None,
            drop_masks: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stage-2 generator loss: teacher-forced per-bit cross-entropy.

    The VAE (frozen for this stage) encodes the motion pair into target bits
    and the audio encoder (frozen, as in the reference) gives the condition;
    both run without autograd, so neither is in the gradient. The AR model
    predicts every level's bits from the previous-window prefix and the
    audio condition under the VAR mask. Without ``style_motion`` the null
    style token conditions; with it the style encoder's token, with no
    extrapolation at train time (unlike ``encode_style``). ``drop_masks``
    turns DropPath on (``forward_logits``). Returns the mean NLL and the bit
    accuracy of the 2-way logits."""
    with torch.no_grad():
        prev_bits, this_bits = model.vae.encode_to_bits(prev_motion, this_motion)
        audio_cond = model.audio_condition(audio_chunk)
    if style_motion is None:
        style_cond = model.null_style_cond
    else:
        style_cond = model.style_cond_embed(model.style_encoder(style_motion))[:, None]
    prefix = model._prefix_from_bits(style_cond, prev_bits, tile=True)
    tokens = model.teacher_inputs(this_bits, style_cond)
    logits = model.forward_logits(tokens, audio_cond, prefix, drop_masks)  # (B, 181, C, 2)

    log_probs = torch.log_softmax(logits, dim=-1)
    target = this_bits.long()
    nll = -torch.gather(log_probs, -1, target[..., None])[..., 0]
    loss = torch.mean(nll)
    acc = torch.mean((torch.argmax(logits, dim=-1) == target).float())
    return loss, {"loss": loss, "bit_accuracy": acc}
