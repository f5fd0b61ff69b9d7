"""Training of both model stages (counterpart of ``artalk_tpu/training``):
the BITWISE_VAE motion tokenizer (reconstruction + BSQ entropy/commit aux)
and the audio-conditioned AR generator (teacher-forced per-bit
cross-entropy under the VAR mask), on one device or a (dp, tp) mesh of them
(``parallel``), with the JAX package's optimizer (``trainer.AdamW``) and data
pipeline (``data``).
``python -m artalk_tpu_torch.training.train`` is the entry point.
"""

from .losses import ar_loss, vae_loss
from .trainer import TrainState, make_ar_train_step, make_vae_train_step

__all__ = [
    "ar_loss",
    "vae_loss",
    "TrainState",
    "make_ar_train_step",
    "make_vae_train_step",
]
