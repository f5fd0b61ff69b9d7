"""GAGAvatar: one-shot photoreal gaussian-splat head avatars.

Counterpart of ``artalk_tpu/models/gagavatar/``: DINOv2-B/14 + DPT feature
pyramid -> gaussian generators over the FLAME vertices and two camera-ray
planes -> the 32-channel splat (a CUDA kernel on the card,
``csrc/gsplat.cu``) -> StyleGAN2-CSFT super-resolution.
"""

from .avatar import GAGAvatar

__all__ = ["GAGAvatar"]
