"""The port's ops: the CUDA kernels' wrappers with their plain versions, and
plain-torch helpers. ``flash_attention`` is exported as in the JAX package's
``ops/__init__.py``."""

from .attention import flash_attention

__all__ = ["flash_attention"]
