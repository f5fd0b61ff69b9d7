"""The port's ops: the CUDA kernels' wrappers with their plain versions, and
plain-torch helpers. ``flash_attention`` is exported as in the JAX package's
``ops/__init__.py``. Importing the package imports the seven kernel wrappers,
so that every kernel's library is declared (``_nvcc.kernel_libraries``) and
its launches listed (``_nvcc.launches``)."""

from . import (ar_block_stack, conv_frontend, encoder_block_stack, gsplat,  # noqa: F401
               rasterizer, sort)
from .attention import flash_attention

__all__ = ["flash_attention"]
