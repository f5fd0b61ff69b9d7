"""ARTalk on PyTorch and CUDA: the speech -> mesh-video path for NVIDIA Hopper.

A port of ``artalk_tpu`` (JAX/Pallas for the TPU), which stays beside it as
the reference. Module paths and public names mirror ``artalk_tpu`` so each
counterpart is easy to find; inside, the code is PyTorch: ``nn.Module``s
whose parameter trees mirror the JAX pytrees key for key (see
``utils/params.py``), an explicit ``device``, and ``torch.Generator``s for
random init.

This package imports torch, numpy and scipy, never jax: importing it must not
pull in ``artalk_tpu`` (whose ``__init__`` imports jax and configures a
compile cache). Numpy-only helpers are copied rather than imported.

Ported so far: the default path of ``python -m artalk_tpu_torch.cli -a <wav>``
(exact precision, XLA-path modules, mesh renderer). The z-buffer rasterizer is
a hand-written CUDA kernel (``csrc/rasterizer.cu``); everything else on the
path is plain PyTorch. ``ROADMAP.md`` lists what is still to be ported.
"""

__version__ = "0.1.0"
