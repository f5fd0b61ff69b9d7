"""ARTalk on PyTorch and CUDA: speech -> mesh or gaussian-avatar video on NVIDIA Hopper.

A port of ``artalk_tpu`` (JAX/Pallas for the TPU), which stays beside it as
the reference. Module paths and public names mirror ``artalk_tpu`` so each
counterpart is easy to find; inside, the code is PyTorch: ``nn.Module``s
whose parameter trees mirror the JAX pytrees key for key (see
``utils/params.py``), an explicit ``device``, and ``torch.Generator``s for
random init.

This package imports torch, numpy and scipy, never jax: importing it must not
pull in ``artalk_tpu`` (whose ``__init__`` imports jax and configures a
compile cache). Numpy-only helpers are copied rather than imported.

Ported so far: the mesh path of ``python -m artalk_tpu_torch.cli -a <wav>`` in
every precision mode (exact, ``ARTALK_AR_FUSED=1``, ``ARTALK_AR_PRECISION=fast``
and ``int8``), ``serving.StreamPool``, the GAGAvatar path of
``python -m artalk_tpu_torch.cli -a <wav> --load_gaga -i synthetic_0``
(``models/gagavatar``; ``ARTALK_GAGA_PRECISION=fast|exact``), and every audio
encoder: wav2vec2 (``models/wav2vec``; ``Wav2VecConfig.use_flash_attention``),
HuBERT (``models/hubert``) and Mimi (``models/mimi``; ``"AUDIO_ENCODER":
"mimi"`` in ``config.json``), the FLAME landmarks, the debug renderers
(``models/renderer_extras``), the motion metrics (``evaluation``;
``python -m artalk_tpu_torch.evaluation``), and the serving surface: the HTTP
server (``python -m artalk_tpu_torch.server``), the jax-free checkpoint
converter (``python -m artalk_tpu_torch.convert_checkpoint``), top-k/top-p
sampled decode, the web UI (``app_gradio``; ``cli --run_app``), the
metrics registry (``utils/metrics``), training of both model stages
(``training``; ``python -m artalk_tpu_torch.training.train``), the
``torch.export`` of the window step (``export_model``) and multi-device
scaling on ``torch.distributed`` (``parallel``: the (dp, tp) device mesh,
the tensor-parallel sharding rules as DTensor placements, frame-parallel
rendering, multi-process jobs). Six hand-written CUDA kernels
carry them: the z-buffer rasterizer (``csrc/rasterizer.cu``), the AR block
stack (``csrc/ar_block_stack.cu``), the wav2vec2 encoder stack
(``csrc/encoder_block_stack.cu``), the 32-channel gaussian splat
(``csrc/gsplat.cu``), flash attention (``csrc/flash_attention.cu``) and the
splat prepass's int32 key sort (``csrc/sort.cu``); everything else on the
paths is plain PyTorch, and host media work (resampling, the Y4M writer) is
the native C++ runtime of ``runtime/``, built with g++. On the CPU every
kernel takes its plain version, which the tests (``python -m pytest
tests/test_torch_*.py``) hold against the JAX package.
``ROADMAP.md`` lists what is still to be ported.
"""

__version__ = "0.1.0"
