#!/usr/bin/env python3
"""GPU smoke run of artalk_tpu_torch: builds the CUDA kernels, checks each
against its plain version, replays the seed-0 goldens, and drives the
speech -> mesh-video path at the production width in every precision mode,
StreamPool, the HTTP server, sampled decode, the speech -> gaussian-splat
avatar (GAGAvatar) path, the alternate audio encoders (flash-attention
wav2vec2, HuBERT, Mimi), the instance-key sort of the splat prepass, the
debug point and texture renderers, the motion metrics, both training
stages (and the train CLI), the window-step export, the parallel package
(a device mesh on NCCL, sharded decode, training and frame-parallel render),
the port's bench and its measurement tools (the StreamPool curve after a
check of the pool at B = 32, the HTTP load test, the stage profilers), and
the checkpoint and video modules (npz and sharded save / restore, the
video writer's two pixel formats read back).

    python3 chip_smoke.py        # from the repository root, on a machine with one NVIDIA GPU

Phases (any failure raises and exits non-zero; no phase catches its own):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the seven kernels from artalk_tpu_torch/csrc/ (one nvcc each, all at
     once) and print the seconds and nvcc's register / shared-memory report
     (up to 16 lines each);
  3. kernel vs plain version on the synthetic FLAME head at 512x512, 4 frames:
     face ids agree on >= 99.9 % of pixels, background exactly, zbuf to
     rtol 1e-4 where both hit; the setup kernel's planes equal face_planes
     on the card and its cull and chunk boxes the plain setup's, bit for
     bit; ms per frame by CUDA events of rasterize end to end, of the setup
     and the raster kernel alone, and of the plain version; the (pixel, face)
     pairs evaluated a frame by the chunk design and by the per-face cull;
  4. golden replay: the small config's seed-0 params
     (tests/fixtures/torch_golden_small_params.npz) on the card, 3 windows,
     against tests/fixtures/golden_small.npz: at most 1 of the 168 code bits
     may differ (the card sums in another order than XLA on the CPU);
  5. full width: ARTAvatarInferEngine(device="cuda") with the production
     ModelConfig and random seed-0 weights on 10 s of seeded noise:
     inference -> (250, 106) finite; stream over 4 s chunks equals the raw
     offline decode to atol 1e-4; rendering(shape_id="mesh") at 512x512 gives
     250 frames; the rasterizer kernel launched at least 250 times on the way;
     the metrics registry (utils/metrics.GLOBAL_METRICS), reset before one
     more inference, stream and rendering, holds the JAX engine's stage names
     with 3 windows and 250 frames, and a torch.profiler trace of that
     inference (utils/metrics.device_trace) holds the inference.generate
     range;
  6. AR block stack vs ar_block_stack_plain at the production geometry (12
     blocks, d 768), every level at its real cache offset, B = 1 and B = 5,
     float32 / bf16 / int8 packs: float32 feats within 1e-4 and k/v within
     1e-5, bf16/int8 feats within 3e-3 and k/v within 2 bf16 ulps of their
     largest value; each row of B = 5 within 1e-6 of the same row run alone;
     for bf16/int8 the first block alone within ONE_BLOCK's limits, which
     two planted faults (activations left unrounded, int8 fc2 with one scale
     per channel) must break; the grid barriers a launch passes at each
     level (counted by the kernel) beside the earlier CUDA-core design's;
     then the int8 pack at the stream cells' batches (B = 140 and 408, every
     level, inputs drawn on the card): feats within AR_FEATS_TOL and k/v
     within 2 bf16 ulps of the plain version, three sampled rows within
     1e-6 of themselves launched alone, and a planted fault (the splits that
     a CTA adds itself, added last first) breaking that row rule;
  7. encoder block stack vs encoder_block_stack_plain at (1, 199, 1024), 24
     layers: float32 within atol = rtol 1e-4, bf16 and int8 0.04; two
     windows in one launch equal each window alone exactly; for bf16/int8 the
     first layer alone as in phase 6; then the int8 pack at the stream cell's
     140 windows against the plain version within ENCODER_TOL, three sampled
     windows within 1e-6 of themselves alone, and the planted fold-order
     fault breaking that rule;
  8. full width per mode (ARTALK_AR_FUSED=1, fast, fast + fused, int8), each on
     a fresh engine: inference -> (250, 106) finite, stream equals offline to
     1e-4, 5 AR launches and 1 encoder launch per window in the fused modes
     and none in fast alone, 8 conv-front launches per window in the bf16
     modes (fast, fast + fused, int8) and none in the float32 ones (phase 5
     too), and the share of window-0 code bits that agree with the exact
     mode (>= 0.999 float32 fused, >= 0.9 otherwise);
  9. StreamPool, int8, capacity 4: two sessions, one joining late, with idle
     ticks; each session's motions equal the same session run alone in a pool
     of the same capacity to 1e-5, and its decoded code bits agree with its
     audio streamed alone through engine.stream at batch 1 on >= 0.97 of
     each window, which two planted faults (rows crossed, an idle row's
     carry lost) must break;
 10. times by CUDA events at the main path's shapes: each block-stack kernel
     and its plain version per pack (per level and per window), the encoder's
     library yardstick (torch.nn.TransformerEncoder, float32 without TF32 and
     bf16), and each kernel's bound (the larger of bytes over 3.35 TB/s and
     operations over 989 TFLOP/s bf16; the float32 packs of both stacks,
     which run 3xTF32, at the cheaper of three TF32 products at 495 TFLOP/s
     and one fp32 product at 67, with the fp32-rate bound printed beside
     it), per AR level beside the level's bound, with the share of each
     stage of the AR kernel (row passes, q/k/v, attention, projection, fc1,
     fc2) as its CTA 0 sees it; the rasterizer's
     bound is computed in phase 3 (each face tested against the pixels of
     its own bounding box);
 11. the GAGAvatar path at full width, per ARTALK_GAGA_PRECISION (fast: bf16 SR
     and bf16 splat colors; exact: float32): ARTAvatarInferEngine(load_gaga=True)
     with the production networks (DINOv2 ViT-B/14 + DPT, StyleUNet 512) on
     random seed-0 weights, inference of phase 5's audio, then
     rendering(shape_id="synthetic_0") -> 250 frames with the splat kernel
     and the sort kernel each launched at least 250 times; phase 5's motions
     rendered in one call equal the same rendered in two halves (the
     forehead EMA resumed) exactly; fast agrees with exact within
     GAGA_FAST_LSB;
 12. splat kernel vs splat_tiles_plain on two full-width scenes (bench.py's
     180,255-gaussian scene, seed 3, and the synthetic_0 avatar's gaussians at
     the neutral pose), with float32 and bf16 colors: max abs error within
     SPLAT_TOL of the scene's largest |color| and all but SPLAT_FAR_SHARE of
     the values within SPLAT_NEAR of it, and faults planted in the
     plain version (each tile's order reversed; the 1/255 alpha cut dropped;
     the MAX_RX / MAX_RY emission clamp dropped, where it changes the lists;
     on the avatar scene, each 16x16 block composited from the lists culled
     by the plain culling rule with its box one pixel narrower) must break
     that limit;
 13. GAGAvatar times by CUDA events on the avatar scene, per precision: the
     splat kernel, its plain version, the prepass (and the same prepass with
     torch.sort in place of the sort kernel), the SR and the whole frame,
     and the kernel's bound (the larger of bytes over 3.35 TB/s and the
     alpha evaluations and composites the pixels need before they stop over
     67 TFLOP/s fp32), beside the alpha evaluations before the pixels stop
     of the tile design and of the kernel's per-block culled lists (by the
     plain rule);
 14. flash-attention kernel vs flash_attention_plain, float32 and bf16, at
     the wav2vec (1, 16, 199, 64) and HuBERT (1, 12, 199, 64) sites, on
     tests/test_attention.py's bias and padding cases, a wholly masked row
     (0, not NaN) and the (1, 16, 4096, 64) sweep: float32 within
     FLASH_F32_TOL, bf16 within 1 bf16 ulp of the largest value; two faults
     planted in a plain copy of the kernel's tile loop (the online rescale
     alpha dropped; the ragged tile's key mask dropped) must break the
     float32 limit; gradients through the kernel's autograd path against
     the plain version's within 3e-5;
 15. the flash wav2vec2 path at full width (Wav2VecConfig(use_flash_attention=
     True), otherwise the production config), per FLASH_MODES (exact, fast,
     ARTALK_AR_FUSED=1) on phase 5's audio: inference -> (250, 106) finite,
     stream equals offline to 1e-4, rendering(shape_id="mesh") -> 250 frames
     (exact and fast), the flash kernel launched 24 times per window (once per
     layer) and 0 times in the fused mode, whose encoder block stack takes
     the layers; window-0 code bits agreeing with phase 5's on
     FLASH_BITS_AGREE;
 16. HuBERT (hubert_base_config: 12 x 768, 12 heads, post-LN) at full width on
     the first window of phase 5's audio, with and without frame_num, flash on
     and off on the same weights: 12 flash launches per call with it, 0
     without, the two within HUBERT_FLASH_TOL;
 17. the Mimi path at full width (ARConfig(audio_encoder="mimi"), the default
     MimiEncoderConfig) per MIMI_MODES (exact, int8): inference finite, stream
     equals offline to 1e-4, 5 AR launches per window in int8 and no encoder
     or flash launch; window 0's RVQ codes on the card agree with the same
     weights run on the CPU on MIMI_CODES_AGREE, and the first code that
     differs in each frame's residual chain is a near tie (its distance gap
     under MIMI_TIE of the distance);
 18. flash-attention times by CUDA events at both sites and over
     tools/bench_flash_attention.py's sweep (B 1, H 16, hd 64, 256 ... 4096):
     the wrapper under no_grad (the direct launch), the kernel alone, the
     plain version and the library yardstick
     torch.nn.functional.scaled_dot_product_attention (TF32 off; the backend
     its dispatcher picks), and the bound (flash_bound: the larger of q, k, v
     and out over 3.35 TB/s and the products at the cheapest rate that keeps
     the function's precision: bf16 three bf16 products at 989 TFLOP/s,
     float32 three TF32 products per product at 495 TFLOP/s); a kernel faster
     than its bound fails;
 19. the sort kernel (an LSD radix sort) vs sort_keys_plain (the bitonic
     network) and torch.sort, bit for bit (0 mismatches), on the instance
     keys of the synthetic_0 avatar's frame and of bench.py's splat scene, and
     on random full-range int32 keys with duplicates, INT32_MIN and INT32_MAX
     at SORT_SIZES; one wrapper launch per call with n > 0, the CUDA launches
     the entry point counts printed;
 20. the sort on the GAGAvatar path: phase 11 counts at least one sort launch
     per frame, and one avatar frame's prepass (inst, offsets) equals the
     same frame's prepass with torch.sort swapped in for the kernel;
 21. the debug renderers at full width on FLAME vertices of phase 5's
     motions: PointRenderer(image_size=512) (sort and splat launches, one
     each per frame; output finite, in [0, 255], covering pixels) and
     TextureRenderer at 512x512 (planar UVs of the template, a seeded 256^2
     texture, seeded SH lights, a flame mask; 2 z-buffer launches per frame,
     masks non-empty, the face mask inside masks_all), each held to the same
     inputs run on the CPU through the plain versions: points within 1e-4 x
     255, texture masks equal but at edge ties and images within 1e-4
     elsewhere (the tolerances of the CPU tests);
 22. evaluate_motion on the card (phase 5's exact motions against phase 8's
     int8 motions, with the audio) equals a CPU run: the integer keys exactly,
     the metrics to rtol 1e-5 and atol 1e-9; the LVE of a clip against itself
     is 0;
 23. sort times by CUDA events at the avatar frame's key count and at 2^21:
     the kernel alone, through its wrapper, sort_keys_plain and torch.sort
     (the library yardstick, never called by the port), the bound (8 bytes a
     key over 3.35 TB/s) and the CUDA launches per sort (at most
     SORT_MAX_LAUNCHES); torch.profiler's device time of each of the
     kernel's CUDA kernels per sort, at both sizes;
 24. TF32: tests/tf32_probe.py in a fresh `python3 -c` process that imports
     only artalk_tpu_torch.models.hubert (TF32 on, torch's default): HuBERT
     base and wav2vec2's conv frontend equal the same calls after
     full_float32() within TF32_PROBE_TOL, and the caller's flags are back
     after the calls.
 25. the HTTP server (artalk_tpu_torch.server.MotionServer) on phase 9's int8
     engine, capacity 2, at most 4 sessions, on 127.0.0.1 (run right after
     phase 9): /healthz names the card; session a posts a warm-up and a timed
     4 s chunk alone, then a and b post two chunks each from two threads at
     once, each pair riding one pool step; every session's rows equal the
     same chunks through a fresh StreamPool of capacity 2 to 1e-5 (phase 9's
     isolation rule), with 5 AR and 1 encoder launch per tick; 413 for a
     chunk over one window, 409 for a second chunk in flight, 404 for an
     unknown session or route, auto-grow to 4 sessions and then 503;
     /v1/motion on phase 5's audio equals engine.inference to 1e-5;
     /v1/video?shape_id=mesh returns a 250-frame 512x512 video with at least
     250 rasterizer launches; ms per chunk request at 1 and at 2 sessions
     and of /v1/motion by the host clock (the tick's SERVER_TICK_MS
     aggregation included);
 26. sampled decode on phase 5's exact engine (run right after phase 5) and
     on phase 9's int8 engine (after phase 25): generate with top_k=1,
     top_p=0 equals the greedy generate exactly; one generator seed repeats
     its motions, seeds 0 and 1 differ; every bit that _head_bits samples on
     seeded features lies inside topk_topp_mask of the same logits; in int8,
     5 AR launches and 1 encoder launch a window.
 27. stage-1 training (training/trainer.make_vae_train_step) of the
     production VAE on a batch of 8 from train.py --synthetic's clips: a
     warm-up step (the schedule's step 0, at learning rate 0) under torch's
     FLOP counter, then TRAIN_STEPS steps at TRAIN_LR timed one by one by
     CUDA events: losses finite and the last below the first; ms per step,
     peak memory (max_memory_allocated) and the step's bound (the larger of
     the counted matmul / convolution / attention operations, forward and
     backward, at 67 TFLOP/s fp32, as TF32 is off, and AdamW's 7 x 4 B a
     parameter at 3.35 TB/s); no kernel launch;
 28. stage-2 training of the production ModelConfig() (489.5 M parameters)
     likewise, with style clips and DropPath; the exact path launches no
     kernel;
 29. one AR step at batch 1, DropPath off, on the card and with the same
     weights and batch on the CPU: loss and grad_norm within TRAIN_CPU_RTOL
     (and the count of target and prefix code bits that differ); the same
     card step with TF32 let on (the control) must fall outside them;
 30. the encoder-stack kernel on the training path: an AR step at batch 1
     with fused_ar (float32 pack) and one at batch 8 with bf16_audio +
     fused_ar each launch it once (the kernels line's train_launches). The
     launch's own output is held against encoder_block_stack_plain of the
     launch's own input and pack within ENCODER_TOL (atol + rtol |want|),
     and the fused condition against the unfused one of the same precision
     (bf16_audio kept) on the same audio within ENCODER_TOL likewise; the
     float32 step's loss is within FUSED_LOSS_MARGIN times the first-order
     bound of ENCODER_TOL["f32"] (|d loss / d condition| times the
     area-resized atol + rtol |features|) of the exact step's, the bf16
     step's loss finite;
 31. python -m artalk_tpu_torch.training.train --stage ar --synthetic
     --steps 2 --eval on the card (train.main): no kernel launch, the
     evaluation of clip 0 finite over 500 frames; the saved npz loads into
     ARTAvatarInferEngine(params=...), whose inference of phase 5's audio is
     (250, 106) and finite;
 32. python -m artalk_tpu_torch.export_model --checkpoint <phase 31's npz>
     --device cuda (export_model.main, the production ModelConfig()): the
     saved program, reloaded, runs two windows of phase 5's audio with the
     carry threaded through and equals bit for bit the eager window step of
     the model built from the params.npz written beside it;
 33. the parallel package on NCCL at world 1 (one card holds one rank):
     initialize_multihost on a free localhost port, make_mesh() -> (dp=1,
     tp=1), shard_params on a fresh seed-0 ModelConfig() AR model: its
     exact window-0 code bits equal phase 5's and, in the int8 mode (packs
     of the whole weights), phase 8's, with the int8 mode's 5 AR and 1
     encoder launches counted; its
     exact inference of phase 5's 3 windows in ms per window against the same
     model before sharding (DTensor's dispatch cost), motions within 1e-4;
     one AR step at batch TRAIN_BATCH, DropPath on, through the mesh-aware
     trainer against the plain step from the same weights and batch: loss
     and grad_norm within TRAIN_CPU_RTOL; render_frames_dp of phase 5's 250
     frames equal to renderer(verts) bit for bit with 250 rasterizer
     launches. The group is destroyed at the end. The kernels line's
     parallel_launches are each kernel's launches (by pack) over the counted
     windows and the render; the phase must launch no gsplat, sort or
     attention kernel.
 34. the port's bench (artalk_tpu_torch.bench.run, every section, BENCH_REPEATS
     repeats; the sections' launch checks included): every key of every
     section finite and positive, no errors, every _mfu and _membw_frac in
     (0, 1], the card's name and power limit in its device object; the dict
     printed on one line, the seconds it took, and each kernel's launches
     over the run (the rasterizer, both block stacks, the splat and the sort
     launched at least once); then the int8 packs at the stream cells'
     shapes (the AR stack per level at B = 1, 140 and 408, the encoder at 1
     and 140 windows) beside their bounds at that batch, and the block
     stacks' launches by pack and products folded (ops/_nvcc.launches).

 35. the measurement tools (artalk_tpu_torch/tools/): first, StreamPool at
     B = 32 (3200 rows a level at pn 100) right after phase 5 on its exact
     engine and right after phase 9 on its int8 engine: 32 sessions with
     their own audio stepped together twice, each also streamed alone at
     batch 1. Exact: each window's decoded code bits agree with the batch-1
     stream on >= POOL_BITS_AGREE. int8: the mean agreement with the
     batch-1 streams >= POOL_BITS_AGREE; each window >= POOL_BITS_AGREE
     against its batch-1 stream when both take the audio condition
     computed alone at batch 1; each session equal to itself stepped alone
     in a pool of 32 (bits >= POOL_BITS_AGREE, motions to 1e-5); both
     kernels at B = 32 with the int8 packs (the encoder's with the bf16
     pack too): each row within 1e-6 of the row alone, the launch against
     its plain version on the same inputs within phase 6 and 7's limits
     (AR feats AR_FEATS_TOL, k/v 2 bf16 ulps; encoder ENCODER_TOL); the
     first op of the window step whose B = 32 row differs from the row
     stepped alone printed. Rows crossed must fail every rule held; 10 AR
     and 2 encoder launches in int8, none in exact. Then, after phase 34,
     each tool's main at a reduced depth, its output echoed under "[tools]
     <name> |": bench_streampool --sizes 1,8,32 --iters 3 (int8), and
     --sizes 1,4 --iters 1 with float32 packs (ARTALK_AR_FUSED=1: the
     kernels at B = 1 only, none at B = 4); bench_http_serving --clients 1
     4 --windows 3 (int8); profile_pipeline --iters 3 (exact: the
     rasterizer alone); profile_encoder --iters 3 --fused; profile_gsplat
     --iters 5 (S3 equal to prepass bit for bit); profile_gaga --k 8. Each
     tool's lines parse with finite times, and its kernel launches, the
     block stacks' counted by pack (ops/_nvcc.launches), equal what its run
     makes (bounded for the HTTP ticks, which the clients' timing decides);
     the kernels line lists them under "tool_launches", and the B = 32
     kernel checks under "wide".
 36. the checkpoint and video modules (utils/checkpoint.py, utils/video.py)
     at full width: the seed-0 production engine's model through
     save_params_npz (the checkpoint writer storing the arrays as they are:
     deflating 2 GB on one host thread would take 105 s, and
     tests/test_torch_checkpoint.py holds the deflated form) and
     load_params(like=) into a model of NaNs, every tensor equal, the
     restored model's exact and int8 window-0 code bits equal to phases 5
     and 8's (5 AR and 1 encoder launch in int8); the same model sharded
     on a (1, 1) NCCL mesh through save_params_sharded
     (torch.distributed.checkpoint) and load_params_sharded into a sharded
     NaN model, a plain one and, after the group is destroyed, a plain one
     with no group, each equal; the seconds of each save and load beside
     the card's name and power limit; then 1 s of phase 5's audio through
     the engine on the restored model, its 25 mesh frames rendered (25
     rasterizer launches) and written by write_video as yuv420
     planes and as RGB, each read back by the port's readers (read_y4m +
     yuv420p_to_rgb + the WAV, or read_video_npz): 25 frames, 25 fps, 16 kHz
     audio of 16 000 samples, RGB within 3 of the rendered frames on 2x2-
     constant blocks; get_video_info and read_all_video_frames read both
     where PyAV is installed and raise their RuntimeError where it is not.
     The kernels line's checkpoint_launches are each kernel's launches (by
     pack) over the two windows, the inference and the render; the phase
     must launch no gsplat, sort or attention kernel.
 37. (run after phase 10) the wav2vec2 conv front's kernels
     (ops/conv_frontend.py) at XLS-R widths in bf16, B = 1 and 140: each of
     the eight layers fed the plain version's own input within
     CONV_FRONT_LAYER (shares equal and within 1 ulp, ulps of the largest
     value), the whole front within CONV_FRONT_REL of its largest value
     (the eager path's own distance from the plain version printed beside
     it), 8 launches a call, three rows of B = 140 equal to themselves run
     alone; then CUDA-event times of the kernels (a call and each launch),
     the eager path (cuDNN's float32 convolution of the same bf16 values),
     the plain version and the bound (3.2 TFLOP a 140-window call at 989
     TFLOP/s, each launch's input and output in bf16 at 3.35 TB/s), and a
     profile of the B = 140 call.

It imports nothing of JAX. The line before the last is a JSON object with the
kernels' numbers; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import contextlib
import ctypes
import dataclasses
import importlib
import io
import json
import re
import math
import os
import socket
import subprocess
import sys
import threading
import time
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from artalk_tpu_torch import bench
from artalk_tpu_torch import config as tcfg
from artalk_tpu_torch import evaluation
from artalk_tpu_torch.engine import ARTAvatarInferEngine
from artalk_tpu_torch.models.flame import FlameModel
from artalk_tpu_torch.models.gagavatar.avatar import CAM_PARAMS, NUM_FLAME_VERTS
from artalk_tpu_torch.models import mimi as tmimi
from artalk_tpu_torch.models import nn as tnn
from artalk_tpu_torch.models import wav2vec as wav2vec_mod
from artalk_tpu_torch import export_model
from artalk_tpu_torch.models.ar_model import BitwiseARModel, WindowState, topk_topp_mask
from artalk_tpu_torch.models.bitwise_vae import BitwiseVAE
from artalk_tpu_torch.models.hubert import HubertEncoder
from artalk_tpu_torch.models.nn import no_tf32
from artalk_tpu_torch.models.renderer import MeshRenderer
from artalk_tpu_torch.models.renderer_extras import PointRenderer, TextureRenderer
from artalk_tpu_torch.ops import ar_block_stack as ar_stack
from artalk_tpu_torch.ops import attention
from artalk_tpu_torch.ops import conv_frontend as conv_front
from artalk_tpu_torch.ops import encoder_block_stack as enc_stack
from artalk_tpu_torch.ops import gsplat
from artalk_tpu_torch.ops import rasterizer
from artalk_tpu_torch.ops import sort
from artalk_tpu_torch.ops._nvcc import kernel_libraries, launches
from artalk_tpu_torch.ops.colorspace import rgb_to_yuv420p
from artalk_tpu_torch.ops.resample1d import resize_area
from artalk_tpu_torch.parallel import make_mesh, shard_params
from artalk_tpu_torch.parallel.distributed import initialize_multihost
from artalk_tpu_torch.parallel.render import render_frames_dp
from artalk_tpu_torch.parallel.sharding import whole
from artalk_tpu_torch.training import losses as train_losses
from artalk_tpu_torch.training import train, trainer
from artalk_tpu_torch.utils.assets import load_or_synthesize_flame
from artalk_tpu_torch.utils.metrics import GLOBAL_METRICS, device_trace
from artalk_tpu_torch.utils import roofline
from artalk_tpu_torch.utils.checkpoint import (load_params, load_params_sharded, save_params_npz,
                                               save_params_sharded)
from artalk_tpu_torch.utils.params import load_params_npz, params_from_flat
from artalk_tpu_torch.utils.roofline import (FP32_FLOP_PER_S, HBM_BYTES_PER_S,
                                             SPLAT_COMPOSITE_FLOP, SPLAT_EVAL_FLOP)
from artalk_tpu_torch.utils.timing import cuda_ms
from artalk_tpu_torch.utils.video import (get_video_info, read_all_video_frames, read_video_npz,
                                          read_y4m, write_video, yuv420p_to_rgb)

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
IMAGE = 512
MODES = {  # environment of each precision mode of phase 8
    "fused": {"ARTALK_AR_FUSED": "1"},
    "fast": {"ARTALK_AR_PRECISION": "fast"},
    "fast+fused": {"ARTALK_AR_PRECISION": "fast", "ARTALK_AR_FUSED": "1"},
    "int8": {"ARTALK_AR_PRECISION": "int8"},
}
PACK_OF_MODE = {"fused": torch.float32, "fast+fused": torch.bfloat16, "int8": torch.int8}
# Limits of the bf16/int8 block stacks against their plain versions. Through
# the whole stack, a bf16 rounding that falls the other way in one operand is
# amplified until it is as large as a real fault would be, so the whole-stack
# limits (max abs error; encoder atol = rtol) catch gross faults only, and the
# first block alone, where that noise is still small, is held to ONE_BLOCK:
# rms error over the rms of the block's contribution, and for the AR stack the
# share of k/v values that differ at all. Each limit lies between the
# kernel's reading on the card and the smallest planted fault's (NVIDIA H100
# 80GB HBM3, 700 W: AR rms 2.2e-4 against 1.6e-3, k/v changed 0.04 % against
# 43 %; encoder rms 6.1e-4 (bf16) against 2.4e-3, and 3.9e-4 (int8) against
# 1.1e-3). See PERF.md, PR 2.
AR_FEATS_TOL = 3e-3
ENCODER_TOL = {"f32": 1e-4, "bf16": 0.04, "int8": 0.04}
ONE_BLOCK = {"ar/bf16": {"rms": 6e-4, "changed": 0.01},
             "ar/int8": {"rms": 6e-4, "changed": 0.01},
             "encoder/bf16": {"rms": 1.2e-3},
             "encoder/int8": {"rms": 6.5e-4}}
# least share of a window's code bits on which a StreamPool session agrees
# with the same audio streamed alone at batch 1
POOL_BITS_AGREE = 0.97
# GAGAvatar precision modes (phase 11) and the splat colors each uses
GAGA_MODES = {"fast": "bf16", "exact": "f32"}
# splat kernel vs its plain version, max abs error over the scene's largest
# |color|: a transmittance that rounds the other way at T_EPS moves a pixel's
# stop by one gaussian, at most T_EPS (1e-4) of the largest color. Such a
# pixel is rare, so all but SPLAT_FAR_SHARE of the values must also lie
# within SPLAT_NEAR of the largest color (NVIDIA H100 80GB HBM3, 700 W: max
# 1.2e-6, no value beyond 1e-5; PERF.md, PR 3).
SPLAT_TOL = 2e-4
SPLAT_NEAR, SPLAT_FAR_SHARE = 1e-5, 1e-4
# fast vs exact frames (uint8 yuv420p): most and mean |difference| in LSB
# (NVIDIA H100 80GB HBM3, 700 W: max 1, mean 0.135; PERF.md, PR 3)
GAGA_FAST_LSB = {"max": 4, "mean": 0.5}
# flash attention vs flash_attention_plain: float32 within tests/test_attention.py's
# atol (both compute in float32; the sums run in another order), bf16 within
# 1 bf16 ulp of the largest value (a float32 result rounded once on each side)
FLASH_F32_TOL = 2e-5
FLASH_TILE = 64      # keys per tile of csrc/flash_attention.cu's row-block kernel
FLASH_SWEEP = (256, 512, 1024, 2048, 4096)   # tools/bench_flash_attention.py's lengths
FLASH_MODES = {"exact": {}, "fast": {"ARTALK_AR_PRECISION": "fast"},
               "fused": {"ARTALK_AR_FUSED": "1"}}
# least share of the flash path's window-0 code bits agreeing with phase 5's
# exact bits: float32 paths differ from it at rounding level only (as phase
# 8's fused mode), fast rounds to bf16 (as phase 8's fast mode)
FLASH_BITS_AGREE = {"exact": 0.999, "fast": 0.9, "fused": 0.999}
# HuBERT with the flash kernel vs the plain softmax, max abs difference of the
# post-LN outputs (float32; unit-scale after every LayerNorm)
HUBERT_FLASH_TOL = 1e-4
MIMI_MODES = {"exact": {}, "int8": {"ARTALK_AR_PRECISION": "int8"}}
# Mimi codes on the card vs the CPU: a flip in a frame's residual chain
# changes the residual of every later stage, so the share counts whole
# chains; each chain's first flip must be a near tie, its squared-distance
# gap under MIMI_TIE of the distance (float32 on both sides)
MIMI_CODES_AGREE = 0.9
MIMI_TIE = 1e-4
# random key counts of phase 19: both sides of the bitonic network's 2048-key
# tile and of the radix kernel's 3840-key tile, a ragged million, and the
# padded sizes of the avatar frame (2^20) and of JAX's production budget (2^21)
SORT_SIZES = (0, 1, 2047, 2048, 2049, 3839, 3840, 3841, 1_000_003, 1 << 20, 1 << 21)
SORT_MAX_LAUNCHES = 13   # CUDA launches a sort may take (csrc/sort.cu takes 6)
# phase 21: frames rendered by the debug renderers, the point renderer's
# orbit distance (the 0.22-tall head fills about half of the 60-degree view),
# its tolerance against the CPU (the splat's 1e-4 on the x 255 scale; the
# stops of the kernel and the plain version differ by at most T_EPS = 1e-4 of
# the largest color), and the texture renderer's camera (pytorch3d R =
# diag(-1, 1, -1), T = (0, 0, 2)) and image tolerance off the masks' edge
# ties, both as in tests/test_torch_renderer_extras.py
DEBUG_FRAMES = 2
POINT_DIST = 0.4
POINT_TOL = 1e-4 * 255
TEXTURE_CAM = np.array([[-1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, -1.0, 2.0]],
                       np.float32)
TEXTURE_TOL = 1e-4
# phase 22: evaluate_motion's float metrics on the card against the CPU (LVE
# is about 6e-5 there, FDD smaller; the measured gap 2.1e-10, PERF.md, PR 5);
# the integer keys must be equal
EVAL_RTOL, EVAL_ATOL = 1e-5, 1e-9
# phase 24: HuBERT in a fresh process with TF32 left on by default against the
# same call after full_float32(): the port's convolutions turn TF32 off, so
# only a float32 algorithm chosen otherwise remains (rounding level); TF32
# convolutions differ by about 1e-3
TF32_PROBE_TOL = 1e-5
# phase 25: the server's aggregation window before each pool step, long enough
# that two chunks posted at once from two threads ride one step
SERVER_TICK_MS = 20.0
# phase 5's registry check: the JAX engine's names (artalk_tpu/engine.py)
REGISTRY_STAGES = ("inference.generate", "inference.postprocess", "stream.window_step",
                   "render.flame_verts", "render.rasterize")

# phases 27-32, the training slice: batch and timed steps of each stage, and
# the learning rate after the warm-up step (the schedule's step 0, at lr 0).
# Without the warm-up of train.py's schedule Adam's first updates move every
# weight by about the learning rate: at the production width the AR loss
# rose at 1e-3 and 1e-4 (0.750 -> 1.85, -> 1.11) and at 3e-5 fell only
# after two steps; at 1e-5 both stages fall from the first step (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md, section 6)
TRAIN_BATCH = 8
TRAIN_STEPS = 4
TRAIN_LR = 1e-5
# phase 29: an AR step at batch 1 on the card against the same step on the
# CPU, both float32 with TF32 off: relative difference of loss and grad_norm.
# Sound runs read 8.8e-8 - 1.6e-7 (loss) and 7.7e-8 - 9.0e-8 (grad_norm);
# the control, the card step with TF32 on, 1.7e-4 and 1.4e-4 (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md, section 6). A target bit that flips between the
# two would move the mean NLL by about 1e-4 of itself.
TRAIN_CPU_RTOL = {"loss": 1e-6, "grad_norm": 1e-5}
# phase 30: the fused float32 encoder's loss against the exact step's within
# this multiple of the first-order bound from ENCODER_TOL["f32"]
FUSED_LOSS_MARGIN = 2.0
# phase 34: measurements per bench section (a spread prints, the phase stays short)
BENCH_REPEATS = 2
# phase 35: the widest pool of the tools' curve, and each tool's reduced run:
# (tool, argv, precision environment)
POOL_WIDE = 32
# the serving batches of the stream cells (benchmark/: stream-int8-http runs
# 140 sessions, stream-mimi-int8-http 408): both block stacks' int8 packs at
# these batches in phases 6 and 7 (AR at both, the encoder at 140), each
# with three sampled rows (the first, the middle, the last) launched alone
SERVING_AR_BATCHES = (140, 408)
SERVING_ENCODER_BATCH = 140
# the conv front's kernels against the plain version (phase 37): each layer
# fed the plain version's input, and the whole front; batches 1 and the
# stream cell's 140
CONV_FRONT_BATCHES = (1, 140)
# per layer: shares of elements equal and within 1 ulp, and the largest
# difference in ulps of the layer's largest |value| (tests/test_torch_cuda.py's
# CONV_LAYER_*); the whole front's largest difference over its largest |value|
CONV_FRONT_LAYER = {"equal": 0.999, "within_1ulp": 0.9995, "ulps_of_max": 4}
CONV_FRONT_REL = 0.03
TOOL_RUNS = (
    ("bench_streampool", ["--sizes", "1,8,32", "--iters", "3"],
     {"ARTALK_AR_PRECISION": "int8", "ARTALK_AR_FUSED": "1"}),
    ("bench_streampool", ["--sizes", "1,4", "--iters", "1"], {"ARTALK_AR_FUSED": "1"}),
    ("bench_http_serving", ["--clients", "1", "4", "--windows", "3"], {}),
    ("profile_pipeline", ["--iters", "3"], {}),
    ("profile_encoder", ["--iters", "3", "--fused"], {}),
    ("profile_gsplat", ["--iters", "5"], {}),
    ("profile_gaga", ["--k", "8"], {}),
)
PACKS = tuple(ar_stack.PACK_NAMES.values())
# a timed line of a tool: its label, then ms (ms/tick, ms/chunk)
TOOL_LINE = re.compile(r"^\s*(\S.*?)\s+(-?[\d.]+|nan|inf) ms(/tick|/chunk)?\b", re.M)

# tests/test_ar_model.py's CFG, the config behind tests/fixtures/golden_small.npz
GOLDEN_SMALL_CFG = tcfg.ModelConfig(
    ar=tcfg.ARConfig(depth=3, num_heads=4, prev_ratio=1, embed_dim=64, style_dim=16,
                     audio_dim=32),
    vae=tcfg.VAEConfig(motion_dim=12, code_dim=8, depth=2, num_heads=4, hidden_dim=32,
                       patch_nums=(1, 2, 4)),
    wav2vec=tcfg.Wav2VecConfig(
        conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3),
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4),
)


def phase_device() -> str:
    info = bench.device_info(torch.device("cuda"))
    smi = f"{info['name']}, {info['power_limit']}"
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


# the launch counter's kernels (ops/_nvcc.launches) under the names this smoke
# reports them by
SHORT = {"ar_block_stack": "ar", "encoder_block_stack": "encoder", "flash_attention": "flash"}
_ZERO: dict = {}


def zero_launches() -> None:
    """Count every kernel's launches from here (``since_zero``)."""
    global _ZERO
    _ZERO = launches()


def since_zero() -> dict:
    """Each key of the launch counter since the last zero_launches(), its
    kernel under SHORT's name: "ar", "ar/int8", "ar/folded", "sort/cuda"."""
    out = {}
    for key, n in launches().items():
        kernel, _, part = key.partition("/")
        out["/".join(filter(None, (SHORT.get(kernel, kernel), part)))] = n - _ZERO.get(key, 0)
    return out


def launch_counts() -> dict:
    """The decode-path kernels' launches since the last zero_launches()."""
    n = since_zero()
    return {k: n[k] for k in ("ar", "encoder", "flash")}


def phase_build() -> None:
    """All seven libraries at once: nvcc runs in a subprocess each."""
    t0 = time.perf_counter()
    libs = kernel_libraries()
    with ThreadPoolExecutor(len(libs)) as pool:
        seconds = list(pool.map(lambda lib: lib.load(), libs))
    for lib, sec in zip(libs, seconds):
        print(f"[build] {os.path.relpath(lib.source, ROOT)}: {sec:.2f} s")
        for line in lib.report.splitlines()[:16]:
            print(f"[build]   {line.strip()}")
    print(f"[build] all {len(libs)} in {time.perf_counter() - t0:.2f} s")


def phase_kernel(flame_data: dict, dev: torch.device) -> dict:
    """The kernel and the plain version on the same 4 frames of the head."""
    flame = FlameModel(flame_data).to(dev)
    renderer = MeshRenderer(IMAGE, flame_data["faces"], template_verts=flame_data["v_template"],
                            device=dev)
    rng = np.random.default_rng(7)
    motion = (rng.standard_normal((4, 106)) * 0.5).astype(np.float32)
    motion[:, 100:] *= 0.2   # head and jaw rotations of a few degrees
    verts = flame.motion_to_verts(torch.zeros(4, 300, device=dev),
                                  torch.from_numpy(motion).to(dev))
    screens = [renderer.camera_transform(v).contiguous() for v in verts]
    faces = renderer.faces
    agree, max_err, covered = [], 0.0, []
    for vs in screens:
        zk, fk = rasterizer.rasterize(vs, faces, height=IMAGE, width=IMAGE)
        zp, fp = rasterizer.rasterize_plain(vs, faces, height=IMAGE, width=IMAGE)
        torch.cuda.synchronize()
        if not torch.equal(fk == -1, fp == -1):
            raise AssertionError("kernel and plain version disagree on background pixels")
        both = (fk >= 0) & (fp >= 0)
        rel = ((zk[both] - zp[both]).abs() / zp[both].abs()).max().item()
        if rel > 1e-4:
            raise AssertionError(f"zbuf differs by rtol {rel:.3g} > 1e-4")
        max_err = max(max_err, (zk[both] - zp[both]).abs().max().item())
        agree.append((fk == fp).float().mean().item())
        covered.append(both.float().mean().item())
    if min(agree) < 0.999:
        raise AssertionError(f"face ids agree on only {min(agree):.5f} of pixels")
    identical = all(a == 1.0 for a in agree)
    setup_equal = all(kernel_setup_equal(vs, faces) for vs in screens)
    if not setup_equal:
        raise AssertionError("the setup kernel's planes or boxes differ from the plain setup")
    ms = cuda_ms(lambda: [rasterizer.rasterize(vs, faces, height=IMAGE, width=IMAGE)
                          for vs in screens], 10) / len(screens)
    plain_ms = cuda_ms(lambda: [rasterizer.rasterize_plain(vs, faces, height=IMAGE, width=IMAGE)
                                for vs in screens], 2) / len(screens)
    planes, boxes, chunks = rasterizer.kernel_inputs(screens[0], faces, height=IMAGE, width=IMAGE)
    zbuf = torch.empty((IMAGE, IMAGE), device=dev)
    fid = torch.empty((IMAGE, IMAGE), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib = rasterizer.LIB.get()
    setup_only_ms = cuda_ms(lambda: lib.artalk_rasterize_setup(
        screens[0].data_ptr(), faces.data_ptr(), faces.element_size(), screens[0].shape[0],
        faces.shape[0], IMAGE, IMAGE, planes.data_ptr(), boxes.data_ptr(), chunks.data_ptr(),
        stream), 50)
    kernel_only_ms = cuda_ms(lambda: lib.artalk_rasterize_tiles(
        planes.data_ptr(), boxes.data_ptr(), chunks.data_ptr(), chunks.shape[0], IMAGE, IMAGE,
        zbuf.data_ptr(), fid.data_ptr(), stream), 50)
    # (pixel, face) pairs evaluated a frame: every face of every chunk whose
    # box overlaps a tile (the chunk-only design), against the faces the
    # per-face cull keeps (256 pixels a tile, the ragged edge included)
    tile_px = rasterizer.TILE_W * rasterizer.TILE_H
    chunk_pairs = np.mean([int(rasterizer.tile_hits(rasterizer.kernel_inputs(
        vs, faces, height=IMAGE, width=IMAGE)[2], height=IMAGE, width=IMAGE).sum())
        * rasterizer.FACE_CHUNK * tile_px for vs in screens])
    culled_pairs = np.mean([int(rasterizer.face_culling(*rasterizer.kernel_inputs(
        vs, faces, height=IMAGE, width=IMAGE)[1:], height=IMAGE, width=IMAGE).sum()) * tile_px
        for vs in screens])
    print(f"[kernel] {len(faces)} faces, {chunks.shape[0]} chunks, {IMAGE}x{IMAGE}: face ids "
          f"agree on {min(agree):.6f} (bit-identical: {identical}), covered "
          f"{np.mean(covered):.3f}, zbuf max abs err {max_err:.3g}; the setup kernel's planes "
          f"equal face_planes and its boxes the plain setup's bit for bit: {setup_equal}")
    print(f"[kernel] (pixel, face) pairs evaluated a frame: chunk design {chunk_pairs:.0f}, "
          f"per-face culled {culled_pairs:.0f} ({culled_pairs / chunk_pairs:.4f} of them)")
    # bound: the bytes the function must move (vertices and faces in, the
    # 8-byte output pixels out), or the coverage tests the z-buffer needs,
    # each face against the pixel centres of its own bounding box (13 fp32
    # operations each: three planes of 2 mul + 2 add, and w0 + w1),
    # whichever takes longer
    tests = [roofline.coverage_tests(vs, faces, IMAGE, IMAGE) for vs in screens]
    work = roofline.rasterize_work(screens[0].shape[0], faces.shape[0], faces.element_size(),
                                   IMAGE, IMAGE, float(np.mean(tests)))
    moved = int(work.bytes)
    bytes_ms, ops_ms = roofline.bytes_ms(work.bytes), roofline.fp32_ms(work.flops)
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[kernel] ms/frame by CUDA events: rasterize (setup + raster kernels, end to end) "
          f"{ms:.4f}, setup kernel alone {setup_only_ms:.4f}, raster kernel alone "
          f"{kernel_only_ms:.4f}, rasterize_plain {plain_ms:.4f}")
    print(f"[kernel] bound: {moved} bytes -> {bytes_ms:.5f} ms; {np.mean(tests):.0f} coverage "
          f"tests a frame x 13 FLOP -> {ops_ms:.5f} ms; rasterize reaches "
          f"{bound_ms / ms:.3f} of the bound, the raster kernel alone "
          f"{bound_ms / kernel_only_ms:.3f}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": None, "kernel_only_ms": kernel_only_ms, "setup_only_ms": setup_only_ms,
            "pairs_chunk_design": chunk_pairs, "pairs_culled": culled_pairs}


def kernel_setup_equal(vs: torch.Tensor, faces: torch.Tensor) -> bool:
    """The setup kernel's planes against face_planes on the card and its cull
    and chunk boxes against the plain setup on the CPU, bit for bit."""
    planes, boxes, chunks = rasterizer.kernel_inputs(vs, faces, height=IMAGE, width=IMAGE)
    padded = torch.cat([faces.long(), faces.new_zeros(
        (planes.shape[0] - faces.shape[0], 3)).long()])
    want = rasterizer.kernel_inputs_plain(vs.cpu(), faces.cpu(), height=IMAGE, width=IMAGE)
    return (torch.equal(planes, torch.cat(rasterizer.face_planes(vs, padded), dim=1))
            and torch.equal(boxes.cpu(), want[1]) and torch.equal(chunks.cpu(), want[2]))


def phase_golden(dev: torch.device) -> None:
    """Replay tests/test_golden_regression.py's 3 windows on ``dev``."""
    model = params_from_flat(
        load_params_npz(os.path.join(FIXTURES, "torch_golden_small_params.npz")),
        GOLDEN_SMALL_CFG).to(dev)
    with np.load(os.path.join(FIXTURES, "golden_small.npz")) as z:
        want_bits, want_motions = z["bits"], z["motions"]
    rng = np.random.default_rng(1234)
    chunks = (rng.standard_normal((3, 1, model.window_samples)) * 0.1).astype(np.float32)
    style = model.encode_style(None)
    state = model.initial_state(style)
    flipped, motion_err = 0, 0.0
    for i in range(chunks.shape[0]):
        chunk = torch.from_numpy(chunks[i]).to(dev)
        bits = model.decode_window(model.audio_condition(chunk), style, state.prev_attn_feat)
        state, motion = model.window_step(state, chunk, style)
        flipped += int((bits.cpu().numpy().astype(np.int8) != want_bits[i]).sum())
        motion_err = max(motion_err, float(np.abs(motion.cpu().numpy() - want_motions[i]).max()))
    print(f"[golden] {flipped} of {want_bits.size} code bits differ from golden_small.npz; "
          f"motion max abs err {motion_err:.3g}")
    if flipped > 1:
        raise AssertionError(f"{flipped} golden code bits flipped (> 1)")
    if flipped == 0 and motion_err > 1e-4:
        raise AssertionError(f"golden motions off by {motion_err:.3g} with equal bits")


def noise_audio(sample_rate: int, seconds: int = 10, seed: int = 10) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(seconds * sample_rate) * 0.1
            ).astype(np.float32)


def window0_bits(model: BitwiseARModel, audio: np.ndarray) -> np.ndarray:
    """Greedy code bits of the first window from the bootstrap carry (of a
    tensor-parallel model too: its bits are taken whole)."""
    chunk = torch.from_numpy(audio[None, : model.window_samples]).to(model.pos_embed.device)
    style = model.encode_style(None)
    state = model.initial_state(style)
    return whole(model.decode_window(model.audio_condition(chunk), style,
                                     state.prev_attn_feat)).cpu().numpy()


def rendered_frames(path: str):
    """The frame count of a video ``rendering`` wrote: from the .y4m or .npz
    it falls back to without PyAV and ffmpeg, None for an encoded video
    (after checking it is not empty)."""
    if path.endswith(".y4m"):
        return read_y4m(path)[0].shape[0]
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z["frames"].shape[0]
    if os.path.getsize(path) == 0:
        raise AssertionError(f"{path} is empty")
    return None


def render_mesh(engine: ARTAvatarInferEngine, audio: np.ndarray, motions: np.ndarray,
                save_name: str):
    """rendering(shape_id="mesh") of ``motions``, every launch count set to 0
    just before it: 250 frames, at least 250 rasterizer launches and no
    other kernel's. Returns the path, the frame count (None for an encoded
    video), the rasterizer launches and the ms per frame."""
    zero_launches()
    t0 = time.perf_counter()
    out_path = engine.rendering(audio, motions, shape_id="mesh", save_name=save_name)
    ms_frame = (time.perf_counter() - t0) * 1e3 / len(motions)
    launches, n_frames = since_zero()["rasterize"], rendered_frames(out_path)
    if n_frames not in (None, 250) or launches < 250:
        raise AssertionError(f"[{save_name}] rendered {n_frames} frames with {launches} "
                             "rasterizer launches, want 250 and >= 250")
    n = since_zero()
    if any(launch_counts().values()) or n["gsplat"] or n["sort"]:
        raise AssertionError(f"[{save_name}] the mesh render launched {launch_counts()}, "
                             f"{n['gsplat']} splats, {n['sort']} sorts")
    return out_path, n_frames, launches, ms_frame


def phase_full(dev: torch.device):
    """The production-width path through the engine's entry points. Returns
    the rasterizer launches counted during it, the first window's code bits,
    the ms per window of inference, the audio and its motions."""
    engine = build_engine(dev, {}, tcfg.ModelConfig())
    n_params = sum(p.numel() for p in engine.model.parameters())
    audio = noise_audio(engine.cfg.sample_rate)
    run = drive(engine, audio, "full")
    check_launches("full", run, {"ar": 0, "encoder": 0, "flash": 0})
    if run["conv_launches"] != [0, 0]:
        raise AssertionError(f"[full] exact mode launched the conv front {run['conv_launches']}")
    motions = run["motions"]
    GLOBAL_METRICS.reset()
    trace_dir = os.path.join(ROOT, "render_results", "chip_smoke", "trace")
    with device_trace(trace_dir) as prof:
        engine.inference(audio)
    traced = {e.key for e in prof.key_averages()}
    ws = engine.model.window_samples
    list(engine.stream(audio[i : i + ws] for i in range(0, len(audio), ws)))
    out_path, n_frames, launches, render_ms = render_mesh(engine, audio, motions, "chip_smoke")
    check_registry(GLOBAL_METRICS.snapshot(), traced, run["n_windows"])
    verts = engine.flame.motion_to_verts(torch.zeros(250, 300, device=dev),
                                         torch.from_numpy(motions).to(dev))
    t0 = time.perf_counter()
    engine.mesh_renderer.render_frames(verts)  # returns on the host
    t_frames = time.perf_counter() - t0
    print(f"[full] production config, {n_params / 1e6:.1f} M params (random, seed 0), "
          f"{len(audio) / engine.cfg.sample_rate:.0f} s audio, {run['n_windows']} windows")
    print(f"[full] inference {run['ms_window']:.1f} ms/window; stream vs offline max abs err "
          f"{run['stream_err']:.3g}; rendering (flame + frames + video write) {render_ms:.2f} "
          f"ms/frame; render_frames alone {t_frames * 1e3 / 250:.2f} ms/frame; {launches} "
          "kernel launches")
    print(f"[full] wrote {out_path} ({n_frames if n_frames is not None else 'encoded'} frames)")
    return launches, window0_bits(engine.model, audio), run["ms_window"], audio, motions, engine


def check_registry(snapshot: dict, traced: set, n_windows: int) -> None:
    """Phase 5's registry check: after one inference, stream and rendering of
    the 10 s clip, the JAX engine's counters and stage counts, and the
    inference.generate range among the profiler's events."""
    print(f"[full] GLOBAL_METRICS {json.dumps(snapshot, sort_keys=True)}")
    want = {"inference.windows": n_windows, "inference.frames": 250, "render.frames": 250}
    counts = {name: snapshot.get(f"{name}_count") for name in REGISTRY_STAGES}
    want_counts = {name: n_windows if name == "stream.window_step" else 1
                   for name in REGISTRY_STAGES}
    if snapshot["counters"] != want or counts != want_counts:
        raise AssertionError(f"registry {snapshot['counters']} {counts}, want {want} "
                             f"{want_counts}")
    if "inference.generate" not in traced:
        raise AssertionError("the profiler trace has no inference.generate range")


def ar_inputs(model, b: int, level: int, cache_dtype: torch.dtype, seed: int):
    """Seeded tokens, AdaLN parameters and merged-head caches of one level."""
    g = torch.Generator().manual_seed(seed)
    depth, d, h = model.depth, model.embed_dim, model.num_heads
    pn = model.patch_nums[level]
    x = torch.randn((b, pn, d), generator=g) * 0.3
    ada = torch.randn((depth, b, pn, 6 * d), generator=g) * 0.1
    keys = torch.randn((depth, b, model.cache_len, h, d // h), generator=g)
    kc = (keys / keys.norm(dim=-1, keepdim=True)).reshape(depth, b, model.cache_len, d)
    vc = torch.randn((depth, b, model.cache_len, d), generator=g) * 0.5
    dev = model.pos_embed.device
    return (x.to(dev), ada.to(dev), kc.to(dev, cache_dtype), vc.to(dev, cache_dtype),
            model.prev_len + model.offsets[level])


def bf16_ulps_of_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bfloat16 ulps at the largest magnitude of ``want``."""
    top = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    return (got.float() - want.float()).abs().max().item() / ulp


def first_block(pack: dict) -> dict:
    """The pack of the stack's first block (layer) alone."""
    return {k: v[:1].contiguous() for k, v in pack.items()}


def planted_faults(pack: dict) -> dict:
    """Faults a reduced-precision block-stack kernel could have, made as packs
    for the plain version: "unrounded" holds the same weight values in
    float32, so the activations reach the products unrounded; for int8,
    "fc2_one_scale" applies the first chunk's fc2 scale to the whole hidden
    contraction."""
    unrounded = {}
    for name, t in pack.items():
        if name.startswith("s"):
            continue
        scales = pack.get("s" + name[1:]) if name.startswith("w") else None
        if scales is not None:
            depth, k, n = t.shape
            t = (t.float().reshape(depth, scales.shape[1], k // scales.shape[1], n)
                 * scales[:, :, None]).reshape(depth, k, n)
        unrounded[name] = t.float()
    faults = {"unrounded": unrounded}
    if "sfc2" in pack:
        faults["fc2_one_scale"] = {**pack, "sfc2": pack["sfc2"][:, :1].expand_as(
            pack["sfc2"]).contiguous()}
    return faults


def branch_rms_err(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> float:
    """rms of got - want over the rms of the blocks' contribution want - x."""
    return ((got - want).pow(2).mean().sqrt() / (want - x).pow(2).mean().sqrt()).item()


def check_one_block(kind: str, name: str, kernel: dict, faults: dict) -> None:
    """Hold a one-block reading (``rms``, and for the AR stack the share of
    k/v values ``changed``) to ONE_BLOCK's limits, and require every planted
    fault to break one of them."""
    limits = ONE_BLOCK[f"{kind}/{name}"]
    over = lambda r: any(r[key] > lim for key, lim in limits.items())  # noqa: E731
    show = lambda r: ", ".join(f"{key} {r[key]:.3g}" for key in limits)  # noqa: E731
    print(f"[{kind}] {name} pack, first block alone: kernel {show(kernel)} (limits "
          + ", ".join(f"{key} {lim}" for key, lim in limits.items()) + "); planted faults: "
          + "; ".join(f"{f} {show(r)}" for f, r in faults.items()))
    if over(kernel):
        raise AssertionError(f"{name} {kind} stack, one block: {show(kernel)} over the limits")
    caught = {f: over(r) for f, r in faults.items()}
    if not all(caught.values()):
        raise AssertionError(f"{kind} one-block limits let a planted fault pass: {caught}")


def phase_ar_one_block(model, name: str, pack: dict) -> None:
    """The first AR block alone at the production width, where rounding noise
    has not yet been amplified through the stack, against its plain version
    and against the plain version with planted faults."""
    p1 = first_block(pack)
    faults = planted_faults(p1)
    kernel = {"rms": 0.0, "changed": 0.0}
    bad = {f: {"rms": 0.0, "changed": 0.0} for f in faults}
    for level in range(len(model.patch_nums)):
        x, ada, kc, vc, start = ar_inputs(model, 5, level, torch.bfloat16, seed=100 + level)
        ada, kc, vc = ada[:1].contiguous(), kc[:1].contiguous(), vc[:1].contiguous()
        args = dict(start=start, num_heads=model.num_heads)
        want = ar_stack.ar_block_stack_plain(x, ada, p1, kc, vc, **args)
        runs = {f: ar_stack.ar_block_stack_plain(x, ada, fp, kc, vc, **args)
                for f, fp in faults.items()}
        runs[None] = ar_stack.ar_block_stack(x, ada, p1, kc, vc, **args)
        for f, got in runs.items():
            r = kernel if f is None else bad[f]
            r["rms"] = max(r["rms"], branch_rms_err(got[0], want[0], x))
            r["changed"] = max(r["changed"], *(float((g != w).float().mean())
                                               for g, w in zip(got[1:], want[1:])))
    check_one_block("ar", name, kernel, bad)


def phase_ar_kernel(model, packs: dict) -> dict:
    """The AR block stack against its plain version at every level, B = 1
    and 5, per pack, and its first block alone for the bf16/int8 packs.
    Returns the max abs feats error per pack name."""
    errs = {}
    for name, pack in packs.items():
        cache_dtype = torch.float32 if name == "f32" else torch.bfloat16
        feats_err = kv_err = row_err = 0.0
        # the planted faults through the whole stack, for the record
        faults = planted_faults(pack) if name != "f32" else {}
        fault_err = dict.fromkeys(faults, 0.0)
        for level in range(len(model.patch_nums)):
            x, ada, kc, vc, start = ar_inputs(model, 5, level, cache_dtype, seed=100 + level)
            args = dict(start=start, num_heads=model.num_heads)
            for b in (1, 5):
                xs, adas, kcs, vcs = x[:b], ada[:, :b].contiguous(), kc[:, :b].contiguous(), \
                    vc[:, :b].contiguous()
                got = ar_stack.ar_block_stack(xs, adas, pack, kcs, vcs, **args)
                want = ar_stack.ar_block_stack_plain(xs, adas, pack, kcs, vcs, **args)
                feats_err = max(feats_err, (got[0] - want[0]).abs().max().item())
                if name == "f32":
                    kv_err = max(kv_err, *((g - w).abs().max().item()
                                           for g, w in zip(got[1:], want[1:])))
                else:
                    kv_err = max(kv_err, *(bf16_ulps_of_max(g, w)
                                           for g, w in zip(got[1:], want[1:])))
                for f, fp in faults.items() if b == 1 else ():
                    bad = ar_stack.ar_block_stack_plain(xs, adas, fp, kcs, vcs, **args)[0]
                    fault_err[f] = max(fault_err[f], (bad - want[0]).abs().max().item())
                if b == 5:
                    for r in range(5):
                        one = ar_stack.ar_block_stack(x[r:r + 1], ada[:, r:r + 1].contiguous(),
                                                      pack, kc[:, r:r + 1].contiguous(),
                                                      vc[:, r:r + 1].contiguous(), **args)
                        row_err = max(row_err, (one[0] - got[0][r:r + 1]).abs().max().item(),
                                      *((o.float() - g[:, r:r + 1].float()).abs().max().item()
                                        for o, g in zip(one[1:], got[1:])))
        torch.cuda.synchronize()
        kv_unit = "max abs err" if name == "f32" else "bf16 ulps at the largest value"
        print(f"[ar] {name} pack: feats max abs err {feats_err:.3g}, k/v {kv_unit} "
              f"{kv_err:.3g}, B=5 rows vs alone {row_err:.3g}"
              + "".join(f"; planted fault {f}: feats {e:.3g}" for f, e in fault_err.items()))
        if name == "f32" and (feats_err > 1e-4 or kv_err > 1e-5):
            raise AssertionError(f"f32 AR stack off: feats {feats_err:.3g}, k/v {kv_err:.3g}")
        if name != "f32" and (feats_err > AR_FEATS_TOL or kv_err > 2):
            raise AssertionError(f"{name} AR stack off: feats {feats_err:.3g} (limit "
                                 f"{AR_FEATS_TOL}), k/v {kv_err:.3g} bf16 ulps (limit 2)")
        if row_err > 1e-6:
            raise AssertionError(f"{name} AR stack: a B=5 row differs from B=1 by {row_err:.3g}")
        if name != "f32":
            phase_ar_one_block(model, name, pack)
        errs[name] = feats_err
    print_ar_barriers(model, packs["bf16"])
    return errs


def barriers_cuda_core_design(pn: int, depth: int, sms: int) -> int:
    """Grid barriers a launch of the earlier CUDA-core AR kernel passed:
    one after each block's attention and after each product, one more before
    the reduction of a split product, none after the last product. Its splits
    were the most that kept its 32 x 64 tiles (32-deep steps; a split within
    or over whole d-row chunks) at two items per SM, at most 16."""
    d, hidden = 768, 3072
    per_block = 1
    for n, k in ((3 * d, d), (d, d), (hidden, d), (d, hidden)):
        base, steps, chunk_steps = -(-pn // 32) * (n // 64), k // 32, d // 32
        valid = [s for s in range(1, min(16, steps) + 1) if steps % s == 0
                 and (chunk_steps % (steps // s) == 0 or (steps // s) % chunk_steps == 0)
                 and base * s <= 2 * sms]
        per_block += 2 if valid and valid[-1] > 1 else 1
    return depth * per_block - 1


def print_ar_barriers(model, pack: dict) -> None:
    """The grid barriers a launch passes, counted by the kernel, per level,
    beside the earlier CUDA-core design's."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    now, before = [], []
    for level, pn in enumerate(model.patch_nums):
        x, ada, kc, vc, start = ar_inputs(model, 1, level, torch.bfloat16, seed=300 + level)
        _, barriers = ar_stack.stage_times(x, ada, pack, kc, vc, start=start,
                                           num_heads=model.num_heads)
        now.append(int(barriers))
        before.append(barriers_cuda_core_design(pn, model.depth, sms))
    print(f"[ar] grid barriers per launch, levels pn {model.patch_nums}: {now} (counted by the "
          f"kernel); the CUDA-core design {before}")


def encoder_input(model, b: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(200)
    t = model.audio_encoder.num_output_frames(model.window_samples)
    x = torch.randn((b, t, model.cfg.wav2vec.hidden_size), generator=g) * 0.5
    return x.to(model.pos_embed.device)


def phase_encoder_one_layer(model, name: str, pack: dict) -> None:
    """The first encoder layer alone, against its plain version and against
    the plain version with planted faults."""
    heads = model.cfg.wav2vec.num_attention_heads
    x = encoder_input(model)
    p1 = first_block(pack)
    want = enc_stack.encoder_block_stack_plain(x, p1, num_heads=heads)
    kernel = {"rms": branch_rms_err(enc_stack.encoder_block_stack(x, p1, num_heads=heads),
                                    want, x)}
    bad = {f: {"rms": branch_rms_err(enc_stack.encoder_block_stack_plain(
        x, fp, num_heads=heads), want, x)} for f, fp in planted_faults(p1).items()}
    check_one_block("encoder", name, kernel, bad)


def phase_encoder_kernel(model, packs: dict) -> dict:
    """The encoder stack against its plain version per pack, two windows in
    one launch against each alone, and for the bf16/int8 packs the first
    layer alone."""
    heads = model.cfg.wav2vec.num_attention_heads
    x = encoder_input(model, 2)
    errs = {}
    for name, pack in packs.items():
        tol = ENCODER_TOL[name]
        got = enc_stack.encoder_block_stack(x[:1], pack, num_heads=heads)
        want = enc_stack.encoder_block_stack_plain(x[:1], pack, num_heads=heads)
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / (tol + tol * want.abs())).max().item()
        both = enc_stack.encoder_block_stack(x, pack, num_heads=heads)
        same = torch.equal(both[:1], got) and torch.equal(
            both[1:], enc_stack.encoder_block_stack(x[1:], pack, num_heads=heads))
        torch.cuda.synchronize()
        fault_err = {f: (enc_stack.encoder_block_stack_plain(x[:1], fp, num_heads=heads)
                         - want).abs().max().item()
                     for f, fp in (planted_faults(pack) if name != "f32" else {}).items()}
        print(f"[encoder] {name} pack: max abs err {err:.3g} (atol = rtol {tol}: "
              f"{rel:.3f} of the bound); two windows in one launch equal each alone: {same}"
              + "".join(f"; planted fault {f}: {e:.3g}" for f, e in fault_err.items()))
        if rel > 1.0 or not same:
            raise AssertionError(f"{name} encoder stack off the plain version")
        if name != "f32":
            phase_encoder_one_layer(model, name, pack)
        errs[name] = err
    return errs


def ar_inputs_on_card(model, b: int, level: int, seed: int):
    """ar_inputs drawn on the card (the serving batches' AdaLN rows reach
    9 GB at B = 408, pn 100), bf16 caches."""
    dev = model.pos_embed.device
    g = torch.Generator(device=dev).manual_seed(seed)
    depth, d, h = model.depth, model.embed_dim, model.num_heads
    pn = model.patch_nums[level]
    x = torch.randn((b, pn, d), generator=g, device=dev) * 0.3
    ada = torch.randn((depth, b, pn, 6 * d), generator=g, device=dev) * 0.1
    keys = torch.randn((depth, b, model.cache_len, h, d // h), generator=g, device=dev)
    kc = (keys / keys.norm(dim=-1, keepdim=True)).reshape(depth, b, model.cache_len, d)
    del keys
    vc = torch.randn((depth, b, model.cache_len, d), generator=g, device=dev) * 0.5
    return (x, ada, kc.to(torch.bfloat16), vc.to(torch.bfloat16),
            model.prev_len + model.offsets[level])


def sampled_rows(b: int) -> tuple:
    return (0, b // 2, b - 1)


def ar_rows_vs_alone(pack: dict, args: dict, x, ada, kc, vc, got) -> float:
    """The largest difference of the sampled rows of a launch (``got``) from
    the same rows launched alone (feats, k and v)."""
    err = 0.0
    for r in sampled_rows(x.shape[0]):
        one = ar_stack.ar_block_stack(x[r:r + 1], ada[:, r:r + 1].contiguous(), pack,
                                      kc[:, r:r + 1].contiguous(), vc[:, r:r + 1].contiguous(),
                                      **args)
        err = max(err, (one[0] - got[0][r:r + 1]).abs().max().item(),
                  *((o.float() - g[:, r:r + 1].float()).abs().max().item()
                    for o, g in zip(one[1:], got[1:])))
    return err


def planted_fold_fault(fn):
    """``fn()`` with the planted fault of the folded products: their splits
    added last first inside the CTA."""
    ar_stack.FOLD_LAST_FIRST = True
    try:
        return fn()
    finally:
        ar_stack.FOLD_LAST_FIRST = False


def phase_ar_serving(model, pack: dict) -> dict:
    """Phase 6 at the stream cells' batches: the AR stack's int8 pack at B =
    SERVING_AR_BATCHES for every level against its plain version (feats
    within AR_FEATS_TOL, k/v within 2 bf16 ulps) and the sampled rows against
    themselves alone (1e-6); the planted fault (the folded splits added last
    first) must break the row rule. Returns the largest readings per batch."""
    out = {}
    for b in SERVING_AR_BATCHES:
        r = {"feats": 0.0, "kv_ulps": 0.0, "rows": 0.0, "fault_rows": 0.0, "folded": 0}
        for level in range(len(model.patch_nums)):
            x, ada, kc, vc, start = ar_inputs_on_card(model, b, level, seed=500 + level)
            args = dict(start=start, num_heads=model.num_heads)
            folded = since_zero()["ar/folded"]
            got = ar_stack.ar_block_stack(x, ada, pack, kc, vc, **args)
            r["folded"] += since_zero()["ar/folded"] - folded
            want = ar_stack.ar_block_stack_plain(x, ada, pack, kc, vc, **args)
            r["feats"] = max(r["feats"], (got[0] - want[0]).abs().max().item())
            r["kv_ulps"] = max(r["kv_ulps"], *(bf16_ulps_of_max(g, w)
                                               for g, w in zip(got[1:], want[1:])))
            del want
            r["rows"] = max(r["rows"], ar_rows_vs_alone(pack, args, x, ada, kc, vc, got))
            if since_zero()["ar/folded"] > folded:
                bad = planted_fold_fault(lambda: ar_stack.ar_block_stack(x, ada, pack, kc, vc,
                                                                         **args))
                r["fault_rows"] = max(r["fault_rows"],
                                      ar_rows_vs_alone(pack, args, x, ada, kc, vc, bad))
                del bad
            del x, ada, kc, vc, got
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        print(f"[ar] int8 pack at B = {b}, every level: feats max abs err {r['feats']:.3g} (limit "
              f"{AR_FEATS_TOL}), k/v {r['kv_ulps']:.3g} bf16 ulps (limit 2), sampled rows vs "
              f"alone {r['rows']:.3g} (limit 1e-6); products folded {r['folded']}; planted "
              f"fault folded splits last first: rows vs alone {r['fault_rows']:.3g}")
        if r["feats"] > AR_FEATS_TOL or r["kv_ulps"] > 2 or r["rows"] > 1e-6:
            raise AssertionError(f"int8 AR stack at B = {b} off: {r}")
        if r["folded"] and r["fault_rows"] <= 1e-6:
            raise AssertionError(f"the row rule at B = {b} lets splits added last first pass")
        out[b] = r
    return out


def phase_encoder_serving(model, pack: dict) -> dict:
    """Phase 7 at the stream cell's batch: the encoder stack's int8 pack at B
    = SERVING_ENCODER_BATCH windows against its plain version (ENCODER_TOL)
    and the sampled windows against themselves alone (1e-6); the planted
    fault (the folded splits added last first) must break the row rule."""
    heads = model.cfg.wav2vec.num_attention_heads
    b = SERVING_ENCODER_BATCH
    dev = model.pos_embed.device
    g = torch.Generator(device=dev).manual_seed(210)
    t = model.audio_encoder.num_output_frames(model.window_samples)
    x = torch.randn((b, t, model.cfg.wav2vec.hidden_size), generator=g, device=dev) * 0.5
    tol = ENCODER_TOL["int8"]
    folded = since_zero()["encoder/folded"]
    got = enc_stack.encoder_block_stack(x, pack, num_heads=heads)
    folded = since_zero()["encoder/folded"] - folded
    want = enc_stack.encoder_block_stack_plain(x, pack, num_heads=heads)
    of_bound = ((got - want).abs() / (tol + tol * want.abs())).max().item()
    err = (got - want).abs().max().item()
    del want

    def rows(y):
        return max((enc_stack.encoder_block_stack(x[r:r + 1], pack, num_heads=heads)
                    - y[r:r + 1]).abs().max().item() for r in sampled_rows(b))

    row_err = rows(got)
    fault = rows(planted_fold_fault(lambda: enc_stack.encoder_block_stack(x, pack,
                                                                          num_heads=heads)))
    torch.cuda.synchronize()
    print(f"[encoder] int8 pack at B = {b}: max abs err {err:.3g} ({of_bound:.3f} of ENCODER_TOL's "
          f"bound), sampled windows vs alone {row_err:.3g} (limit 1e-6); products folded "
          f"{folded}; planted fault folded splits last first: windows vs alone {fault:.3g}")
    if of_bound > 1.0 or row_err > 1e-6:
        raise AssertionError(f"int8 encoder stack at B = {b} off the plain version or its rows")
    if folded and fault <= 1e-6:
        raise AssertionError(f"the row rule at B = {b} lets splits added last first pass")
    return {"max_abs_err": err, "of_bound": of_bound, "rows": row_err, "fault_rows": fault,
            "folded": folded}


def bf16_ulp_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| of two bf16 tensors in ulps, elementwise: the distance of
    their bit patterns in the order of the values (+0 and -0 at 0)."""
    def ordered(t):
        u = t.contiguous().view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

    return (ordered(got) - ordered(want)).abs()


def conv_front_encoder(dev: torch.device) -> wav2vec_mod.Wav2VecEncoder:
    """The production wav2vec2 conv front in bf16 on ``dev`` (one encoder
    layer: the layers do not take part), seed-0 weights with the conv biases
    and LayerNorm rows moved off their defaults."""
    cfg = dataclasses.replace(tcfg.Wav2VecConfig(), num_hidden_layers=1)
    enc = wav2vec_mod.Wav2VecEncoder(cfg).init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.endswith(("norm.scale", "norm.bias", "conv.b")):
                p.add_(torch.randn(p.shape, generator=g) * 0.3)
    return enc.to(dev, torch.bfloat16).requires_grad_(False)


def conv_front_audio(b: int, samples: int, dev: torch.device, seed: int) -> torch.Tensor:
    """z-normed bf16 noise of ``b`` windows, as ``Wav2VecEncoder.frontend``
    hands the convs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    audio = torch.randn((b, samples), generator=g, device=dev) * 0.1
    return wav2vec_mod.normalize_audio(audio.to(torch.bfloat16))


def phase_conv_front(dev: torch.device) -> dict:
    """Phase 37: the conv front's kernels (ops/conv_frontend.py) against the
    plain version at XLS-R widths, each layer fed the plain version's own
    input, and the whole front; rows of the stream batch against themselves
    alone; the launches a call makes; then times by CUDA events beside the
    eager path (cuDNN's float32 convolution of the same bf16 values), the
    plain version and the bound."""
    enc = conv_front_encoder(dev)
    pack = enc.pack_frontend()
    samples = 64000
    out = {"layers": {}}
    with torch.no_grad():
        for b in CONV_FRONT_BATCHES:
            a = conv_front_audio(b, samples, dev, seed=370 + b)
            x = a
            for i in range(len(pack["stride"]) + 1):
                if i < len(pack["stride"]):
                    want = conv_front.conv_layer_plain(x, pack, i)
                    got = conv_front.conv_layer(x, pack, i)
                    tag = f"conv{i}"
                else:
                    x = enc._project(x)
                    want = conv_front.pos_conv_residual_plain(x, pack)
                    got = conv_front.pos_conv_residual(x, pack)
                    tag = "pos"
                gaps = bf16_ulp_gaps(got, want)
                err = (got.float() - want.float()).abs()
                top = want.float().abs().max().item()
                row = {"equal": (gaps == 0).float().mean().item(),
                       "within_1ulp": (gaps <= 1).float().mean().item(),
                       "max_ulps": gaps.max().item(), "max_abs_err": err.max().item(),
                       "max_abs": top,
                       "ulps_of_max": err.max().item() / 2.0 ** (math.floor(math.log2(top)) - 7)}
                out["layers"][f"{tag}/B{b}"] = row
                print(f"[conv front] B = {b} {tag} {tuple(got.shape)}: equal {row['equal']:.6f}, "
                      f"within 1 ulp {row['within_1ulp']:.6f}, max {row['max_ulps']} ulps, "
                      f"max abs err {row['max_abs_err']:.4g} of max |value| {top:.4g} "
                      f"({row['ulps_of_max']:.2f} ulps of it)")
                lim = CONV_FRONT_LAYER
                if row["equal"] < lim["equal"] or row["within_1ulp"] < lim["within_1ulp"] or \
                        row["ulps_of_max"] > lim["ulps_of_max"]:
                    raise AssertionError(f"[conv front] B = {b} {tag} off the plain version: {row}")
                x = want
            before = launches()["conv_frontend"]
            got = conv_front.conv_frontend(a, pack, enc._project)
            n_launch = launches()["conv_frontend"] - before
            want = conv_front.conv_frontend_plain(a, pack, enc._project)
            eager = enc._embed(enc.extract_features(a))
            top = want.float().abs().max()
            err = ((got.float() - want.float()).abs().max() / top).item()
            eager_err = ((eager.float() - want.float()).abs().max() / top).item()
            same = (bf16_ulp_gaps(want, eager) == 0).float().mean().item()
            out[f"front/B{b}"] = {"rel_err": err, "launches": n_launch, "eager_rel_err": eager_err}
            print(f"[conv front] B = {b} whole front {tuple(got.shape)}: max abs err / max |value| "
                  f"{err:.4g} (limit {CONV_FRONT_REL}), equal "
                  f"{(bf16_ulp_gaps(got, want) == 0).float().mean().item():.6f}; the eager path "
                  f"(cuDNN) vs plain: {eager_err:.4g}, equal {same:.6f}; launches {n_launch} "
                  f"(want {conv_front.launches_per_call(pack)})")
            if n_launch != conv_front.launches_per_call(pack) or err > CONV_FRONT_REL:
                raise AssertionError(f"[conv front] B = {b}: {n_launch} launches a call, "
                                     f"whole front {err:.4g} off the plain version")
            if b > 1:
                rows = [0, b // 2, b - 1]
                alone = [bf16_ulp_gaps(conv_front.conv_frontend(a[r:r + 1], pack, enc._project),
                                       got[r:r + 1]).max().item() for r in rows]
                print(f"[conv front] B = {b}: rows {rows} vs alone, max ulps {alone}")
                if max(alone) != 0:
                    raise AssertionError(f"[conv front] a row of B = {b} differs from itself alone")
            torch.cuda.synchronize()
        times = {}
        for b in CONV_FRONT_BATCHES:
            a = conv_front_audio(b, samples, dev, seed=371)
            reps = 20 if b == 1 else 5
            times[b] = {
                "kernel": cuda_ms(lambda: conv_front.conv_frontend(a, pack, enc._project), reps),
                "eager": cuda_ms(lambda: enc._embed(enc.extract_features(a)), max(2, reps // 2)),
                "plain": cuda_ms(lambda: conv_front.conv_frontend_plain(a, pack, enc._project),
                                 max(2, reps // 2))}
            x, per = a, []
            for i in range(len(pack["stride"])):
                y = conv_front.conv_layer(x, pack, i)
                per.append(cuda_ms(lambda: conv_front.conv_layer(x, pack, i), reps))
                x = y
            x = enc._project(x)
            per.append(cuda_ms(lambda: conv_front.pos_conv_residual(x, pack), reps))
            work = roofline.conv_frontend_work(enc.cfg, samples, b)
            ops_ms = roofline.matmul_ms(work.flops, torch.bfloat16)
            bytes_ms = roofline.bytes_ms(work.bytes)
            bound = max(ops_ms, bytes_ms)
            t = times[b]
            t.update(per_launch=per, bound=bound, ops_ms=ops_ms, bytes_ms=bytes_ms)
            print(f"[conv front] times at B = {b}: kernels {t['kernel']:.4f} ms a call (with the "
                  f"projection), eager path (cuDNN fp32) {t['eager']:.4f}, plain {t['plain']:.4f}, "
                  f"bound {bound:.4f} ({ops_ms:.4f} operations at 989 TFLOP/s, {bytes_ms:.4f} "
                  f"bytes); per launch " + ", ".join(f"{v:.4f}" for v in per))
            if b > 1:
                profile_calls(lambda: conv_front.conv_frontend(a, pack, enc._project),
                              f"conv front B = {b}", reps=3)
        out["times"] = times
    return out


def build_engine(dev: torch.device, env: dict, config: tcfg.ModelConfig,
                 **kwargs) -> ARTAvatarInferEngine:
    """An engine on ``dev`` with random seed-0 weights, the precision
    switches set to ``env`` while it is built."""
    return bench.with_env(env, lambda: ARTAvatarInferEngine(
        device=dev, config=config, assets_dir=os.path.join(ROOT, "assets"),
        output_dir=os.path.join(ROOT, "render_results", "chip_smoke"), image_size=IMAGE,
        seed=0, **kwargs))


def drive(engine: ARTAvatarInferEngine, audio: np.ndarray, tag: str) -> dict:
    """``inference`` of ``audio`` and ``stream`` of its 4 s chunks through the
    engine's entry points, each with the launch counts set to 0 just before
    and read just after it; the stream must equal the offline decode to
    1e-4. Returns the motions, ms per window and both runs' launches."""
    dev = engine.device
    ws = engine.model.window_samples
    n_windows = math.ceil(len(audio) / ws)
    engine.inference(audio[:ws])  # warm-up: cuBLAS/cuDNN handles and autotuning
    zero_launches()
    t0 = time.perf_counter()
    motions = engine.inference(audio)
    ms_window = (time.perf_counter() - t0) * 1e3 / n_windows
    launches = launch_counts()
    conv_launches = [since_zero()["conv_frontend"]]
    zero_launches()
    streamed = np.concatenate(list(engine.stream(
        audio[i : i + ws] for i in range(0, len(audio), ws))), axis=0)
    stream_launches = launch_counts()
    conv_launches.append(since_zero()["conv_frontend"])
    if motions.shape != (250, 106) or not np.isfinite(motions).all():
        raise AssertionError(f"[{tag}] inference gave {motions.shape}, "
                             f"finite={np.isfinite(motions).all()}")
    padded = np.zeros(n_windows * ws, np.float32)
    padded[: len(audio)] = audio
    offline = engine.model.generate(
        torch.from_numpy(padded.reshape(n_windows, 1, ws)).to(dev),
        engine.model.encode_style(None))[0, :250].cpu().numpy()
    stream_err = float(np.abs(streamed - offline).max())
    if streamed.shape != offline.shape or stream_err > 1e-4:
        raise AssertionError(f"[{tag}] stream vs offline: {streamed.shape} vs {offline.shape}, "
                             f"max abs err {stream_err:.3g}")
    return {"motions": motions, "ms_window": ms_window, "launches": launches,
            "stream_launches": stream_launches, "stream_err": stream_err,
            "n_windows": n_windows, "conv_launches": conv_launches}


def check_launches(tag: str, run: dict, want: dict) -> None:
    if run["launches"] != want or run["stream_launches"] != want:
        raise AssertionError(f"[{tag}] launches {run['launches']} / stream "
                             f"{run['stream_launches']}, want {want} each")


def phase_mode(mode: str, dev: torch.device, exact_bits: np.ndarray):
    """One precision mode at full width through the engine's entry points.
    Returns the engine and the mode's numbers."""
    engine = build_engine(dev, MODES[mode], tcfg.ModelConfig())
    audio = noise_audio(engine.cfg.sample_rate)
    run = drive(engine, audio, mode)
    fused, n = engine.cfg.fused_ar, run["n_windows"]
    levels = len(engine.model.patch_nums)
    check_launches(mode, run, {"ar": levels * n if fused else 0, "encoder": n if fused else 0,
                               "flash": 0})
    # the conv front's kernels: one launch a conv of every bf16 window
    conv = conv_front.launches_per_call(engine.model.frontend_pack()) * n \
        if engine.cfg.bf16_audio else 0
    if run["conv_launches"] != [conv, conv]:
        raise AssertionError(f"[{mode}] conv front launches (inference, stream) "
                             f"{run['conv_launches']}, want {conv} each")
    bits = window0_bits(engine.model, audio)
    agree = float((bits == exact_bits).mean())
    print(f"[mode {mode}] inference {run['ms_window']:.2f} ms/window; stream vs offline max abs "
          f"err {run['stream_err']:.3g}; launches per {n} windows: inference "
          f"{run['launches']}, stream {run['stream_launches']}, conv front "
          f"{run['conv_launches']}; window-0 code bits agreeing "
          f"with exact {agree:.4f}")
    floor = 0.999 if mode == "fused" else 0.9
    if agree < floor:
        raise AssertionError(f"[{mode}] only {agree:.4f} of the code bits agree with exact")
    return engine, {"ms_window": run["ms_window"], "launches": run["launches"], "agree": agree,
                    "motions": run["motions"], "bits": bits,
                    "conv_launches": run["conv_launches"]}


class DecodedBits:
    """Records the greedy code bits of every ``decode_window`` call of
    ``model`` while in use: a probe of the pool's rows and of batch-1 streams
    alike."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def __enter__(self):
        decode = self.model.decode_window

        def recorded(*args):
            bits = decode(*args)
            self.calls.append(bits.cpu().numpy())
            return bits

        self.model.decode_window = recorded
        return self.calls

    def __exit__(self, *exc):
        del self.model.decode_window


def pool_scenario(pool, a: list, b: list):
    """Session a joins, b joins late, then each idles one tick. Returns, per
    session, (motions, decoded code bits) of each of its windows."""
    got = {}
    with DecodedBits(pool.model) as calls:
        def tick(chunks):
            out = pool.step(chunks)
            for sid in chunks:
                got.setdefault(sid, []).append((out[sid], calls[-1][sid]))

        sa = pool.open_session()
        tick({sa: a[0]})
        sb = pool.open_session()
        tick({sa: a[1], sb: b[0]})
        tick({sa: a[2]})        # b idles
        tick({sb: b[1]})        # a idles
    return got[sa], got[sb]


def stream_windows(engine: ARTAvatarInferEngine, chunks: list) -> list:
    """engine.stream at batch 1: (motions, decoded code bits) per chunk."""
    with DecodedBits(engine.model) as calls:
        motions = list(engine.stream(chunks))
    return [(m, c[0]) for m, c in zip(motions, calls)]


def bits_agree(x: tuple, y: tuple) -> float:
    return float((x[1] == y[1]).mean())


def phase_pool(engine: ARTAvatarInferEngine) -> dict:
    """StreamPool at capacity 4 (the batched kernel path): two sessions, one
    joining late, with idle ticks. Each session must equal itself run alone
    in a pool of the same capacity to 1e-5 (session isolation), and agree
    with the same audio streamed alone at batch 1 through engine.stream on at
    least POOL_BITS_AGREE of its decoded code bits in every window. Motions
    are not held to 1e-5 there: PyTorch's reductions and cuBLAS/cuDNN pick
    other algorithms for 4 rows than for 1, and bf16 rounding and the greedy
    bits amplify that rounding-level change. Two planted faults must fail the
    bits check: rows crossed (a's windows against b's stream) and an idle
    row whose carry is not kept (b's stream with a silent window between)."""
    from artalk_tpu_torch.serving import StreamPool

    ws = engine.model.window_samples
    rng = np.random.default_rng(30)
    a = [(rng.standard_normal(ws) * 0.1).astype(np.float32) for _ in range(3)]
    b = [(rng.standard_normal(ws) * 0.1).astype(np.float32) for _ in range(2)]
    pool = StreamPool(engine.model, max_sessions=4)
    zero_launches()
    t0 = time.perf_counter()
    got_a, got_b = pool_scenario(pool, a, b)
    ms_tick = (time.perf_counter() - t0) * 1e3 / 4
    launches = {k: since_zero()[k] for k in ("ar", "encoder")}

    alone = StreamPool(engine.model, max_sessions=4)
    sa = alone.open_session()
    alone_a = [alone.step({sa: c})[sa] for c in a]
    alone = StreamPool(engine.model, max_sessions=4)
    alone.open_session()
    sb = alone.open_session()                     # b keeps its slot
    alone_b = [alone.step({sb: c})[sb] for c in b]
    iso_err = max(float(np.abs(g[0] - w).max())
                  for g, w in zip(got_a + got_b, alone_a + alone_b))
    stream_a, stream_b = stream_windows(engine, a), stream_windows(engine, b)
    pairs = list(zip(got_a + got_b, stream_a + stream_b))
    diffs = [np.abs(g[0] - w[0]) for g, w in pairs]
    stream_err = max(float(d.max()) for d in diffs)
    within = float(np.mean(np.concatenate([d.ravel() for d in diffs]) <= 1e-5))
    agree = [bits_agree(g, w) for g, w in pairs]
    idle_kept = stream_windows(engine, [b[0], np.zeros(ws, np.float32), b[1]])[2]
    faults = {"rows crossed": max(bits_agree(g, w) for g, w in zip(got_a, stream_b)),
              "idle carry lost": bits_agree(got_b[1], idle_kept)}
    print(f"[pool] int8, capacity 4, 2 sessions over 4 ticks: {ms_tick:.2f} ms/tick, "
          f"launches {launches}; max abs err vs each session alone in the pool "
          f"{iso_err:.3g}; vs engine.stream at batch 1: code bits agreeing per window "
          + ", ".join(f"{x:.4f}" for x in agree) + f" (limit {POOL_BITS_AGREE}), motions max "
          f"abs err {stream_err:.3g}, {within:.4f} of the values within 1e-5; planted "
          "faults: " + ", ".join(f"{f} {x:.4f}" for f, x in faults.items()))
    if iso_err > 1e-5:
        raise AssertionError(f"StreamPool sessions interfere: {iso_err:.3g} > 1e-5")
    if min(agree) < POOL_BITS_AGREE:
        raise AssertionError(f"StreamPool vs engine.stream: only {min(agree):.4f} of a "
                             f"window's code bits agree (limit {POOL_BITS_AGREE})")
    if max(faults.values()) >= POOL_BITS_AGREE:
        raise AssertionError(f"the pool's bits check lets a planted fault pass: {faults}")
    want = {"ar": 4 * len(engine.model.patch_nums), "encoder": 4}
    if launches != want:
        raise AssertionError(f"StreamPool launches {launches}, want {want}")
    return {"ms_tick": ms_tick, "launches": launches, "stream_err": stream_err,
            "agree": min(agree)}


def http_raw(url: str, method: str = "GET", data: bytes = None):
    """One request to the phase-25 server on this host: (status, headers,
    body bytes), error statuses included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/octet-stream")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def http(url: str, method: str = "GET", data: bytes = None):
    """``http_raw`` with the JSON body parsed: (status, body)."""
    status, _, body = http_raw(url, method, data)
    return status, json.loads(body.decode())


def post_chunks(base: str, chunks: dict) -> dict:
    """POST each session's chunk from a thread of its own, all released at
    once; returns sid -> the motion rows."""
    barrier, out = threading.Barrier(len(chunks)), {}

    def post(sid, chunk):
        barrier.wait(timeout=60)
        out[sid] = http(f"{base}/v1/sessions/{sid}/audio", "POST", chunk.tobytes())

    threads = [threading.Thread(target=post, args=item) for item in chunks.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or any(r[0] != 200 for r in out.values()):
        raise AssertionError(f"[server] chunk requests {out}")
    return {sid: np.asarray(r[1]["motion"], np.float32) for sid, r in out.items()}


def server_ticks(server, base: str, engine: ARTAvatarInferEngine, sids: tuple) -> dict:
    """Phase 25's ticks: session a alone (a warm-up, then a timed chunk), then
    a and b together twice, from two threads at once. Each pair must ride
    one pool step, each tick launch 5 AR kernels and 1 encoder kernel, and
    every row equal the same chunks through a fresh StreamPool of the same
    capacity to 1e-5."""
    from artalk_tpu_torch.serving import StreamPool

    sa, sb = sids
    levels = len(engine.model.patch_nums)
    rng = np.random.default_rng(40)
    ticks = [{sa: None}, {sa: None}, {sa: None, sb: None}, {sa: None, sb: None}]
    for chunks in ticks:
        for sid in chunks:
            chunks[sid] = (rng.standard_normal(engine.model.window_samples) * 0.1
                           ).astype(np.float32)
    steps, step = [], server.pool.step
    server.pool.step = lambda chunks: steps.append(sorted(chunks)) or step(chunks)
    got, ms = {sa: [], sb: []}, []
    zero_launches()
    try:
        for chunks in ticks:
            t0 = time.perf_counter()
            for sid, rows in post_chunks(base, chunks).items():
                got[sid].append(rows)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        del server.pool.step
    launches = {k: since_zero()[k] for k in ("ar", "encoder")}
    if steps != [sorted(chunks) for chunks in ticks]:
        raise AssertionError(f"[server] pool steps {steps}: concurrent chunks must share one")
    if launches != {"ar": len(ticks) * levels, "encoder": len(ticks)}:
        raise AssertionError(f"[server] {len(ticks)} ticks launched {launches}")

    fresh = StreamPool(engine.model, max_sessions=server.pool.capacity)
    if (fresh.open_session(), fresh.open_session()) != (sa, sb):
        raise AssertionError("[server] the fresh pool numbers its sessions otherwise")
    want = {sa: [], sb: []}
    for chunks in ticks:
        for sid, rows in fresh.step(chunks).items():
            want[sid].append(rows)
    iso_err = max(float(np.abs(g - w).max())
                  for sid in sids for g, w in zip(got[sid], want[sid]))
    if iso_err > 1e-5 or [len(got[s]) for s in sids] != [len(want[s]) for s in sids]:
        raise AssertionError(f"[server] session rows vs a fresh pool: {iso_err:.3g}")
    return {"ms_chunk_1": ms[1], "ms_chunk_2": (ms[2] + ms[3]) / 2, "steps": steps,
            "launches": launches, "iso_err": iso_err}


def server_codes(server, base: str, sids: tuple) -> dict:
    """Phase 25's error codes: 413 for a chunk over one window, 404 for an
    unknown session or route, 409 for a second chunk while the first waits in
    its tick window, auto-grow to 4 sessions and then 503. Closes every
    session."""
    sa, sb = sids
    chunk = np.zeros(server.pool.window_samples, np.float32).tobytes()
    over = np.zeros(server.pool.window_samples + 1, np.float32).tobytes()
    codes = {"413": http(f"{base}/v1/sessions/{sa}/audio", "POST", over)[0],
             "404 sid": http(f"{base}/v1/sessions/99/audio", "POST", chunk)[0],
             "404 route": http(f"{base}/nope")[0]}
    server.batcher.tick_s = 1.0          # hold a's next chunk in its tick window
    held = {}
    t = threading.Thread(target=lambda: held.update(
        r=http(f"{base}/v1/sessions/{sa}/audio", "POST", chunk)))
    t.start()
    deadline = time.monotonic() + 60
    while sa not in server.batcher._pending and time.monotonic() < deadline:
        time.sleep(0.005)
    codes["409"] = http(f"{base}/v1/sessions/{sa}/audio", "POST", chunk)[0]
    t.join(timeout=600)
    server.batcher.tick_s = SERVER_TICK_MS / 1e3
    codes["held chunk"] = held["r"][0] if "r" in held else None
    opened = [http(f"{base}/v1/sessions", "POST", b"{}") for _ in range(3)]
    codes["opens"] = [code for code, _ in opened]
    capacity = server.pool.capacity
    for sid in list(sids) + [body["sid"] for code, body in opened if code == 200]:
        http(f"{base}/v1/sessions/{sid}", "DELETE")
    want = {"413": 413, "404 sid": 404, "404 route": 404, "409": 409, "held chunk": 200,
            "opens": [200, 200, 503]}
    if codes != want or capacity != 4:
        raise AssertionError(f"[server] codes {codes} (capacity {capacity}), want {want} "
                             "(capacity 4)")
    return codes


def server_offline(base: str, engine: ARTAvatarInferEngine, audio: np.ndarray) -> dict:
    """Phase 25's offline routes on phase 5's 10 s audio: /v1/motion equals
    engine.inference to 1e-5; /v1/video?shape_id=mesh returns 250 frames at
    512x512 (the file it names, byte for byte) with at least 250 rasterizer
    launches during the request."""
    offline = engine.inference(audio)
    t0 = time.perf_counter()
    status, body = http(f"{base}/v1/motion", "POST", audio.tobytes())
    ms_motion = (time.perf_counter() - t0) * 1e3
    motion_err = float(np.abs(np.asarray(body["motion"], np.float32) - offline).max())
    if status != 200 or body["frames"] != 250 or motion_err > 1e-5:
        raise AssertionError(f"[server] /v1/motion {status}, {body.get('frames')} frames, "
                             f"max abs err {motion_err:.3g}")
    zero_launches()
    t0 = time.perf_counter()
    status, headers, video = http_raw(f"{base}/v1/video?shape_id=mesh", "POST",
                                      audio.tobytes())
    ms_video = (time.perf_counter() - t0) * 1e3
    raster = since_zero()["rasterize"]
    path = headers.get("X-Video-Path", "")
    with open(path, "rb") as f:
        same = f.read() == video
    frames = read_y4m(path)[0].shape if path.endswith(".y4m") else None
    if (status != 200 or not same or raster < 250
            or frames not in (None, (250, IMAGE * 3 // 2, IMAGE))):
        raise AssertionError(f"[server] /v1/video {status}, file equal {same}, frames "
                             f"{frames}, {raster} rasterizer launches")
    return {"ms_motion": ms_motion, "motion_err": motion_err, "ms_video": ms_video,
            "video": f"{headers['X-Video-Format']} {len(video)} bytes, frames {frames}",
            "raster_launches": raster}


def phase_server(engine: ARTAvatarInferEngine, audio: np.ndarray) -> dict:
    """Phase 25: MotionServer over the int8 engine at full width, through
    HTTP on this host."""
    from artalk_tpu_torch.server import MotionServer

    server = MotionServer(engine, capacity=2, max_sessions=4, tick_ms=SERVER_TICK_MS)
    base = f"http://127.0.0.1:{server.start(port=0)}"
    try:
        status, health = http(f"{base}/healthz")
        if status != 200 or health["device_name"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"[server] /healthz {status} {health}")
        sids = tuple(http(f"{base}/v1/sessions", "POST", b"{}")[1]["sid"] for _ in range(2))
        ticks = server_ticks(server, base, engine, sids)
        codes = server_codes(server, base, sids)
        offline = server_offline(base, engine, audio)
    finally:
        server.close()
    print(f"[server] {health['device_name']}, int8, capacity 2 (max 4), tick "
          f"{SERVER_TICK_MS:.0f} ms: chunk request {ticks['ms_chunk_1']:.2f} ms at 1 session, "
          f"{ticks['ms_chunk_2']:.2f} ms at 2 (host clock, aggregation included); pool steps "
          f"{ticks['steps']}; launches over 4 ticks {ticks['launches']}; rows vs a fresh pool "
          f"max abs err {ticks['iso_err']:.3g}; codes {codes}")
    print(f"[server] /v1/motion (10 s) {offline['ms_motion']:.1f} ms, max abs err vs "
          f"engine.inference {offline['motion_err']:.3g}; /v1/video?shape_id=mesh "
          f"{offline['ms_video']:.1f} ms, {offline['video']}, {offline['raster_launches']} "
          "rasterizer launches")
    return {**ticks, **offline}


def phase_sampled(engine: ARTAvatarInferEngine, audio: np.ndarray, tag: str) -> dict:
    """Phase 26: sampled decode through ``generate`` and ``_head_bits``."""
    model, dev = engine.model, engine.device
    ws, levels = model.window_samples, len(model.patch_nums)
    n = math.ceil(len(audio) / ws)
    padded = np.zeros(n * ws, np.float32)
    padded[: len(audio)] = audio
    chunks = torch.from_numpy(padded.reshape(n, 1, ws)).to(dev)
    style = model.encode_style(None)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    greedy = model.generate(chunks, style)
    zero_launches()
    top1 = model.generate(chunks, style, sample_generator=gen(0), top_k=1, top_p=0.0)
    launches = launch_counts()
    seeded = [model.generate(chunks, style, sample_generator=gen(s)) for s in (0, 0, 1)]
    fused = model.cfg.fused_ar
    want = {"ar": levels * n if fused else 0, "encoder": n if fused else 0, "flash": 0}
    if not torch.equal(top1, greedy) or launches != want:
        raise AssertionError(f"[sampled {tag}] top_k=1 vs greedy max abs diff "
                             f"{(top1 - greedy).abs().max().item():.3g}, launches {launches} "
                             f"(want {want})")
    if not torch.equal(seeded[0], seeded[1]) or torch.equal(seeded[0], seeded[2]):
        raise AssertionError(f"[sampled {tag}] seed 0 must repeat and differ from seed 1")

    g = torch.Generator().manual_seed(26)
    b, pn, d = 2, model.patch_nums[-1], model.embed_dim
    feats, scale, shift = (torch.randn((b, pn, d), generator=g).to(dev) for _ in range(3))
    cond = (scale * 0.1, shift * 0.1)
    logits = model._head_logits(feats, cond)
    shares = {}
    for top_p in (0.95, 0.55):
        keep = torch.isfinite(topk_topp_mask(logits, 2, top_p))
        bits = model._head_bits(feats, cond, (gen(3), 2, top_p))
        inside = keep.gather(-1, bits.long()[..., None]).all().item()
        shares[top_p] = keep.all(dim=-1).float().mean().item()
        if not inside:
            raise AssertionError(f"[sampled {tag}] a sampled bit lies outside the mask "
                                 f"(top_p {top_p})")
    if not (shares[0.95] > 0 and shares[0.55] < 1):
        raise AssertionError(f"[sampled {tag}] the mask checks nothing: shares of bits with "
                             f"a choice {shares}")
    print(f"[sampled {tag}] top_k=1 generate equals greedy over {n} windows, launches "
          f"{launches}; seeds repeat and differ; head bits inside the mask, share of bits "
          f"with a choice at top_p 0.95 {shares[0.95]:.4f}, at 0.55 {shares[0.55]:.4f}")
    return {"launches": launches, "choice_share": shares}


def level_bound(model, pack: dict, level: int, cache_bytes: int):
    """(bytes ms, operations ms, operations ms at the fp32 rate) of one AR
    level at B = 1 (``roofline.ar_level_work``): a float32 pack's operations
    at the cheapest rate that keeps its precision, 3xTF32 (the fp32-rate
    bound is printed beside it); bf16 and int8 packs at the bf16
    tensor-core rate. The pack's bytes are checked against the model's."""
    dtype = pack["wqkv"].dtype
    hidden = pack["wfc1"].shape[-1]
    work = roofline.ar_level_work(model.depth, model.embed_dim, hidden, model.num_heads,
                                  model.patch_nums[level], model.prev_len + model.offsets[level],
                                  dtype, cache_bytes)
    have = sum(t.numel() * t.element_size() for t in pack.values())
    want = roofline.pack_bytes(model.depth, model.embed_dim, hidden, dtype,
                               5 * model.embed_dim + hidden + model.num_heads)
    if have != want:
        raise AssertionError(f"AR pack {dtype}: {have} bytes, the work model counts {want}")
    return (roofline.bytes_ms(work.bytes), roofline.matmul_ms(work.flops, dtype),
            roofline.fp32_ms(work.flops))


def library_encoder(model, dtype: torch.dtype) -> torch.nn.Module:
    """torch.nn.TransformerEncoder holding the port's encoder layers: the
    library yardstick of the encoder stack (timed here, used nowhere in the
    port)."""
    cfg = model.cfg.wav2vec
    lay = model.audio_encoder.encoder.layers
    layer = torch.nn.TransformerEncoderLayer(
        cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size, dropout=0.0,
        activation="gelu", norm_first=True, batch_first=True, layer_norm_eps=cfg.layer_norm_eps)
    enc = torch.nn.TransformerEncoder(layer, cfg.num_hidden_layers, enable_nested_tensor=False)
    with torch.no_grad():
        for i, m in enumerate(enc.layers):
            m.self_attn.in_proj_weight.copy_(torch.cat([lay.q.w[i], lay.k.w[i], lay.v.w[i]], 1).T)
            m.self_attn.in_proj_bias.copy_(torch.cat([lay.q.b[i], lay.k.b[i], lay.v.b[i]]))
            m.self_attn.out_proj.weight.copy_(lay.out.w[i].T)
            m.self_attn.out_proj.bias.copy_(lay.out.b[i])
            m.linear1.weight.copy_(lay.fc1.w[i].T)
            m.linear1.bias.copy_(lay.fc1.b[i])
            m.linear2.weight.copy_(lay.fc2.w[i].T)
            m.linear2.bias.copy_(lay.fc2.b[i])
            for norm, src in ((m.norm1, lay.norm1), (m.norm2, lay.norm2)):
                norm.weight.copy_(src.scale[i])
                norm.bias.copy_(src.bias[i])
    return enc.to(model.pos_embed.device, dtype).eval().requires_grad_(False)


def phase_times(model, ar_packs: dict, enc_packs: dict) -> dict:
    """CUDA-event times of both block stacks and their yardsticks at the main
    path's shapes (B = 1), with their bounds."""
    out = {}
    for name, pack in ar_packs.items():
        cache_dtype = torch.float32 if name == "f32" else torch.bfloat16
        cb = 4 if name == "f32" else 2
        ms = plain = bound = old_bound = 0.0
        worst = (0.0, "bytes")
        for level, pn in enumerate(model.patch_nums):
            x, ada, kc, vc, start = ar_inputs(model, 1, level, cache_dtype, seed=300 + level)
            args = dict(start=start, num_heads=model.num_heads)
            k = cuda_ms(lambda: ar_stack.ar_block_stack(x, ada, pack, kc, vc, **args), 20)
            p = cuda_ms(lambda: ar_stack.ar_block_stack_plain(x, ada, pack, kc, vc, **args), 3)
            b_ms, o_ms, fp32_ms = level_bound(model, pack, level, cb)
            stages, _ = ar_stack.stage_times(x, ada, pack, kc, vc, reps=5, **args)
            span = sum(work + wait for work, wait in stages.values())
            print(f"[times] ar {name} level {level} (pn {pn}): kernel {k:.4f} ms, plain "
                  f"{p:.4f} ms, bound {max(b_ms, o_ms):.4f} ms "
                  f"({'bytes' if b_ms >= o_ms else 'operations'}"
                  + (f"; at the fp32 rate {max(b_ms, fp32_ms):.4f}" if name == "f32" else "")
                  + f"), share of the bound {max(b_ms, o_ms) / k:.3f}; stages as CTA 0 sees "
                  f"them over its span of {span:.4f} ms (own work + wait in the barrier after): "
                  + ", ".join(f"{st} {work / span:.3f} + {wait / span:.3f}"
                              for st, (work, wait) in stages.items()))
            ms, plain, bound = ms + k, plain + p, bound + max(b_ms, o_ms)
            old_bound += max(b_ms, fp32_ms)
            worst = max(worst, (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"))
        print(f"[times] ar {name} per window: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound:.4f} ms" + (f" (at the fp32 rate {old_bound:.4f})" if name == "f32" else "")
              + f", share of the bound {bound / ms:.3f}")
        out[f"ar/{name}"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                             "bound_by": worst[1], "library_ms": None}

    heads = model.cfg.wav2vec.num_attention_heads
    x = encoder_input(model)
    lib_ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        lib = library_encoder(model, dtype)
        xl = x.to(dtype)
        with torch.no_grad():
            ref = enc_stack.encoder_block_stack_plain(x, enc_packs["f32"], num_heads=heads)
            diff = (lib(xl).float() - ref).abs().max().item()
            lib_ms[dtype] = cuda_ms(lambda: lib(xl), 10)
        print(f"[times] library TransformerEncoder {dtype}: {lib_ms[dtype]:.4f} ms "
              f"(max abs diff from the float32 plain stack {diff:.3g})")
        del lib
    cfg = model.cfg.wav2vec
    for name, pack in enc_packs.items():
        dtype = pack["wqkv"].dtype
        work = roofline.encoder_window_work(cfg.num_hidden_layers, cfg.hidden_size,
                                            cfg.intermediate_size, x.shape[1], dtype)
        have = sum(v.numel() * v.element_size() for v in pack.values())
        want = roofline.pack_bytes(cfg.num_hidden_layers, cfg.hidden_size,
                                   cfg.intermediate_size, dtype,
                                   9 * cfg.hidden_size + cfg.intermediate_size)
        if have != want:
            raise AssertionError(f"encoder pack {dtype}: {have} bytes, the work model counts "
                                 f"{want}")
        flop = work.flops
        # float32 at the cheapest rate that keeps its precision, 3xTF32 (the
        # fp32-rate bound, fp32_ms, is printed beside it)
        fp32_ms = roofline.fp32_ms(flop)
        o_ms = roofline.matmul_ms(flop, dtype)
        b_ms = roofline.bytes_ms(work.bytes)
        k = cuda_ms(lambda: enc_stack.encoder_block_stack(x, pack, num_heads=heads), 10)
        p = cuda_ms(lambda: enc_stack.encoder_block_stack_plain(x, pack, num_heads=heads), 3)
        lib = lib_ms[torch.float32 if name == "f32" else torch.bfloat16]
        bound = max(b_ms, o_ms)
        print(f"[times] encoder {name} per window: kernel {k:.4f} ms, plain {p:.4f} ms, "
              f"library {lib:.4f} ms, bound {bound:.4f} ms ({b_ms:.4f} bytes, {o_ms:.4f} "
              f"operations; {flop / 1e9:.1f} GFLOP"
              + (f"; at the fp32 rate {fp32_ms:.4f}" if name == "f32" else "")
              + f"), share of the bound {bound / k:.3f}")
        out[f"encoder/{name}"] = {"ms": k, "plain_ms": p, "bound_ms": bound,
                                  "bound_by": "bytes" if b_ms >= o_ms else "operations",
                                  "library_ms": lib}
    return out


def engine_counters() -> str:
    """The block stacks' launches by pack and their folded products so far."""
    return ", ".join(f"{k} {n}" for k, n in launches().items()
                     if k.startswith(("ar_block_stack/", "encoder_block_stack/")))


def phase_serving_times(model, ar_pack: dict, enc_pack: dict) -> dict:
    """Phase 10 at the stream cells' shapes: the int8 packs' kernels per AR
    level at B = 1 and SERVING_AR_BATCHES and the encoder at B = 1 and
    SERVING_ENCODER_BATCH windows, each beside its bound at that batch (the
    weights once, the tokens' bytes and FLOPs times B), and the engine and
    fold counters."""
    out = {}
    dtype = ar_pack["wqkv"].dtype
    hidden = ar_pack["wfc1"].shape[-1]
    pack_b = roofline.pack_bytes(model.depth, model.embed_dim, hidden, dtype,
                                 5 * model.embed_dim + hidden + model.num_heads)
    for b in (1, *SERVING_AR_BATCHES):
        ms = bound = 0.0
        parts = []
        for level, pn in enumerate(model.patch_nums):
            x, ada, kc, vc, start = ar_inputs_on_card(model, b, level, seed=600 + level)
            args = dict(start=start, num_heads=model.num_heads)
            k = cuda_ms(lambda: ar_stack.ar_block_stack(x, ada, ar_pack, kc, vc, **args),
                        20 if b == 1 else 3)
            work = roofline.ar_level_work(model.depth, model.embed_dim, hidden, model.num_heads,
                                          pn, start, dtype, 2)
            lb = max(roofline.bytes_ms(pack_b + b * (work.bytes - pack_b)),
                     roofline.matmul_ms(b * work.flops, dtype))
            parts.append(f"pn {pn} {k:.4f} ms (bound {lb:.4f}, {lb / k:.3f})")
            ms, bound = ms + k, bound + lb
            del x, ada, kc, vc
            torch.cuda.empty_cache()
        print(f"[times] ar int8 at B = {b}: {ms:.4f} ms a window, bound {bound:.4f} ms, share "
              f"{bound / ms:.3f}; " + ", ".join(parts))
        out[f"ar/int8/B{b}"] = {"ms": ms, "bound_ms": bound}
    cfg = model.cfg.wav2vec
    heads = cfg.num_attention_heads
    t = model.audio_encoder.num_output_frames(model.window_samples)
    g = torch.Generator(device=model.pos_embed.device).manual_seed(220)
    x = torch.randn((SERVING_ENCODER_BATCH, t, cfg.hidden_size), generator=g,
                    device=model.pos_embed.device) * 0.5
    dtype = enc_pack["wqkv"].dtype
    for b in (1, SERVING_ENCODER_BATCH):
        work = roofline.encoder_window_work(cfg.num_hidden_layers, cfg.hidden_size,
                                            cfg.intermediate_size, t, dtype)
        pack_b = roofline.pack_bytes(cfg.num_hidden_layers, cfg.hidden_size,
                                     cfg.intermediate_size, dtype,
                                     9 * cfg.hidden_size + cfg.intermediate_size)
        lb = max(roofline.bytes_ms(pack_b + b * (work.bytes - pack_b)),
                 roofline.matmul_ms(b * work.flops, dtype))
        k = cuda_ms(lambda: enc_stack.encoder_block_stack(x[:b], enc_pack, num_heads=heads),
                    10 if b == 1 else 3)
        print(f"[times] encoder int8 at B = {b}: {k:.4f} ms, bound {lb:.4f} ms, share "
              f"{lb / k:.3f}")
        out[f"encoder/int8/B{b}"] = {"ms": k, "bound_ms": lb}
    print(f"[times] {engine_counters()}")
    return out


def phase_gaga(mode: str, dev: torch.device, audio: np.ndarray, motions: np.ndarray):
    """The GAGAvatar path in one precision mode at full width through the
    engine's entry points (inference of ``audio`` and rendering), then
    ``motions`` (phase 5's) rendered in one call and in two halves. Returns
    the engine, the one-call frames and the numbers."""
    engine = build_engine(dev, {"ARTALK_GAGA_PRECISION": mode}, tcfg.ModelConfig(),
                          load_gaga=True)
    gaga = engine.gagavatar
    if gaga.bf16 != (mode == "fast"):
        raise AssertionError(f"[gaga {mode}] bf16 SR and colors {gaga.bf16}")
    n_params = sum(p.numel() for p in gaga.nets.parameters())
    torch.cuda.synchronize()

    zero_launches()
    t0 = time.perf_counter()
    own = engine.inference(audio)
    out_path = engine.rendering(audio, own, shape_id="synthetic_0",
                                save_name=f"chip_smoke_gaga_{mode}")
    t_path = time.perf_counter() - t0
    c = since_zero()
    launches = {"gsplat": c["gsplat"], "sort": c["sort"], "sort CUDA launches": c["sort/cuda"],
                "rasterize": c["rasterize"], "ar": c["ar"], "encoder": c["encoder"]}
    n, size = len(motions), CAM_PARAMS["size"]
    n_frames = rendered_frames(out_path)
    if n_frames not in (None, len(own)) or len(own) != n:
        raise AssertionError(f"[gaga {mode}] rendered {n_frames} frames of {len(own)} motions")
    if launches["gsplat"] < n or launches["sort"] < n or launches["rasterize"]:
        raise AssertionError(f"[gaga {mode}] launches {launches}: want >= {n} splats and "
                             f">= {n} sorts, no rasterizer")

    flame = engine.gagavatar_flame
    t0 = time.perf_counter()
    whole = gaga.render_motion_sequence("synthetic_0", motions, flame, colorspace="yuv420")
    t_frames = time.perf_counter() - t0
    half = n // 2 // 25 * 25   # on a chunk boundary
    halves = np.concatenate([
        gaga.render_motion_sequence("synthetic_0", motions[:half], flame, colorspace="yuv420"),
        gaga.render_motion_sequence(None, motions[half:], flame, colorspace="yuv420")])
    halves_diff = int(np.abs(halves.astype(np.int16) - whole.astype(np.int16)).max())
    spread = float(whole[:, :size].astype(np.float32).std())
    print(f"[gaga {mode}] networks {n_params / 1e6:.1f} M params (random, seed 0); "
          f"inference + rendering of {len(own)} frames {t_path:.2f} s "
          f"({t_path * 1e3 / len(own):.2f} ms/frame), launches {launches}; "
          f"render_motion_sequence alone {t_frames * 1e3 / len(motions):.2f} ms/frame; "
          f"two halves vs one call max |diff| {halves_diff} LSB; luma std {spread:.2f}")
    print(f"[gaga {mode}] wrote {out_path} "
          f"({n_frames if n_frames is not None else 'encoded'} frames)")
    if whole.shape != (n, size * 3 // 2, size) or whole.dtype != np.uint8:
        raise AssertionError(f"[gaga {mode}] frames {whole.shape} {whole.dtype}")
    if halves_diff:
        raise AssertionError(f"[gaga {mode}] two halves differ from one call by {halves_diff}")
    if spread < 1.0:
        raise AssertionError(f"[gaga {mode}] blank frames (luma std {spread:.3g})")
    return engine, whole, {"launches": launches["gsplat"], "sort_launches": launches["sort"],
                           "ms_frame": t_frames * 1e3 / len(motions)}


def avatar_splat_scene(engine: ARTAvatarInferEngine) -> list:
    """The synthetic_0 avatar's gaussians at the neutral pose: the splat
    arguments of one frame of the main path."""
    gaga = engine.gagavatar
    gaga.set_avatar_id("synthetic_0")
    gaga._build_gs_params()
    return bench.avatar_splat_scene(gaga, engine.gagavatar_flame)


def reversed_tiles(inst: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """A planted fault: each tile's instance list back to front."""
    off = offsets.long()
    tile = torch.repeat_interleave(torch.arange(len(off) - 1, device=off.device), off.diff())
    pos = torch.arange(len(inst), device=inst.device)
    return inst[off[tile] + off[tile + 1] - 1 - pos]


def unclamped_prepass(args: list, bf16: bool):
    """A planted fault: the prepass without the MAX_RX / MAX_RY emission
    clamp, so a splat larger than the 2x4-tile window loses its far tiles
    instead of being cropped to its centre."""
    saved = gsplat.MAX_RX, gsplat.MAX_RY
    gsplat.MAX_RX = gsplat.MAX_RY = float("inf")
    try:
        return gsplat.prepass(*args, size=CAM_PARAMS["size"], bf16_colors=bf16)
    finally:
        gsplat.MAX_RX, gsplat.MAX_RY = saved


def without_alpha_cut(fn):
    """A planted fault: ``fn()`` with the 1/255 alpha cut dropped, so every
    faint tail of a splat is composited."""
    saved = gsplat.ALPHA_EPS
    gsplat.ALPHA_EPS = 0.0
    try:
        return fn()
    finally:
        gsplat.ALPHA_EPS = saved


def phase_splat(scenes: dict) -> dict:
    """The splat kernel against splat_tiles_plain on each full-width scene
    with float32 and bf16 colors, and the planted faults against the limit.
    Returns the max abs error per color type."""
    size = CAM_PARAMS["size"]
    errs = dict.fromkeys(GAGA_MODES.values(), 0.0)
    for scene, args in scenes.items():
        for colors, bf16 in (("f32", False), ("bf16", True)):
            geo, cols, inst, offsets = gsplat.prepass(*args, size=size, bf16_colors=bf16)
            got = gsplat.splat_tiles(geo, cols, inst, offsets, size)
            want = gsplat.splat_tiles_plain(geo, cols, inst, offsets, size)
            torch.cuda.synchronize()
            top = cols.float().abs().max().item()
            err = (got - want).abs().max().item()
            far = ((got - want).abs() > SPLAT_NEAR * top).float().mean().item()
            faults = {"order reversed": gsplat.splat_tiles_plain(
                geo, cols, reversed_tiles(inst, offsets), offsets, size),
                "alpha cut dropped": without_alpha_cut(
                    lambda: gsplat.splat_tiles_plain(geo, cols, inst, offsets, size))}
            if scene == "avatar":
                faults["culling box shrunk 1 px"] = gsplat.composite_plain(
                    geo, cols, inst, offsets, size,
                    keep=gsplat.block_culling(geo, inst, offsets, size, shrink=1.0))[0]
            ugeo, ucols, uinst, uoffsets = unclamped_prepass(args, bf16)
            if not torch.equal(uoffsets, offsets) or not torch.equal(uinst, inst):
                faults["clamp dropped"] = gsplat.splat_tiles_plain(ugeo, ucols, uinst, uoffsets,
                                                                   size)
            rel = {f: (bad - want).abs().max().item() / top for f, bad in faults.items()}
            ms = cuda_ms(lambda: gsplat.splat_tiles(geo, cols, inst, offsets, size), 20)
            counts = offsets.diff()
            print(f"[splat] {scene}, {colors} colors: {geo.shape[0]} gaussians, {len(inst)} "
                  f"instances (largest tile {counts.max().item()}, median "
                  f"{counts.median().item()}); kernel vs plain max abs err {err:.3g} "
                  f"= {err / top:.3g} of the largest |color| {top:.3g} (limit {SPLAT_TOL}), "
                  f"share of values beyond {SPLAT_NEAR} of it {far:.3g} (limit "
                  f"{SPLAT_FAR_SHARE}); "
                  "planted faults: " + ", ".join(f"{f} {r:.3g}" for f, r in rel.items())
                  + ("" if "clamp dropped" in rel else "; the clamp changes no list here")
                  + f"; kernel {ms:.4f} ms")
            if not torch.isfinite(got).all():
                raise AssertionError(f"[splat] {scene} {colors}: non-finite output")
            if err > SPLAT_TOL * top or far > SPLAT_FAR_SHARE:
                raise AssertionError(f"[splat] {scene} {colors}: kernel off the plain version")
            if min(rel.values()) <= SPLAT_TOL:
                raise AssertionError(f"[splat] {scene} {colors}: a planted fault passes: {rel}")
            errs[colors] = max(errs[colors], err)
    return errs


def profile_calls(fn, label: str, reps: int = 5) -> None:
    """torch.profiler over ``reps`` calls of ``fn``: the device's busy share
    of the host clock, the kernels launched per call, and the kernels that
    take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"[profile] {label}: {reps} calls, device busy {busy_us / wall_us:.3f} of "
          f"the host clock ({busy_us / reps / 1e3:.4f} of {wall_us / reps / 1e3:.4f} ms per "
          f"call), {launches / reps:.0f} device activities per call; most device time: "
          + "; ".join(f"{name[:60]} {us / reps / 1e3:.4f} ms x{n // reps}"
                      for name, (n, us) in top))


def phase_gaga_times(engine: ARTAvatarInferEngine, colors: str) -> dict:
    """CUDA-event times of one GAGAvatar frame's parts on the avatar scene,
    and the splat kernel's bound from this frame's instance lists."""
    gaga = engine.gagavatar
    size = CAM_PARAMS["size"]
    args = avatar_splat_scene(engine)
    bf16 = gaga.bf16
    prep_ms = cuda_ms(lambda: gsplat.prepass(*args, size=size, bf16_colors=bf16), 10)
    prep_lib_ms = cuda_ms(lambda: prepass_with_sort(args, lambda k: torch.sort(k).values, bf16),
                          10)
    geo, cols, inst, offsets = gsplat.prepass(*args, size=size, bf16_colors=bf16)
    kernel_ms = cuda_ms(lambda: gsplat.splat_tiles(geo, cols, inst, offsets, size), 50)
    plain_ms = cuda_ms(lambda: gsplat.splat_tiles_plain(geo, cols, inst, offsets, size), 2)
    render = gsplat.splat_tiles(geo, cols, inst, offsets, size)
    sr_dtype = torch.bfloat16 if bf16 else None
    with torch.no_grad():
        sr_ms = cuda_ms(lambda: gaga._upsampler(render[None], compute_dtype=sr_dtype), 10)
    frame_ms = cuda_ms(lambda: gaga._frame(args[0][:NUM_FLAME_VERTS], args[5]), 10)
    profile_calls(lambda: gaga._frame(args[0][:NUM_FLAME_VERTS], args[5]), f"gaga {colors} frame")
    _, evaluated, composited = gsplat.composite_plain(geo, cols, inst, offsets, size)
    evaluated, composited = int(evaluated), int(composited)
    # the alpha evaluations the kernel's per-block culled lists imply before
    # the pixels stop, by the plain culling rule
    keep = gsplat.block_culling(geo, inst, offsets, size)
    culled = int(gsplat.composite_plain(geo, cols, inst, offsets, size, keep=keep)[1])
    work = roofline.splat_work(geo.shape[0], cols.element_size(), inst.numel(),
                               offsets.numel(), size, composited)
    moved = work.bytes
    bytes_ms, ops_ms = roofline.bytes_ms(work.bytes), roofline.fp32_ms(work.flops)
    bound = max(bytes_ms, ops_ms)
    print(f"[times] gaga {colors} colors, SR {'bf16' if bf16 else 'float32'}, per "
          f"frame: splat kernel {kernel_ms:.4f} ms, splat_tiles_plain {plain_ms:.2f} ms, "
          f"prepass {prep_ms:.4f} ms (with torch.sort in place of the sort kernel "
          f"{prep_lib_ms:.4f} ms), SR {sr_ms:.4f} ms, whole frame (prepass + splat + SR + clip) "
          f"{frame_ms:.4f} ms")
    print(f"[times] gsplat/{colors} bound: {moved} bytes -> {bytes_ms:.5f} ms; "
          f"{composited} composites x ({SPLAT_EVAL_FLOP} + {SPLAT_COMPOSITE_FLOP}) FLOP -> "
          f"{ops_ms:.5f} ms; the kernel reaches {bound / kernel_ms:.3f} of the bound "
          f"(the tile design evaluates {evaluated} pairs of its listed tiles before the "
          f"pixels stop, {evaluated / composited:.2f} per composite; the per-block culled lists, "
          f"which keep {keep.float().mean().item():.4f} of the (block, instance) pairs, "
          f"{culled}, {culled / composited:.2f} per composite)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None,
            "prepass_ms": prep_ms, "prepass_torch_sort_ms": prep_lib_ms, "sr_ms": sr_ms,
            "frame_ms": frame_ms}


def phase_gaga_all(dev: torch.device, audio: np.ndarray, motions: np.ndarray):
    """Phases 11-13: the GAGAvatar path per precision mode, the splat kernel
    on both scenes, the times. Returns the kernels-line fields per color
    type, the sort launches of phase 11's exact run and the two scenes."""
    frames, gaga, times, splat_scenes = {}, {}, {}, {"bench": bench.bench_splat_scene(dev)}
    for mode, colors in GAGA_MODES.items():
        torch.cuda.empty_cache()
        engine, frames[mode], gaga[mode] = phase_gaga(mode, dev, audio, motions)
        times[colors] = phase_gaga_times(engine, colors)
        if mode == "exact":
            splat_scenes["avatar"] = avatar_splat_scene(engine)
        del engine
    diff = np.abs(frames["fast"].astype(np.int16) - frames["exact"].astype(np.int16))
    reading = {"max": int(diff.max()), "mean": float(diff.mean())}
    print(f"[gaga] fast vs exact frames: max |diff| {reading['max']} LSB, mean "
          f"{reading['mean']:.4f} LSB, {float((diff > 2).mean()):.5f} of the values beyond 2 "
          f"LSB (limits {GAGA_FAST_LSB})")
    if any(reading[k] > lim for k, lim in GAGA_FAST_LSB.items()):
        raise AssertionError(f"fast GAGAvatar frames off the exact ones: {reading}")
    errs = phase_splat(splat_scenes)
    fields = {colors: {"launches": gaga[mode]["launches"], "max_abs_err": errs[colors],
                       **{k: v for k, v in times[colors].items()
                          if k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                       "ms_frame": gaga[mode]["ms_frame"]}
              for mode, colors in GAGA_MODES.items()}
    return fields, gaga["exact"]["sort_launches"], splat_scenes


def flash_inputs(b: int, h: int, lq: int, lk: int, hd: int, dev: torch.device,
                 dtype: torch.dtype = torch.float32, seed: int = 0) -> list:
    """Seeded standard-normal q (B, H, Lq, hd), k and v (B, H, Lk, hd)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev, dtype)
            for shape in ((b, h, lq, hd), (b, h, lk, hd), (b, h, lk, hd))]


def flash_cases(dev: torch.device):
    """(name, q, k, v, bias, scale) in float32: both model sites,
    tests/test_attention.py's bias and padding cases, a wholly masked row,
    the longest sweep length and a grid large enough for the row-block
    kernel."""
    lvl = torch.tensor([0, 1, 1, 2, 2, 2, 3, 3])
    var = torch.cat([torch.zeros(8, 8), torch.where(lvl[:, None] >= lvl[None], 0.0,
                                                    float("-inf"))], dim=1)[None, None]
    masked = torch.zeros((1, 1, 20, 70))
    masked[..., 3, :] = float("-inf")
    yield "wav2vec (1,16,199,64)", *flash_inputs(1, 16, 199, 199, 64, dev), None, 0.125
    yield "hubert (1,12,199,64)", *flash_inputs(1, 12, 199, 199, 64, dev, seed=1), None, 0.125
    yield "no bias (2,3,181,362,64)", *flash_inputs(2, 3, 181, 362, 64, dev, seed=2), None, 0.125
    yield "VAR mask (2,3,8,16,64)", *flash_inputs(2, 3, 8, 16, 64, dev, seed=3), var.to(dev), 1.0
    for i, (lq, lk) in enumerate(((100, 100), (181, 362), (57, 300))):
        yield (f"padding {lq}/{lk}", *flash_inputs(1, 2, lq, lk, 64, dev, seed=4 + i), None,
               0.2)
    yield "long (1,1,256,640,32)", *flash_inputs(1, 1, 256, 640, 32, dev, seed=7), None, 0.1
    yield ("masked row (1,2,20,70,64)", *flash_inputs(1, 2, 20, 70, 64, dev, seed=8),
           masked.to(dev), 0.125)
    yield "sweep (1,16,4096,64)", *flash_inputs(1, 16, 4096, 4096, 64, dev, seed=9), None, 0.125
    # more than half a CTA per SM: the row-block kernel (the cases above but the
    # sweep take the split-keys kernel) with a bias, a ragged tile and a
    # wholly masked row
    many = torch.randn((8, 1, 100, 130), generator=torch.Generator().manual_seed(12))
    many[:, :, 3] = float("-inf")
    yield ("row blocks (8,20,100,130,64)", *flash_inputs(8, 20, 100, 130, 64, dev, seed=12),
           many.to(dev), 0.125)


def tiled_flash(q, k, v, bias, scale: float, rescale: bool = True,
                mask_tail: bool = True) -> torch.Tensor:
    """The kernel's tile loop in plain torch (FLASH_TILE keys a tile, the
    running max from -1e30), so that faults can be planted in it:
    ``rescale=False`` drops the online rescale alpha, ``mask_tail=False``
    lets the ragged last tile's missing keys (zero k and v) into the
    softmax."""
    lk = k.shape[2]
    pad = -lk % FLASH_TILE
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    s = torch.matmul(q.float() * scale, kf.transpose(-1, -2))
    if bias is not None:
        s[..., :lk] += bias
    if mask_tail:
        s[..., lk:] = float("-inf")
    m = torch.full(s.shape[:-1] + (1,), attention.NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=q.device)
    for t in range(0, lk + pad, FLASH_TILE):
        st = s[..., t:t + FLASH_TILE]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.exp(st - m_new)
        alpha = torch.exp(m - m_new) if rescale else torch.ones_like(m)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[..., t:t + FLASH_TILE, :])
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


def phase_flash_kernel(dev: torch.device) -> dict:
    """The flash kernel against its plain version on every case, float32 and
    bf16; planted faults; gradients. Returns the max abs error per dtype."""
    errs = {"f32": 0.0, "bf16": 0.0}
    for name, q, k, v, bias, scale in flash_cases(dev):
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            got = attention.flash_attention(qd, kd, vd, bias, scale=scale)
            want = attention.flash_attention_plain(qd, kd, vd, bias, scale=scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got).all() or got.dtype != dtype or got.shape != q.shape:
                raise AssertionError(f"[flash] {name} {tag}: {got.dtype} {tuple(got.shape)}, "
                                     f"finite={bool(torch.isfinite(got).all())}")
            if bias is not None and torch.isinf(bias).all(dim=-1).any():
                rows = torch.isinf(bias).all(dim=-1).expand(got.shape[:-1])
                if got[rows].abs().max().item() != 0.0:
                    raise AssertionError(f"[flash] {name} {tag}: a wholly masked row is not 0")
            if tag == "f32":
                ok, shown = err <= FLASH_F32_TOL, f"max abs err {err:.3g}"
            else:
                ulps = bf16_ulps_of_max(got, want)
                ok, shown = ulps <= 1.0, f"max abs err {err:.3g} = {ulps:.3g} bf16 ulps"
            print(f"[flash] {name} {tag}: {shown}")
            if not ok:
                raise AssertionError(f"[flash] {name} {tag} off the plain version: {shown}")
            errs[tag] = max(errs[tag], err)
    q, k, v = flash_inputs(1, 16, 199, 199, 64, dev)
    want = attention.flash_attention_plain(q, k, v, scale=0.125)
    tiled = (tiled_flash(q, k, v, None, 0.125) - want).abs().max().item()
    faults = {"alpha dropped": tiled_flash(q, k, v, None, 0.125, rescale=False),
              "tail mask dropped": tiled_flash(q, k, v, None, 0.125, mask_tail=False)}
    fault_err = {f: (bad - want).abs().max().item() for f, bad in faults.items()}
    print(f"[flash] wav2vec site f32, the tile loop in plain torch: {tiled:.3g} (limit "
          f"{FLASH_F32_TOL}); planted faults: "
          + ", ".join(f"{f} {e:.3g}" for f, e in fault_err.items()))
    if tiled > FLASH_F32_TOL or min(fault_err.values()) <= FLASH_F32_TOL:
        raise AssertionError(f"[flash] the limit does not separate the planted faults: "
                             f"{tiled:.3g}, {fault_err}")
    g = torch.Generator().manual_seed(10)
    arrays = [torch.randn(shape, generator=g) for shape in
              ((1, 2, 32, 16), (1, 2, 48, 16), (1, 2, 48, 16), (1, 1, 32, 48))]
    arrays += flash_inputs(1, 16, 199, 199, 64, torch.device("cpu"), seed=11) + [None]
    grad_err = 0.0
    for args in (arrays[:4], arrays[4:]):
        grads = []
        for fn in (attention.flash_attention, attention.flash_attention_plain):
            leaves = [None if a is None else a.to(dev).requires_grad_() for a in args]
            o = fn(*leaves[:3], leaves[3], scale=0.25)
            (o * torch.cos(o)).sum().backward()
            grads.append([t.grad for t in leaves if t is not None])
        for gk, gp in zip(*grads):
            if gk.shape != gp.shape:
                raise AssertionError(f"[flash] gradient shape {gk.shape} vs {gp.shape}")
            grad_err = max(grad_err, (gk - gp).abs().max().item())
    print(f"[flash] gradients (q, k, v, bias) vs the plain version: max abs err {grad_err:.3g} "
          "(limit 3e-5)")
    if grad_err > 3e-5:
        raise AssertionError(f"[flash] gradients off by {grad_err:.3g}")
    return errs


def phase_flash_path(mode: str, dev: torch.device, exact_bits: np.ndarray,
                     audio: np.ndarray) -> dict:
    """The flash wav2vec2 path at full width in one mode through the engine's
    entry points."""
    config = tcfg.ModelConfig(wav2vec=tcfg.Wav2VecConfig(use_flash_attention=True))
    engine = build_engine(dev, FLASH_MODES[mode], config)
    run = drive(engine, audio, f"flash {mode}")
    fused, n = engine.cfg.fused_ar, run["n_windows"]
    layers, levels = config.wav2vec.num_hidden_layers, len(engine.model.patch_nums)
    check_launches(f"flash {mode}", run, {"ar": levels * n if fused else 0,
                                          "encoder": n if fused else 0,
                                          "flash": 0 if fused else layers * n})
    frames = None
    if not fused:
        frames = render_mesh(engine, audio, run["motions"], f"chip_smoke_flash_{mode}")[1]
    agree = float((window0_bits(engine.model, audio) == exact_bits).mean())
    print(f"[flash {mode}] inference {run['ms_window']:.2f} ms/window; stream vs offline max "
          f"abs err {run['stream_err']:.3g}; launches per {n} windows: inference "
          f"{run['launches']}, stream {run['stream_launches']}; rendered "
          f"{frames if frames is not None else ('encoded' if not fused else 'not rendered')} "
          f"frames; window-0 code bits agreeing with phase 5's exact {agree:.4f} (limit "
          f"{FLASH_BITS_AGREE[mode]})")
    if agree < FLASH_BITS_AGREE[mode]:
        raise AssertionError(f"[flash {mode}] only {agree:.4f} of the code bits agree")
    return {"ms_window": run["ms_window"], "launches": run["launches"], "agree": agree}


def phase_hubert(dev: torch.device, audio: np.ndarray) -> dict:
    """HuBERT base at full width, flash off and on (same weights), with and
    without frame_num, on the first 4 s of ``audio``."""
    cfg = tcfg.hubert_base_config()
    plain = HubertEncoder(cfg).init(torch.Generator().manual_seed(0)).requires_grad_(False)
    flash = HubertEncoder(dataclasses.replace(cfg, use_flash_attention=True))
    flash.load_state_dict(plain.state_dict())
    plain, flash = plain.to(dev), flash.requires_grad_(False).to(dev)
    x = torch.from_numpy(audio[None, :64000]).to(dev)
    out = {}
    for frame_num in (None, 100):
        zero_launches()
        got = flash(x, frame_num)
        torch.cuda.synchronize()
        launches = since_zero()["flash"]
        want = plain(x, frame_num)
        torch.cuda.synchronize()
        plain_launches = since_zero()["flash"] - launches
        frames = frame_num or cfg.num_output_frames(64000)
        diff = (got - want).abs().max().item()
        print(f"[hubert] frame_num {frame_num}: out {tuple(got.shape)}, flash launches "
              f"{launches} (plain softmax {plain_launches}), flash vs plain softmax max abs "
              f"diff {diff:.3g} (limit {HUBERT_FLASH_TOL})")
        if got.shape != (1, frames, cfg.hidden_size) or not torch.isfinite(got).all():
            raise AssertionError(f"[hubert] output {tuple(got.shape)}")
        if launches != cfg.num_hidden_layers or plain_launches:
            raise AssertionError(f"[hubert] {launches} flash launches, want "
                                 f"{cfg.num_hidden_layers}; plain softmax {plain_launches}")
        if diff > HUBERT_FLASH_TOL:
            raise AssertionError(f"[hubert] flash vs plain softmax {diff:.3g}")
        ms = {"flash": cuda_ms(lambda: flash(x, frame_num), 5),
              "plain": cuda_ms(lambda: plain(x, frame_num), 5)}
        print(f"[hubert] frame_num {frame_num}: ms per call flash {ms['flash']:.3f}, plain "
              f"softmax {ms['plain']:.3f}")
        out[frame_num] = {"launches": launches, "diff": diff, **ms}
    return out


def rvq_first_flip_gaps(enc, audio_24k: torch.Tensor, card_codes: torch.Tensor) -> list:
    """Walk ``enc``'s residual quantizers (on the CPU) and, in each frame's
    residual chain, at the first stage whose CPU code differs from
    ``card_codes``: the gap between the squared distances of the two codes,
    over the CPU code's distance."""
    cfg = enc.cfg
    emb = enc.seanet_encode(audio_24k)
    emb = enc.transform(emb.transpose(1, 2)).transpose(1, 2)
    emb = tmimi._causal_conv(enc.downsample, emb, stride=2, pad_mode="replicate")
    gaps, ns = [], cfg.num_semantic_quantizers
    for rvq, card in ((enc.semantic_rvq, card_codes[0, :ns]), (enc.acoustic_rvq,
                                                               card_codes[0, ns:])):
        residual = torch.einsum("oi,bit->bto", rvq.input_proj.w[..., 0], emb)[0]
        flipped = torch.zeros(residual.shape[0], dtype=torch.bool)
        for stage, book in enumerate(rvq.codebooks()):
            d2 = (residual.square().sum(-1, keepdim=True) - 2.0 * residual @ book.T
                  + book.square().sum(-1)[None])
            idx = torch.argmin(d2, dim=-1)
            frames = torch.nonzero((idx != card[stage]) & ~flipped).flatten()
            for t in frames.tolist():
                best = d2[t, idx[t]].item()
                gaps.append((d2[t, card[stage, t]].item() - best) / abs(best))
            flipped |= idx != card[stage]
            residual = residual - book[idx]
    return gaps


def phase_mimi(mode: str, dev: torch.device, audio: np.ndarray) -> dict:
    """The Mimi-conditioned path at full width in one mode through the
    engine's entry points; in exact mode also window 0's RVQ codes against
    the same weights on the CPU."""
    engine = build_engine(dev, MIMI_MODES[mode],
                          tcfg.ModelConfig(ar=tcfg.ARConfig(audio_encoder="mimi")))
    run = drive(engine, audio, f"mimi {mode}")
    n, levels = run["n_windows"], len(engine.model.patch_nums)
    check_launches(f"mimi {mode}", run, {"ar": levels * n if engine.cfg.fused_ar else 0,
                                         "encoder": 0, "flash": 0})
    enc = engine.model.audio_encoder
    n_params = sum(p.numel() for p in enc.parameters())
    codes = {}
    if mode == "exact":
        chunk = torch.from_numpy(audio[None, : engine.model.window_samples])
        with torch.no_grad():
            card = enc.encode_codes(tmimi.resample_16k_to_24k(chunk.to(dev))).cpu()
            cpu_enc = copy.deepcopy(enc).cpu()
            a24 = tmimi.resample_16k_to_24k(chunk)
            cpu = cpu_enc.encode_codes(a24)
            gaps = rvq_first_flip_gaps(cpu_enc, a24, card)
        agree = float((card == cpu).float().mean())
        codes = {"agree": agree, "gaps": gaps}
        print(f"[mimi] window 0 codes {tuple(card.shape)}: card vs CPU agree on {agree:.4f} "
              f"(limit {MIMI_CODES_AGREE}); first flips per residual chain: {len(gaps)}, "
              f"distance gaps {[f'{g:.3g}' for g in gaps]} (limit {MIMI_TIE})")
        if agree < MIMI_CODES_AGREE or any(g > MIMI_TIE for g in gaps):
            raise AssertionError(f"[mimi] card codes off the CPU run: {agree:.4f}, {gaps}")
        del cpu_enc
    print(f"[mimi {mode}] encoder {n_params / 1e6:.1f} M params (random, seed 0); inference "
          f"{run['ms_window']:.2f} ms/window; stream vs offline max abs err "
          f"{run['stream_err']:.3g}; launches per {n} windows: inference {run['launches']}, "
          f"stream {run['stream_launches']}")
    return {"ms_window": run["ms_window"], "launches": run["launches"], **codes}


def sdpa_backend(q, k, v) -> str:
    """The backend scaled_dot_product_attention's dispatcher picks for these
    inputs."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, scale=0.125)).name


def phase_flash_times(dev: torch.device, exact_ms: float) -> dict:
    """CUDA-event times of the flash kernel at both sites and over the
    sweep, beside the plain version, SDPA and the bound. Returns the
    kernels-line fields of the wav2vec site per dtype."""
    out = {}
    fn = attention.LIB.get().artalk_flash_attention
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        sites = [("wav2vec", 16, 199), ("hubert", 12, 199)] + [(f"sweep {n}", 16, n)
                                                                for n in FLASH_SWEEP]
        for site, h, n in sites:
            q, k, v = flash_inputs(1, h, n, n, 64, dev, dtype, seed=20)
            o = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream
            reps = 50 if n <= 1024 else 10
            with torch.no_grad():
                ms = cuda_ms(lambda: attention.flash_attention(q, k, v, scale=0.125), reps)
            alone = cuda_ms(lambda: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), h, h, n, n, 64,
                0.125, 0, 0, 0, 0, int(dtype == torch.bfloat16), stream), reps)
            plain = cuda_ms(lambda: attention.flash_attention_plain(q, k, v, scale=0.125),
                            max(2, reps // 5))
            sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=0.125), reps)
            bytes_ms, ops_ms = roofline.flash_bound(1, h, n, n, 64, dtype)
            bound = max(bytes_ms, ops_ms)
            print(f"[times] flash {tag} {site} (1,{h},{n},64): wrapper {ms:.5f} ms, kernel "
                  f"alone {alone:.5f}, plain {plain:.5f}, sdpa {sdpa:.5f} "
                  f"({sdpa_backend(q, k, v)}), bound {bound:.5f} ({bytes_ms:.5f} bytes, "
                  f"{ops_ms:.5f} operations); the kernel alone reaches {bound / alone:.3f} "
                  "of the bound")
            if bound > alone:
                raise AssertionError(f"[times] flash {tag} {site}: {alone:.5f} ms beats the "
                                     f"bound {bound:.5f} ms: the bound is wrong")
            if site in ("wav2vec", f"sweep {FLASH_SWEEP[-1]}"):
                profile_calls(lambda: attention.flash_attention(q, k, v, scale=0.125),
                              f"flash {tag} {site}", reps=20)
            if site == "wav2vec":
                out[tag] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                            "library_ms": sdpa, "kernel_only_ms": alone}
    print(f"[times] flash f32 at the wav2vec site, 24 layers: "
          f"{24 * out['f32']['ms']:.3f} ms of a window, {24 * out['f32']['ms'] / exact_ms:.4f} "
          f"of phase 5's exact {exact_ms:.2f} ms/window")
    return out


def full_range_keys(n: int, seed: int, dev: torch.device) -> torch.Tensor:
    """Seeded random int32 keys over the full range, a quarter of them
    duplicates, with INT32_MIN first and INT32_MAX last."""
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int64, generator=g)
    if n >= 4:
        keys[: n // 4] = keys[n // 4: 2 * (n // 4)]
        keys[0], keys[-1] = -2 ** 31, 2 ** 31 - 1
    return keys.to(torch.int32).to(dev)


def prepass_with_sort(args: list, sort_fn, bf16: bool = False):
    """The splat prepass of one scene with ``sort_fn`` in place of
    ops/sort.sort_keys."""
    saved = gsplat.sort_keys
    gsplat.sort_keys = sort_fn
    try:
        return gsplat.prepass(*args, size=CAM_PARAMS["size"], bf16_colors=bf16)
    finally:
        gsplat.sort_keys = saved


def instance_keys(args: list) -> torch.Tensor:
    """The int32 instance keys the prepass of one scene hands to the sort."""
    keys = []

    def record(k):
        keys.append(k.clone())
        return sort.sort_keys(k)

    prepass_with_sort(args, record)
    return keys[0]


def phase_sort_kernel(dev: torch.device, scene_keys: dict) -> int:
    """The sort kernel against sort_keys_plain and torch.sort on the scenes'
    instance keys and on random full-range keys at SORT_SIZES: every output
    equal to both, bit for bit. Returns the largest |difference| (0)."""
    cases = dict(scene_keys)
    for i, n in enumerate(SORT_SIZES):
        cases[f"random n={n}"] = full_range_keys(n, 190 + i, dev)
    worst = 0
    for name, keys in cases.items():
        n = keys.shape[0]
        before = since_zero()
        got = sort.sort_keys(keys)
        after = since_zero()
        launched, cuda_launched = (after[k] - before[k] for k in ("sort", "sort/cuda"))
        wants = {"sort_keys_plain": sort.sort_keys_plain(keys),
                 "torch.sort": torch.sort(keys).values}
        torch.cuda.synchronize()
        if (got.dtype != torch.int32 or got.shape != keys.shape or launched != int(n > 0)
                or (cuda_launched > 0) != (n > 0)):
            raise AssertionError(f"[sort] {name}: {got.dtype} {tuple(got.shape)}, "
                                 f"{launched} wrapper launches, {cuda_launched} CUDA launches")
        diffs = {w: (got.long() - want.long()).abs() for w, want in wants.items()}
        mismatches = {w: int((d != 0).sum()) for w, d in diffs.items()}
        print(f"[sort] {name}: {n} keys ({cuda_launched} CUDA launches): mismatches "
              + ", ".join(f"vs {w} {m}" for w, m in mismatches.items()))
        if any(mismatches.values()):
            raise AssertionError(f"[sort] {name}: the kernel's output differs: {mismatches}")
        worst = max([worst] + [int(d.max()) for d in diffs.values() if n])
    return worst


def phase_sort_path(args: list) -> None:
    """One avatar frame's prepass with the sort kernel against the same
    prepass with torch.sort swapped in: equal instance lists and offsets."""
    size = CAM_PARAMS["size"]
    _, _, inst, offsets = gsplat.prepass(*args, size=size)
    _, _, lib_inst, lib_offsets = prepass_with_sort(args, lambda k: torch.sort(k).values)
    equal = torch.equal(inst, lib_inst) and torch.equal(offsets, lib_offsets)
    print(f"[sort path] avatar frame: {len(inst)} instances over {len(offsets) - 1} tiles; "
          f"prepass with the sort kernel equals the prepass with torch.sort: {equal}")
    if not equal:
        raise AssertionError("[sort path] the kernel's prepass differs from torch.sort's")


def phase_debug_renderers(dev: torch.device, flame_data: dict, motions: np.ndarray) -> dict:
    """PointRenderer and TextureRenderer at 512x512 on FLAME vertices of
    DEBUG_FRAMES of phase 5's motions, on the card and on the CPU."""
    cpu = torch.device("cpu")
    frames = len(motions[:DEBUG_FRAMES])
    flame = FlameModel(flame_data).to(dev)
    with torch.no_grad():
        verts = flame.motion_to_verts(torch.zeros(frames, 300, device=dev),
                                      torch.from_numpy(motions[:frames]).to(dev))
    zero_launches()
    img = PointRenderer(image_size=IMAGE, device=dev)(
        verts, d=POINT_DIST, generator=torch.Generator().manual_seed(21))
    torch.cuda.synchronize()
    point_launches = {k: since_zero()[k] for k in ("sort", "gsplat")}
    want = PointRenderer(image_size=IMAGE, device=cpu)(
        verts.cpu(), d=POINT_DIST, generator=torch.Generator().manual_seed(21))
    point_err = (img.cpu() - want).abs().max().item()
    covered = (img.amax(dim=1) > 1.0).float().mean().item()
    print(f"[debug] PointRenderer {tuple(img.shape)}: launches {point_launches}, covered "
          f"{covered:.4f}, range [{img.min().item():.3g}, {img.max().item():.3g}], card vs CPU "
          f"max abs err {point_err:.3g} (limit {POINT_TOL})")
    if (not torch.isfinite(img).all() or img.min() < 0 or img.max() > 255.0 + 1e-3
            or covered < 0.005):
        raise AssertionError("[debug] PointRenderer: output not finite, out of range or blank")
    if point_launches != {"sort": frames, "gsplat": frames} or point_err > POINT_TOL:
        raise AssertionError(f"[debug] PointRenderer: launches {point_launches}, error "
                             f"{point_err:.3g}")

    v = flame_data["v_template"]
    lo, hi = v[:, :2].min(0), v[:, :2].max(0)
    tuv = {"verts_uvs": ((v[:, :2] - lo) / (hi - lo)).astype(np.float32),
           "textures_idx": flame_data["faces"], "verts_idx": flame_data["faces"]}
    mask = np.nonzero(v[:, 2] > np.quantile(v[:, 2], 0.6))[0]
    rng = np.random.default_rng(21)
    tex = rng.random((3, 256, 256)).astype(np.float32)
    lights = (rng.standard_normal((frames, 9, 3)) * 0.3).astype(np.float32)
    args = dict(image_size=IMAGE, transform_matrix=TEXTURE_CAM, focal_length=12.0)
    zero_launches()
    renderer = TextureRenderer(tuv, flame_mask=mask, device=dev)
    images, masks, face = renderer(verts, tex, lights, **args)
    torch.cuda.synchronize()
    raster_launches = since_zero()["rasterize"]
    want = TextureRenderer(tuv, flame_mask=mask, device=cpu)(verts.cpu(), tex, lights, **args)
    faces = renderer.faces.cpu()
    sub = torch.where(renderer.flame_mask.cpu()[:, None], faces, faces[:, :1])
    ties = image_err = 0.0
    for b in range(frames):
        vs = TextureRenderer._project(verts[b].cpu(), torch.from_numpy(TEXTURE_CAM), 12.0,
                                      torch.zeros(2), IMAGE)
        differ = (masks[b, 0].cpu() != want[1][b, 0]).numpy()
        face_differ = (face[b, 0].cpu() != want[2][b, 0]).numpy()
        if not (rasterizer.edge_ties(vs, faces, np.argwhere(differ)).all()
                and rasterizer.edge_ties(vs, sub, np.argwhere(face_differ)).all()):
            raise AssertionError("[debug] TextureRenderer masks differ off an edge tie")
        ties += differ.sum() + face_differ.sum()
        keep = torch.from_numpy(~differ)
        image_err = max(image_err, (images[b].cpu()[:, keep] - want[0][b][:, keep]).abs().max()
                        .item())
    inside = not (face & ~masks).any().item()
    shares = [masks.float().mean().item(), face.float().mean().item()]
    print(f"[debug] TextureRenderer {tuple(images.shape)}: {raster_launches} z-buffer launches "
          f"for {frames} frames, masks_all share {shares[0]:.4f}, face mask share "
          f"{shares[1]:.4f}, face mask inside masks_all {inside}; card vs CPU: {int(ties)} "
          f"mask pixels differ (all edge ties), images max abs err {image_err:.3g} (limit "
          f"{TEXTURE_TOL})")
    if not torch.isfinite(images).all() or min(shares) == 0.0 or not inside:
        raise AssertionError("[debug] TextureRenderer: images not finite or masks wrong")
    if raster_launches != 2 * frames or image_err > TEXTURE_TOL:
        raise AssertionError(f"[debug] TextureRenderer: {raster_launches} z-buffer launches, "
                             f"image error {image_err:.3g}")
    return {"point_launches": point_launches, "raster_launches": raster_launches}


def phase_evaluation(dev: torch.device, flame_data: dict, exact: np.ndarray,
                     int8: np.ndarray, audio: np.ndarray) -> dict:
    """evaluate_motion on the card against a CPU run, and a clip against itself."""
    flame = FlameModel(flame_data).to(dev)
    card = evaluation.evaluate_motion(exact, int8, flame, audio=audio, device=dev)
    cpu = evaluation.evaluate_motion(exact, int8, FlameModel(flame_data), audio=audio,
                                     device="cpu")
    same = evaluation.evaluate_motion(exact, exact, flame, device=dev)
    counts = ("frames", "lip_vertices", "upper_vertices")
    diff = {k: abs(card[k] - cpu[k]) for k in cpu if k not in counts}
    print(f"[eval] exact vs int8 motions on the card: {json.dumps(card)}; |card - CPU| "
          + ", ".join(f"{k} {d:.3g}" for k, d in diff.items())
          + f" (limits rtol {EVAL_RTOL}, atol {EVAL_ATOL}); a clip against itself: lve "
          f"{same['lve']}, fdd {same['fdd']}")
    if (card.keys() != cpu.keys() or any(card[k] != cpu[k] for k in counts)
            or any(d > EVAL_ATOL + EVAL_RTOL * abs(cpu[k]) for k, d in diff.items())
            or not all(map(math.isfinite, card.values()))):
        raise AssertionError(f"[eval] card {card} vs CPU {cpu}")
    if same["lve"] != 0.0 or card["lve"] <= 0.0:
        raise AssertionError(f"[eval] LVE {same['lve']} for a clip against itself, "
                             f"{card['lve']} exact vs int8")
    return card


def phase_sort_times(dev: torch.device, avatar_keys: torch.Tensor) -> dict:
    """CUDA-event times of the sort at the avatar frame's key count and at
    2^21: the kernel alone, the wrapper, the plain version, torch.sort, the
    bound. Returns the kernels-line fields at the avatar frame's count."""
    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for tag, keys in (("avatar frame", avatar_keys), ("2^21", full_range_keys(1 << 21, 230, dev))):
        n = keys.shape[0]
        result = torch.empty(n, dtype=torch.int32, device=dev)
        lib = sort.LIB.get()
        work = torch.empty(n + lib.artalk_sort_meta_words(n), dtype=torch.int32, device=dev)
        launched = ctypes.c_int(0)
        alone = cuda_ms(lambda: lib.artalk_sort_keys(
            keys.data_ptr(), n, result.data_ptr(), work.data_ptr(), work[n:].data_ptr(), stream,
            ctypes.byref(launched)), 20)
        before = since_zero()["sort/cuda"]
        sort.sort_keys(keys)
        cuda_launches = since_zero()["sort/cuda"] - before
        wrapper = cuda_ms(lambda: sort.sort_keys(keys), 20)
        plain = cuda_ms(lambda: sort.sort_keys_plain(keys), 3)
        library = cuda_ms(lambda: torch.sort(keys), 20)
        bound = roofline.bytes_ms(roofline.sort_work(n).bytes)
        print(f"[times] sort {tag} ({n} keys, {cuda_launches} CUDA launches a sort, "
              f"{launched.value} reported by the entry point alone): wrapper {wrapper:.5f} ms, "
              f"kernel alone {alone:.5f}, plain {plain:.5f}, torch.sort {library:.5f}, bound "
              f"{bound:.5f} ms (8 bytes a key over 3.35 TB/s); the kernel alone reaches "
              f"{bound / alone:.4f} of the bound, torch.sort / kernel alone "
              f"{library / alone:.3f}")
        out[tag] = {"ms": wrapper, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
                    "library_ms": library, "kernel_only_ms": alone,
                    "cuda_launches_per_sort": cuda_launches}
        if cuda_launches != launched.value or not 1 <= cuda_launches <= SORT_MAX_LAUNCHES:
            raise AssertionError(f"[times] sort {tag}: the wrapper counted {cuda_launches} "
                                 f"CUDA launches, the entry point {launched.value}")
        profile_calls(lambda: sort.sort_keys(keys), f"sort of {n} keys ({tag})")
    return out["avatar frame"]


def phase_tf32_probe() -> dict:
    """tests/tf32_probe.py in a fresh ``python3 -c`` process that imports only
    artalk_tpu_torch.models.hubert: HuBERT base and wav2vec2's conv frontend
    with torch's default flags (cuDNN's TF32 on) equal the same calls after
    full_float32() to TF32_PROBE_TOL."""
    with open(os.path.join(ROOT, "tests", "tf32_probe.py")) as f:
        probe = f.read()
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"[tf32] the probe failed ({proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"[tf32] fresh process importing only models.hubert: TF32 flags (cudnn, matmul) "
          f"after the import {got['tf32_after_import']}, after the calls "
          f"{got['flags_after_calls']}, engine imported {got['engine_imported']}; HuBERT "
          f"{tuple(got['shape'])} vs the same call after full_float32() max abs diff "
          f"{got['hubert_diff']:.3g}, conv frontend {got['frontend_diff']:.3g} (limit "
          f"{TF32_PROBE_TOL}); one frontend conv called directly with TF32 on vs off differs "
          f"by {got['tf32_effect']:.3g}")
    if (got["tf32_after_import"][0] is not True or got["engine_imported"]
            or got["flags_after_calls"] != got["tf32_after_import"] or not got["finite"]
            or max(got["hubert_diff"], got["frontend_diff"]) > TF32_PROBE_TOL):
        raise AssertionError(f"[tf32] {got}")
    return got


def train_batch(ds, batch: int, seed: int, dev: torch.device) -> dict:
    """The first batch of ``ds`` for ``seed``, as tensors on ``dev``."""
    b = next(ds.batches(batch, seed=seed, num_batches=1))
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def ar_args(b: dict) -> tuple:
    return b["audio"], b["prev_motion"], b["this_motion"], b["style_motion"]


def run_train_steps(step, state, args: tuple, tag: str, n_params: int, dev: torch.device,
                    eval_loss):
    """One warm-up step under torch's FLOP counter (the schedule's step 0,
    at learning rate 0), then TRAIN_STEPS steps timed one by one by CUDA
    events. The steps' losses must be finite, and ``eval_loss()`` (the loss
    of the same batch without DropPath or update) after the steps below its
    value before them. Returns the state and the stage's numbers: ms per
    step, peak memory and
    the step's bound (the larger of the FLOP counter's matmul, convolution
    and attention operations, forward and backward, over the fp32 rate, as
    the steps run with TF32 off, and AdamW's bytes, 7 x 4 B per parameter:
    parameter, gradient and both moments read, parameter and moments
    written, over the HBM rate)."""
    before = eval_loss()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    with counter:
        state, first = step(state, *args)
    losses = [float(first["loss"])]
    events = []
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, *args)
        end.record()
        events.append((start, end, metrics))
    torch.cuda.synchronize(dev)
    ms = [s.elapsed_time(e) for s, e, _ in events]
    losses += [float(m["loss"]) for _, _, m in events]
    norms = [float(m["grad_norm"]) for _, _, m in events]
    peak = torch.cuda.max_memory_allocated(dev)
    after = eval_loss()
    flop = counter.get_total_flops()
    ops_ms = flop / FP32_FLOP_PER_S * 1e3
    bytes_ms = 7 * 4 * n_params / HBM_BYTES_PER_S * 1e3
    stage = {"ms_step": sum(ms) / len(ms), "peak_gib": peak / 2**30,
             "bound_ms": max(ops_ms, bytes_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    print(f"[train {tag}] {n_params / 1e6:.1f} M params, batch {args[0].shape[0]}: losses "
          f"{[round(x, 5) for x in losses]} (warm-up at lr 0, then {TRAIN_STEPS} steps at lr "
          f"{TRAIN_LR}), grad norms {[round(x, 4) for x in norms]}, loss without DropPath "
          f"before {before:.5f} and after {after:.5f}; ms per step "
          f"{[round(x, 3) for x in ms]} (mean {stage['ms_step']:.3f}); peak memory "
          f"{stage['peak_gib']:.2f} GiB; bound {stage['bound_ms']:.3f} ms ({stage['bound_by']}: "
          f"{flop / 1e12:.3f} TFLOP at 67 TFLOP/s = {ops_ms:.3f} ms, AdamW "
          f"{28 * n_params / 1e9:.2f} GB at 3.35 TB/s = {bytes_ms:.3f} ms), share of the bound "
          f"{stage['bound_ms'] / stage['ms_step']:.3f}")
    if not all(math.isfinite(x) for x in losses + norms) or not after < before:
        raise AssertionError(f"[train {tag}] losses {losses}, {before} -> {after}: not "
                             "finite or not falling")
    return state, stage


def phase_train_vae(dev: torch.device) -> dict:
    """Stage 1 at the production width on train.py --synthetic's data."""
    cfg = tcfg.ModelConfig()
    b = train_batch(train.synthetic_dataset(cfg), TRAIN_BATCH, 0, dev)
    vae = BitwiseVAE(cfg.vae).init(torch.Generator().manual_seed(0)).to(dev)
    opt = trainer.make_optimizer(lr=TRAIN_LR, warmup_steps=1)
    step = trainer.make_vae_train_step(vae, opt)
    n_params = sum(p.numel() for p in vae.parameters())
    args = (b["prev_motion"], b["this_motion"])

    def eval_loss():
        with torch.no_grad(), no_tf32():
            return float(train_losses.vae_loss(vae, *args)[0])

    zero_launches()
    _, stage = run_train_steps(step, trainer.init_state(vae, opt), args, "vae", n_params, dev,
                               eval_loss)
    if any(launch_counts().values()):
        raise AssertionError(f"[train vae] launched {launch_counts()}")
    return stage


def phase_train_ar(dev: torch.device):
    """Stage 2 at the production width, with style clips and DropPath, on
    train.py --synthetic's data; the exact path launches no kernel. Returns
    the model and the stage's numbers."""
    cfg = tcfg.ModelConfig()
    b = train_batch(train.synthetic_dataset(cfg), TRAIN_BATCH, 0, dev)
    model = BitwiseARModel(cfg).init(torch.Generator().manual_seed(0)).to(dev)
    opt = trainer.make_optimizer(lr=TRAIN_LR, warmup_steps=1)
    step = trainer.make_ar_train_step(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    def eval_loss():
        with torch.no_grad(), no_tf32():
            return float(train_losses.ar_loss(model, *ar_args(b))[0])

    zero_launches()
    state, stage = run_train_steps(step, trainer.init_state(model, opt), ar_args(b), "ar",
                                   n_params, dev, eval_loss)
    if any(launch_counts().values()):
        raise AssertionError(f"[train ar] launched {launch_counts()}")
    del state
    return model, stage


def one_ar_step(model, b: dict, dev: torch.device, mesh=None, drop_path: bool = False
                ) -> dict:
    """One AR step of a fresh state (the schedule's step 0: learning rate 0,
    so the weights stay as they are), DropPath off unless asked for, on
    ``dev``, through the mesh-aware step with ``mesh``."""
    opt = trainer.make_optimizer(lr=TRAIN_LR, warmup_steps=1)
    step = trainer.make_ar_train_step(model, opt, mesh=mesh, drop_path=drop_path)
    _, metrics = step(trainer.init_state(model, opt), *(x.to(dev) for x in ar_args(b)))
    return {k: float(v) for k, v in metrics.items()}


class tf32_on(no_tf32):
    """Phase 29's control: TF32 on where the step asks for it off."""

    def __enter__(self):
        super().__enter__()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True


@contextlib.contextmanager
def replaced(module, name: str, value):
    """``module.name`` set to ``value`` for the block."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def phase_train_cpu(model, dev: torch.device) -> None:
    """One AR step at batch 1 on the card and the same weights and batch on
    the CPU: loss and grad_norm within TRAIN_CPU_RTOL; the card step with
    TF32 let on (the control) outside them."""
    b = train_batch(train.synthetic_dataset(model.cfg), 1, 1, dev)
    card = one_ar_step(model, b, dev)
    with replaced(tnn, "no_tf32", tf32_on):
        control = one_ar_step(model, b, dev)
    cpu_model = BitwiseARModel(model.cfg)
    cpu_model.load_state_dict({k: v.detach().cpu() for k, v in model.state_dict().items()})
    cpu = one_ar_step(cpu_model, {k: v.cpu() for k, v in b.items()}, torch.device("cpu"))
    with torch.no_grad():
        bits = [m.vae.encode_to_bits(b["prev_motion"].to(d), b["this_motion"].to(d))
                for m, d in ((model, dev), (cpu_model, "cpu"))]
    flipped = sum(int((x.cpu() != y).sum()) for x, y in zip(bits[0], bits[1]))
    rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in TRAIN_CPU_RTOL}
    rel_control = {k: abs(control[k] - cpu[k]) / abs(cpu[k]) for k in TRAIN_CPU_RTOL}
    print(f"[train cpu] AR step at batch 1, DropPath off: card {card}, CPU {cpu}; relative "
          f"differences {rel} (limits {TRAIN_CPU_RTOL}); {flipped} of "
          f"{sum(x.numel() for x in bits[1])} target and prefix code bits differ; control "
          f"with TF32 on: {control}, relative differences {rel_control}")
    if any(rel[k] > tol for k, tol in TRAIN_CPU_RTOL.items()):
        raise AssertionError(f"[train cpu] card vs CPU {rel}")
    if not all(rel_control[k] > tol for k, tol in TRAIN_CPU_RTOL.items()):
        raise AssertionError(f"[train cpu] the TF32 control {rel_control} passes the limits")


def tol_ratio(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """The largest |got - want| / (tol + tol |want|): at most 1 within
    atol = rtol = ``tol``."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def phase_train_kernel(model, dev: torch.device) -> dict:
    """The encoder-stack kernel on the training path: one AR step at batch 1
    with fused_ar (float32 pack) and one at batch 8 with bf16_audio +
    fused_ar, each launching it once, counted. The launch's output is held
    against the plain stack on the launch's own input and pack, and the
    fused condition against the unfused one of the same precision on the
    same audio, both within ENCODER_TOL; the float32 step's loss against the
    exact step's within the first-order bound of ENCODER_TOL['f32'] (sum
    over the condition of |d loss / d cond| times the area-resized atol +
    rtol |features|, times FUSED_LOSS_MARGIN), the bf16 step's loss finite.
    Each fused step runs on a copy of ``model`` built as training/train.py
    builds its model (``BitwiseARModel(cfg)``, no held packs), so the step
    packs the encoder's weights inline, as the trainer's steps do.
    Returns per pack the launches and the two max abs errors."""
    cfg = model.cfg
    ds = train.synthetic_dataset(cfg)
    b1, b8 = train_batch(ds, 1, 2, dev), train_batch(ds, TRAIN_BATCH, 3, dev)
    exact = one_ar_step(model, b1, dev)
    with torch.no_grad(), no_tf32():
        feat = model.audio_encoder(b1["audio"])
        cond = torch.cat([resize_area(feat, pn) for pn in model.patch_nums], dim=1)
        err = ENCODER_TOL["f32"] * torch.cat(
            [resize_area(1.0 + feat.abs(), pn) for pn in model.patch_nums], dim=1)
    leaf = cond.clone().requires_grad_(True)
    model.audio_condition = lambda _audio: leaf
    try:
        with no_tf32():
            loss, _ = train_losses.ar_loss(model, *ar_args(b1))
            (grad,) = torch.autograd.grad(loss, leaf)
    finally:
        del model.audio_condition
    bound = FUSED_LOSS_MARGIN * float((grad.abs() * err).sum())
    out = {}
    for tag, change, b in (("f32", {"fused_ar": True}, b1),
                           ("bf16", {"fused_ar": True, "bf16_audio": True}, b8)):
        calls = []

        def record(x, pack, **kw):
            y = enc_stack.encoder_block_stack(x, pack, **kw)
            calls.append((x, pack, kw, y))
            return y

        tol = ENCODER_TOL[tag]
        trainee = BitwiseARModel(dataclasses.replace(cfg, **change))
        trainee.load_state_dict(model.state_dict())
        trainee = trainee.to(dev)
        zero_launches()
        with replaced(wav2vec_mod, "encoder_block_stack", record):
            got = one_ar_step(trainee, b, dev)
        launches = launch_counts()
        with torch.no_grad(), no_tf32():
            fused = trainee.audio_condition(b["audio"])
            trainee.set_precision(dataclasses.replace(cfg, **{**change, "fused_ar": False}))
            unfused = trainee.audio_condition(b["audio"])
        del trainee
        if len(calls) != 1:
            raise AssertionError(f"[train kernel] {tag}: {len(calls)} encoder-stack calls")
        x, pack, kw, y = calls[0]
        with torch.no_grad():
            want = enc_stack.encoder_block_stack_plain(x, pack, **kw)
        stack_err = float((y - want).abs().max())
        stack_ratio = tol_ratio(y, want, tol)
        cond_err = float((fused - unfused).abs().max())
        cond_ratio = tol_ratio(fused, unfused, tol)
        out[tag] = {"train_launches": launches["encoder"], "train_max_abs_err": stack_err,
                    "train_condition_max_abs_err": cond_err}
        print(f"[train kernel] {tag} pack, batch {b['audio'].shape[0]}: the launch on "
              f"{tuple(x.shape)} against the plain stack max abs err {stack_err:.3g} "
              f"({stack_ratio:.3f} of atol = rtol {tol}); the fused condition against the "
              f"unfused one {cond_err:.3g} ({cond_ratio:.3f} of it); loss {got['loss']:.7f}"
              + (f" vs exact {exact['loss']:.7f} (|diff| {abs(got['loss'] - exact['loss']):.3g}"
                 f", bound {bound:.3g})" if tag == "f32" else "")
              + f"; launches {launches}")
        if launches != {"ar": 0, "encoder": 1, "flash": 0} or not math.isfinite(got["loss"]):
            raise AssertionError(f"[train kernel] {tag}: launches {launches}, loss {got['loss']}")
        if stack_ratio > 1.0 or cond_ratio > 1.0:
            raise AssertionError(f"[train kernel] {tag}: the kernel on the training path off "
                                 f"its plain version ({stack_ratio:.3f}, {cond_ratio:.3f} of "
                                 "ENCODER_TOL)")
        if tag == "f32" and abs(got["loss"] - exact["loss"]) > bound:
            raise AssertionError(f"[train kernel] fused loss off the exact step's by "
                                 f"{abs(got['loss'] - exact['loss']):.3g} > {bound:.3g}")
    return out


def phase_train_cli(dev: torch.device, audio: np.ndarray) -> str:
    """train.main as a user runs it (AR stage, synthetic clips, 2 steps,
    --eval) on the card; the saved npz loads into the port's engine, whose
    inference of phase 5's audio is finite. Returns the npz's path."""
    out = os.path.join(ROOT, "render_results", "chip_smoke", "train", "trained.npz")
    zero_launches()
    t0 = time.perf_counter()
    metrics = train.main(["--stage", "ar", "--synthetic", "--steps", "2", "--out", out,
                          "--eval", "--device", "cuda", "--log_every", "1"])
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if any(launches.values()) or metrics["frames"] != 500 or not all(
            math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"[train cli] launches {launches}, eval {metrics}")
    engine = build_engine(dev, {}, tcfg.ModelConfig(), params=load_params_npz(out))
    motions = engine.inference(audio)
    print(f"[train cli] train.main (2 steps, --eval) {seconds:.1f} s, eval {metrics}; its npz "
          f"in the engine: inference {motions.shape}, finite {bool(np.isfinite(motions).all())}")
    if motions.shape != (250, 106) or not np.isfinite(motions).all():
        raise AssertionError("[train cli] the trained engine's inference")
    return out


def phase_export(dev: torch.device, audio: np.ndarray, checkpoint: str) -> None:
    """export_model.main on phase 31's checkpoint at the production
    ModelConfig(): the saved and reloaded program equals, bit for bit over
    2 windows of phase 5's audio with the carry threaded through, the eager
    window step of the model built from the params.npz written beside it."""
    out_dir = os.path.join(ROOT, "render_results", "chip_smoke", "export")
    t0 = time.perf_counter()
    path = export_model.main(["--out", out_dir, "--checkpoint", checkpoint,
                              "--device", "cuda"])
    t1 = time.perf_counter()
    step = export_model.load_window_step(path)
    t2 = time.perf_counter()
    params = os.path.join(out_dir, "params.npz")
    model = params_from_flat(load_params_npz(params), tcfg.ModelConfig()).to(dev)
    sizes = [os.path.getsize(f) for f in (path, params)]
    for f in (path, params, checkpoint):
        os.remove(f)
    ws = model.window_samples
    equal = []
    with torch.no_grad(), no_tf32():
        style = model.encode_style(None)
        want = got = model.initial_state(style)
        for k in range(2):
            chunk = torch.from_numpy(audio[None, k * ws:(k + 1) * ws]).to(dev)
            want, want_motion = model.window_step(want, chunk, style)
            got, got_motion = step(got, chunk, style)
            equal.append(torch.equal(got.prev_bits, want.prev_bits)
                         and torch.equal(got.prev_attn_feat, want.prev_attn_feat)
                         and torch.equal(got_motion, want_motion))
    print(f"[export] export_model.main at batch 1, ModelConfig() "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params) on the trained "
          f"npz: {t1 - t0:.1f} s (trace, save {sizes[0] / 1e9:.2f} GB and params.npz "
          f"{sizes[1] / 1e9:.2f} GB), load {t2 - t1:.1f} s; reloaded equals the eager step of "
          f"params.npz bit for bit per window: {equal}")
    if not all(equal):
        raise AssertionError("[export] the reloaded window step differs from the eager one")


def free_port() -> int:
    """A localhost port that was free a moment ago (bound, then released)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def timed_generate(model, audio: np.ndarray, n_windows: int) -> tuple:
    """``generate`` of ``audio`` zero-padded to ``n_windows`` windows, as
    ``inference`` pads it, after a one-window warm-up: (motions taken whole,
    ms per window by the host clock around synchronised work)."""
    ws = model.window_samples
    dev = model.pos_embed.device
    padded = np.zeros(n_windows * ws, np.float32)
    padded[: len(audio)] = audio[: n_windows * ws]
    chunks = torch.from_numpy(padded.reshape(n_windows, 1, ws)).to(dev)
    style = model.encode_style(None)
    model.generate(chunks[:1], style)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    motions = whole(model.generate(chunks, style))
    torch.cuda.synchronize(dev)
    return motions, (time.perf_counter() - t0) * 1e3 / n_windows


def timed_ar_step(model, b: dict, dev: torch.device, mesh=None) -> tuple:
    """Two ``one_ar_step`` calls, DropPath on (the second timed by the host
    clock around synchronised work): (its metrics, its ms)."""
    one_ar_step(model, b, dev, mesh=mesh, drop_path=True)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    metrics = one_ar_step(model, b, dev, mesh=mesh, drop_path=True)
    torch.cuda.synchronize(dev)
    return metrics, (time.perf_counter() - t0) * 1e3


def phase_parallel(dev: torch.device, flame_data: dict, audio: np.ndarray,
                   motions: np.ndarray, exact_bits: np.ndarray, int8_bits: np.ndarray) -> dict:
    """Phase 33: the parallel package on NCCL at world 1 (one card holds one
    rank), mesh (dp=1, tp=1). A fresh production model (seed 0) with its
    parameters placed by shard_params: its exact and int8 window-0 code
    bits equal phases 5 and 8's, with the int8 kernels' launches counted;
    its exact ms per window against the same model's before sharding; one
    AR step at batch TRAIN_BATCH through the mesh-aware trainer against the
    plain step from the same weights and batch within TRAIN_CPU_RTOL; and
    render_frames_dp of phase 5's 250 frames bit for bit equal to the
    renderer's, with the rasterizer's launches counted. Destroys the group
    at the end. Returns each kernel's launches (by pack for the block
    stacks) summed over the counted windows and the render."""
    info = initialize_multihost(coordinator_address=f"127.0.0.1:{free_port()}",
                                num_processes=1, process_id=0)
    try:
        mesh = make_mesh()
        if tuple(mesh.shape) != (1, 1) or info["num_processes"] != 1:
            raise AssertionError(f"[parallel] mesh {tuple(mesh.shape)}, job {info}")
        cfg = tcfg.ModelConfig()
        model = BitwiseARModel(cfg).init(torch.Generator().manual_seed(0)).to(dev)
        n = math.ceil(len(audio) / model.window_samples)
        with torch.no_grad():
            plain_motions, plain_ms = timed_generate(model, audio, n)
        b = train_batch(train.synthetic_dataset(cfg), TRAIN_BATCH, 4, dev)
        plain, plain_step_ms = timed_ar_step(model, b, dev)
        model.requires_grad_(False)

        shard_params(model, mesh)
        counted: dict = {}
        with torch.no_grad(), implicit_replication():
            zero_launches()
            sharded_motions, sharded_ms = timed_generate(model, audio, n)
            bits = window0_bits(model, audio)
            exact_launches = launch_counts()
            add_launches(counted)
            model.set_precision(bench.with_env(MODES["int8"], lambda: tcfg.precision_from_env(cfg)))
            zero_launches()
            bits8 = window0_bits(model, audio)
            int8_launches = launch_counts()
            add_launches(counted)
        model.set_precision(cfg)
        sharded, sharded_step_ms = timed_ar_step(model, b, dev, mesh)
        rel = {k: abs(sharded[k] - plain[k]) / abs(plain[k]) for k in TRAIN_CPU_RTOL}
        del model
        torch.cuda.empty_cache()

        flame = FlameModel(flame_data, n_shape=300, n_exp=100, scale=1.0).to(dev)
        renderer = MeshRenderer(image_size=IMAGE, faces=flame_data["faces"], scale=1.0,
                                template_verts=flame_data["v_template"], device=dev)
        with torch.no_grad():
            verts = flame.motion_to_verts(torch.zeros(len(motions), 300, device=dev),
                                          torch.from_numpy(motions).to(dev))
            renderer(verts[:1])
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            want = renderer(verts)
            torch.cuda.synchronize(dev)
            plain_render_ms = (time.perf_counter() - t0) * 1e3 / len(motions)
            zero_launches()
            t0 = time.perf_counter()
            frames = render_frames_dp(renderer, verts, mesh)
            torch.cuda.synchronize(dev)
            render_ms = (time.perf_counter() - t0) * 1e3 / len(motions)
            raster = since_zero()["rasterize"]
            add_launches(counted)
            render_equal = torch.equal(frames, want)
        del want, frames
    finally:
        dist.destroy_process_group()
    flipped = {"exact": int((bits != exact_bits).sum()), "int8": int((bits8 != int8_bits).sum())}
    motion_err = float((sharded_motions - plain_motions).abs().max())
    print(f"[parallel] NCCL job {info}, mesh (dp, tp) = {tuple(mesh.shape)}: exact inference "
          f"of {n} windows {sharded_ms:.2f} ms/window sharded vs {plain_ms:.2f} unsharded "
          f"(DTensor dispatch {sharded_ms - plain_ms:+.2f} ms), motions max abs diff "
          f"{motion_err:.3g}; window-0 code bits differing from phase 5's exact "
          f"{flipped['exact']} and phase 8's int8 {flipped['int8']} of {bits.size}; launches "
          f"exact {exact_launches}, int8 {int8_launches}")
    print(f"[parallel] AR step at batch {TRAIN_BATCH} (DropPath on): mesh {sharded}, plain "
          f"{plain}; relative differences {rel} (limits {TRAIN_CPU_RTOL}); ms per step (the "
          f"second of two) mesh {sharded_step_ms:.2f}, plain {plain_step_ms:.2f}")
    print(f"[parallel] render_frames_dp of {len(motions)} frames at {IMAGE}x{IMAGE}: "
          f"{render_ms:.2f} ms/frame against renderer(verts) {plain_render_ms:.2f}, equal to it "
          f"bit for bit: {render_equal}, {raster} rasterizer launches")
    if any(flipped.values()) or motion_err > 1e-4:
        raise AssertionError(f"[parallel] the sharded model's bits {flipped}, motions "
                             f"{motion_err:.3g}")
    if any(exact_launches.values()) or int8_launches != {"ar": len(cfg.vae.patch_nums),
                                                         "encoder": 1, "flash": 0}:
        raise AssertionError(f"[parallel] launches exact {exact_launches}, int8 "
                             f"{int8_launches}")
    if any(rel[k] > tol for k, tol in TRAIN_CPU_RTOL.items()):
        raise AssertionError(f"[parallel] mesh step vs plain step {rel}")
    if not render_equal or raster != len(motions):
        raise AssertionError(f"[parallel] render_frames_dp equal {render_equal}, "
                             f"{raster} rasterizer launches")
    no_other_launches("parallel", counted)
    return counted


def phase_bench() -> dict:
    """Phase 34: the port's bench, every section, on the card. Returns the
    kernels' launches over the run."""
    zero_launches()
    t0 = time.perf_counter()
    out = bench.run(bench.KNOWN_SECTIONS, "cuda", repeats=BENCH_REPEATS)
    seconds = time.perf_counter() - t0
    launches = tool_launches()
    print(f"[bench] {json.dumps(out)}")
    print(f"[bench] every section, {BENCH_REPEATS} repeats: {seconds:.1f} s; launches {launches}")
    keys = [k for name in bench.KNOWN_SECTIONS for k in bench.SECTION_KEYS[name]]
    bad = {k: out.get(k) for k in keys
           if not isinstance(out.get(k), (int, float)) or not math.isfinite(out[k]) or out[k] <= 0}
    shares = {k: v for k, v in out.items()
              if k.endswith(("_mfu", "_membw_frac")) and not 0 < v <= 1.0}
    if "errors" in out or bad or shares:
        raise AssertionError(f"[bench] errors {out.get('errors')}, keys missing or not "
                             f"positive {bad}, shares outside (0, 1] {shares}")
    if not out["device"]["name"] or not out["device"]["power_limit"]:
        raise AssertionError(f"[bench] device {out['device']}")
    idle = [k for k in ("rasterize", "ar", "encoder", "gsplat", "sort") if not launches[k]]
    if idle:
        raise AssertionError(f"[bench] kernels never launched: {idle}")
    return launches


class GivenConditions:
    """Replaces ``model.audio_condition`` while in use: its calls return
    ``conds`` in turn, whatever audio they are given. Yields the number of
    calls made."""

    def __init__(self, model, conds: list):
        self.model, self.conds, self.calls = model, list(conds), []

    def __enter__(self):
        def given(audio):
            self.calls.append(audio.shape[0])
            return self.conds[len(self.calls) - 1]

        self.model.audio_condition = given
        return self.calls

    def __exit__(self, *exc):
        del self.model.audio_condition


class FirstRowDifference(TorchDispatchMode):
    """Without ``ref``: records every tensor an op returns (factory ops left
    out: a kernel bound through ctypes fills them after they return). With
    ``ref``, such a record at batch 1: finds the first op whose output, at a
    larger batch, differs in row ``row`` from the record at the same op."""

    FACTORIES = ("empty", "empty_like", "empty_strided", "new_empty")

    def __init__(self, ref: "FirstRowDifference" = None, row: int = 0):
        super().__init__()
        self.ref, self.row, self.names, self.outs, self.first = ref, row, [], [], None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.FACTORIES:
            return out
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or t.ndim == 0:
                continue
            i = len(self.names)
            self.names.append(name)
            if self.ref is None:
                self.outs.append(t.detach().clone())
            elif self.first is None and i < len(self.ref.names):
                want = self.ref.outs[i]
                if self.ref.names[i] != name:
                    self.first = (i, name, "the ops differ from here on")
                elif (want.shape[0] == 1 and t.shape[0] > self.row
                      and t.shape[1:] == want.shape[1:]
                      and not torch.equal(t[self.row:self.row + 1], want)):
                    diff = (t[self.row:self.row + 1].double() - want.double()).abs().max()
                    self.first = (i, name, f"output {tuple(t.shape)}, row max abs "
                                           f"difference {diff.item():.3g}")
        return out


def first_divergent_op(model, chunks: np.ndarray, row: int) -> str:
    """One window step of ``chunks`` (B, window_samples) from the pool's
    fresh carry, under FirstRowDifference against row ``row`` stepped alone:
    the first op whose output row differs, named with the ops before it."""
    dev = model.pos_embed.device
    null = model.encode_style(None)
    fresh = model.initial_state(null, batch_size=1)
    b = len(chunks)
    wide = WindowState(*(t.repeat(b, *([1] * (t.ndim - 1))) for t in fresh))
    one, many, styles = (torch.from_numpy(chunks[row:row + 1]).to(dev),
                         torch.from_numpy(chunks).to(dev), null.repeat(b, 1, 1))
    with torch.no_grad():
        with FirstRowDifference() as ref:
            model.window_step(fresh, one, null)
        with FirstRowDifference(ref, row) as probe:
            model.window_step(wide, many, styles)
    if probe.first is None:
        return f"none of {len(probe.names)} op outputs"
    i, name, what = probe.first
    return f"op {i} of {len(probe.names)}, aten.{name} ({what}; after {probe.names[max(0, i - 4):i]})"


def pool_ticks(model, audio: list, ticks: int) -> dict:
    """A fresh StreamPool of len(audio) sessions stepped together for
    ``ticks`` ticks: per session, (motions, decoded code bits) per window."""
    from artalk_tpu_torch.serving import StreamPool

    pool = StreamPool(model, max_sessions=len(audio))
    sids = [pool.open_session() for _ in audio]
    got = {sid: [] for sid in sids}
    with DecodedBits(model) as calls:
        for t in range(ticks):
            out = pool.step({sid: audio[sid][t] for sid in sids})
            for sid in sids:
                got[sid].append((out[sid], calls[-1][sid]))
    return got


def phase_pool_wide(engine: ARTAvatarInferEngine) -> dict:
    """Phase 35, first part: StreamPool at B = POOL_WIDE, the widest batch of
    the tools' curve (3200 rows a level at pn 100), on phase 5's exact engine
    and on phase 9's int8 engine. Every session has its own audio and all
    are stepped together for two ticks; each is also streamed alone at
    batch 1 (engine.stream). Exact: each window's decoded code bits must
    agree with the batch-1 stream on at least POOL_BITS_AGREE. int8, where
    greedy bits flip with the rounding of the plain parts at another batch
    size: the mean agreement with the batch-1 streams must reach
    POOL_BITS_AGREE; each window must agree on POOL_BITS_AGREE with its
    batch-1 stream when both take the audio condition computed alone at
    batch 1 (the pool and the streams otherwise unchanged); each row must
    equal the session stepped alone in a pool of the same capacity (bits
    on POOL_BITS_AGREE, motions to 1e-5, phase 9's isolation rule); both
    kernels at B = POOL_WIDE pass ``wide_kernel_rows``. The first op whose
    row differs from the row stepped alone is printed. Rows crossed (each
    session against the next one's reference) must fail every rule held.
    Checked before any tool prints a time."""
    model = engine.model
    int8 = model.cfg.int8_ar
    dev = model.pos_embed.device
    ws = model.window_samples
    rng = np.random.default_rng(35)
    audio = [[(rng.standard_normal(ws) * 0.1).astype(np.float32) for _ in range(2)]
             for _ in range(POOL_WIDE)]
    sids = range(POOL_WIDE)
    zero_launches()
    runs = {"stream": pool_ticks(model, audio, 2)}
    launches = {k: since_zero()[k] for k in ("ar", "encoder")}
    refs = {"stream": [stream_windows(engine, audio[sid]) for sid in sids]}
    if int8:
        runs["alone"] = runs["stream"]
        refs["alone"] = [alone_in_pool(model, audio[sid], POOL_WIDE) for sid in sids]
        with torch.no_grad():
            conds = [[model.audio_condition(torch.from_numpy(c[None]).to(dev)) for c in chunks]
                     for chunks in audio]
        wide = [torch.cat([conds[sid][t] for sid in sids]) for t in range(2)]
        with GivenConditions(model, wide) as calls:
            runs["given"] = pool_ticks(model, audio, 2)
        refs["given"] = []
        for sid in sids:
            with GivenConditions(model, conds[sid]) as one:
                refs["given"].append(stream_windows(engine, audio[sid]))
            calls += one
        if calls != [POOL_WIDE] * 2 + [1] * (2 * POOL_WIDE):
            raise AssertionError(f"[pool wide] audio_condition calls {calls}")
        rows = wide_kernel_rows(model)
    agree = {name: [bits_agree(g, w) for sid in sids for g, w in zip(runs[name][sid], r[sid])]
             for name, r in refs.items()}
    crossed = {name: max(bits_agree(g, w) for sid in sids
                         for g, w in zip(runs[name][sid], r[(sid + 1) % POOL_WIDE]))
               for name, r in refs.items()}
    held = ["alone", "given"] if int8 else ["stream"]
    iso_err = max(float(np.abs(g[0] - w[0]).max())
                  for sid in sids for g, w in zip(runs[held[0]][sid], refs[held[0]][sid]))
    mean = float(np.mean(agree["stream"]))
    print(f"[pool wide] {'int8' if int8 else 'exact'}, B = {POOL_WIDE}, 2 ticks: code bits "
          "agreeing per window with each session streamed alone at batch 1: least "
          f"{min(agree['stream']):.4f}, mean {mean:.4f}"
          + (f"; both given the condition computed alone: least {min(agree['given']):.4f}; "
             f"with the session stepped alone in a pool of {POOL_WIDE}: least "
             f"{min(agree['alone']):.4f}" if int8 else "")
          + f"; motions max abs err against the {held[0]} run {iso_err:.3g}; held: per window "
          f"{held}" + (", the stream's mean" if int8 else "") + f" (limit {POOL_BITS_AGREE}); "
          f"planted fault rows crossed {crossed}; launches {launches}")
    if int8:
        row = int(np.argmin(agree["stream"][::2]))
        print(f"[pool wide] int8: the first op of window 0 whose row {row} (the least agreeing "
              f"with its stream) at B = {POOL_WIDE} differs from the row stepped alone: "
              f"{first_divergent_op(model, np.stack([c[0] for c in audio]), row)}")
        print("[pool wide] int8 kernels at B = " + str(POOL_WIDE) + ": " + "; ".join(
            f"{k}: rows against each row alone {v['rows']:.3g}, against the plain version "
            f"max abs err {v['plain']:.3g}"
            + (f", k/v {v['kv_ulps']:.3g} bf16 ulps (limits {AR_FEATS_TOL}, 2)" if "kv_ulps" in v
               else f", {v['of_bound']:.3f} of ENCODER_TOL's bound") for k, v in rows.items()))
    low = {name: min(agree[name]) for name in held if min(agree[name]) < POOL_BITS_AGREE}
    if low or (int8 and mean < POOL_BITS_AGREE):
        raise AssertionError(f"StreamPool at B = {POOL_WIDE}: least share of a window's code "
                             f"bits agreeing {low}, mean with the streams {mean:.4f} (limit "
                             f"{POOL_BITS_AGREE})")
    if int8 and iso_err > 1e-5:
        raise AssertionError(f"StreamPool at B = {POOL_WIDE}: sessions interfere, {iso_err:.3g}")
    if int8:
        off = {k: v for k, v in rows.items()
               if v["rows"] > 1e-6 or v.get("kv_ulps", 0.0) > 2 or v.get("of_bound", 0.0) > 1.0
               or (k.startswith("ar/") and v["plain"] > AR_FEATS_TOL)}
        if off:
            raise AssertionError(f"the block stacks at B = {POOL_WIDE}: {off}")
    if any(c >= POOL_BITS_AGREE for c in crossed.values()):
        raise AssertionError(f"the wide pool's bits checks let crossed rows pass: {crossed}")
    want = ({"ar": 2 * len(model.patch_nums), "encoder": 2} if int8
            else {"ar": 0, "encoder": 0})
    if launches != want:
        raise AssertionError(f"StreamPool at B = {POOL_WIDE}: launches {launches}, want {want}")
    return {"agree": {name: min(agree[name]) for name in held}, "stream_agree": mean,
            "launches": launches, "kernels": rows if int8 else {}}


def alone_in_pool(model, chunks: list, capacity: int) -> list:
    """One session stepped alone in a fresh pool of ``capacity``: (motions,
    decoded code bits) per chunk."""
    from artalk_tpu_torch.serving import StreamPool

    pool = StreamPool(model, max_sessions=capacity)
    sid = pool.open_session()
    with DecodedBits(model) as calls:
        return [(pool.step({sid: chunk})[sid], calls[-1][sid]) for chunk in chunks]


def wide_kernel_rows(model) -> dict:
    """Phase 35: both block-stack kernels at B = POOL_WIDE with the int8
    engine's packs, and the encoder's with the bf16 pack too (profile_encoder
    runs it at 8 windows), on seeded inputs: each row against the same row
    launched alone (phase 6 and 7's row rule), and the whole launch against
    its plain version on the same inputs (phase 6 and 7's limits). Returns
    per "<kernel>/<pack>": "rows", the rows' max abs difference from alone;
    "plain", the max abs error against the plain version (the AR stack's
    feats); and "kv_ulps", the AR stack's k/v in bf16 ulps, or "of_bound",
    the encoder's share of ENCODER_TOL's bound."""
    out = {}
    ar = {"rows": 0.0, "plain": 0.0, "kv_ulps": 0.0}
    pack = model.fused_pack
    for level in range(len(model.patch_nums)):
        x, ada, kc, vc, start = ar_inputs(model, POOL_WIDE, level, torch.bfloat16,
                                          seed=350 + level)
        args = dict(start=start, num_heads=model.num_heads)
        got = ar_stack.ar_block_stack(x, ada, pack, kc, vc, **args)
        want = ar_stack.ar_block_stack_plain(x, ada, pack, kc, vc, **args)
        ar["plain"] = max(ar["plain"], (got[0] - want[0]).abs().max().item())
        ar["kv_ulps"] = max(ar["kv_ulps"], *(bf16_ulps_of_max(g, w)
                                             for g, w in zip(got[1:], want[1:])))
        del want
        for r in range(POOL_WIDE):
            one = ar_stack.ar_block_stack(x[r:r + 1], ada[:, r:r + 1].contiguous(), pack,
                                          kc[:, r:r + 1].contiguous(),
                                          vc[:, r:r + 1].contiguous(), **args)
            ar["rows"] = max(ar["rows"], (one[0] - got[0][r:r + 1]).abs().max().item(),
                             *((o.float() - g[:, r:r + 1].float()).abs().max().item()
                               for o, g in zip(one[1:], got[1:])))
    out[f"ar/{ar_stack.PACK_NAMES[ar_stack.pack_dtype(pack)]}"] = ar
    x = encoder_input(model, POOL_WIDE)
    heads = model.cfg.wav2vec.num_attention_heads
    for pack in (model.fused_audio_pack, model.audio_encoder.pack_fused(torch.bfloat16)):
        name = ar_stack.PACK_NAMES[ar_stack.pack_dtype(pack)]
        tol = ENCODER_TOL[name]
        got = enc_stack.encoder_block_stack(x, pack, num_heads=heads)
        want = enc_stack.encoder_block_stack_plain(x, pack, num_heads=heads)
        out[f"encoder/{name}"] = {
            "rows": max((enc_stack.encoder_block_stack(x[r:r + 1], pack, num_heads=heads)
                         - got[r:r + 1]).abs().max().item() for r in range(POOL_WIDE)),
            "plain": (got - want).abs().max().item(),
            "of_bound": ((got - want).abs() / (tol + tol * want.abs())).max().item()}
    return out


def tool_launches() -> dict:
    """Every kernel's launches since the last zero_launches(); the block
    stacks' also by pack ("ar/int8")."""
    return {k: n for k, n in since_zero().items() if k.partition("/")[2] in ("", *PACKS)}


def add_launches(total: dict) -> dict:
    """Add every kernel's launches since the last zero_launches()
    (tool_launches, the block stacks' also by pack) into ``total``."""
    for k, v in tool_launches().items():
        total[k] = total.get(k, 0) + v
    return total


def no_other_launches(tag: str, total: dict) -> None:
    """A phase that runs no GAGAvatar, sort or attention path must have
    launched none of those kernels: the kernels line then gives each of
    their rows the phase's whole count of the kernel, 0."""
    if total["gsplat"] or total["sort"] or total["flash"]:
        raise AssertionError(f"[{tag}] kernels launched off the path: {total}")


def want_tool_launches(name: str, argv: list, env: dict, launches: dict) -> dict:
    """The launches a tool's run makes on the card (the production config:
    5 AR launches a window step, one encoder launch a window step or call,
    one conv-front launch a conv of every bf16 encoder call), by kernel and
    by pack, zero for every kernel not named. The HTTP ticks
    depend on when the clients' chunks arrive: there the AR launches must be
    5 per encoder launch, and the ticks between one per timed chunk of a
    batch and one per chunk."""
    levels = len(tcfg.ModelConfig().vae.patch_nums)
    convs = len(tcfg.ModelConfig().wav2vec.conv_dim) + 1
    pack = {"int8": "int8", "fast": "bf16"}.get(env.get("ARTALK_AR_PRECISION"), "f32")

    def flag(name: str) -> str:
        return argv[argv.index(name) + 1]

    want = dict.fromkeys(launches, 0)
    if name == "bench_streampool":
        sizes = [int(b) for b in flag("--sizes").split(",")]
        calls = 1 + int(flag("--iters"))       # the warm-up step, then the timed ones
        # float32 packs: the AR stack at B <= 2, the encoder's at B = 1
        want[f"ar/{pack}"] = levels * calls * sum(1 for b in sizes if pack != "f32" or b <= 2)
        want[f"encoder/{pack}"] = calls * sum(1 for b in sizes if pack != "f32" or b == 1)
        want["conv_frontend"] = convs * calls * len(sizes) if pack != "f32" else 0
    elif name == "bench_http_serving":
        clients = [int(c) for c in argv[argv.index("--clients") + 1:argv.index("--windows")]]
        windows = int(flag("--windows"))
        ticks = launches["encoder"]
        if not (sum(1 + windows for n in clients) <= ticks <= sum(n * (1 + windows)
                                                                   for n in clients)):
            raise AssertionError(f"[tools] bench_http_serving: {ticks} ticks for clients "
                                 f"{clients} x {1 + windows} chunks")
        want["ar/int8"], want["encoder/int8"] = levels * ticks, ticks   # --precision int8
        want["conv_frontend"] = convs * ticks
    elif name == "profile_pipeline":
        want["rasterize"] = 25 * (1 + int(flag("--iters")))
    elif name == "profile_encoder":
        want["encoder/bf16"] = want["encoder/int8"] = 1 + int(flag("--iters"))
        # the bf16 encoder's full call, plain and with each fused pack
        want["conv_frontend"] = 3 * convs * (1 + int(flag("--iters")))
    elif name == "profile_gsplat":
        calls = 1 + int(flag("--iters"))
        want["gsplat"] = calls                         # S4
        want["sort"] = 3 * calls + 2                   # S2-S4, prepass and the S3 check
    elif name == "profile_gaga":
        from artalk_tpu_torch.tools import profile_gaga
        frames = (1 + profile_gaga.ITERS) * int(flag("--k"))
        want["gsplat"] = 3 * frames                    # full, no-SR, full-bf16
        want["sort"] = 3 * frames + 1                  # and frame 0's instance count
    for kernel in ("ar", "encoder"):
        want[kernel] = sum(want[f"{kernel}/{p}"] for p in PACKS)
    return want


def phase_tools() -> dict:
    """Phase 35: each tool's main on the card at a reduced depth (TOOL_RUNS),
    the launch counts set to 0 just before and read just after it. Its
    output is echoed; every timed line must parse with a finite time, and
    its launches, the block stacks' by pack, must equal
    ``want_tool_launches``. Returns each run's launches, keyed "<tool>
    <argv>"."""
    out = {}
    for name, argv, env in TOOL_RUNS:
        module = importlib.import_module(f"artalk_tpu_torch.tools.{name}")
        tag = f"{name} {' '.join(argv)}"
        buf = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = bench.with_env(env, lambda: module.main(argv))
        seconds = time.perf_counter() - t0
        launches = tool_launches()
        text = buf.getvalue()
        for line in text.splitlines():
            print(f"[tools] {name} | {line}")
        timed = TOOL_LINE.findall(text)
        print(f"[tools] {tag}{f' {env}' if env else ''}: {seconds:.1f} s, {len(timed)} timed "
              f"lines, launches {launches}")
        if not text.startswith("device: ") or not timed or not all(
                math.isfinite(float(v)) for _, v, _ in timed):
            raise AssertionError(f"[tools] {tag}: output does not parse:\n{text}")
        if name == "profile_gsplat" and not result:
            raise AssertionError("[tools] profile_gsplat: S3 differs from prepass")
        want = want_tool_launches(name, argv, env, launches)
        if launches != want:
            raise AssertionError(f"[tools] {tag}: launches {launches}, want {want}")
        out[tag] = launches
        torch.cuda.empty_cache()
    return out


def nan_model(cfg: tcfg.ModelConfig, dev: torch.device) -> BitwiseARModel:
    """A model for ``cfg`` on ``dev`` whose every float tensor is NaN: a
    load that misses one leaves it unequal to anything."""
    model = BitwiseARModel(cfg).to(dev)
    for t in model.state_dict().values():
        if t.is_floating_point():
            t.fill_(float("nan"))
    return model


def unequal_tensors(model, want: dict) -> list:
    """The state-dict keys of ``model`` whose tensor (taken whole) differs
    from ``want``'s, and the keys of one the other lacks."""
    got = model.state_dict()
    return sorted(set(got) ^ set(want)) + [
        k for k in got if k in want and not torch.equal(whole(got[k]), want[k])]


def timed(fn) -> tuple:
    """(fn(), seconds by the host clock around synchronised work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def read_back(path: str) -> dict:
    """A video ``write_video`` wrote, read with the port's own readers: the
    Y4M tier (frames through yuv420p_to_rgb, the sibling WAV's rate and
    length), the .npz tier (read_video_npz), or, for an encoded video,
    PyAV's readers where av is installed (lossy: ``lossless`` False)."""
    if path.endswith(".y4m"):
        planes, fps = read_y4m(path)
        with wave.open(path[:-4] + ".wav") as f:
            rate, samples = f.getframerate(), f.getnframes()
        return {"rgb": yuv420p_to_rgb(planes), "fps": fps, "rate": rate, "samples": samples,
                "lossless": True}
    if path.endswith(".npz"):
        rgb, fps, audio, rate = read_video_npz(path)
        return {"rgb": rgb, "fps": fps, "rate": rate, "samples": len(audio), "lossless": True}
    rgb, fps = read_all_video_frames(path)
    info = get_video_info(path)
    return {"rgb": rgb, "fps": fps, "rate": info["audio"]["sample_rate"], "samples": None,
            "lossless": False}


def phase_checkpoint(dev: torch.device, audio: np.ndarray, exact_bits: np.ndarray,
                     int8_bits: np.ndarray, smi: str) -> dict:
    """Phase 36: the checkpoint and video modules at full width. The seed-0
    production engine's model through save_params_npz / load_params into a
    NaN model (every tensor equal; the restored model's exact and int8 window-0
    code bits equal phases 5 and 8's, with the int8 kernels' launches
    counted); save_params_sharded of that model sharded on a (1, 1) NCCL
    mesh, load_params_sharded into a sharded NaN model, a plain one, and
    (after the group is destroyed) a plain one with no group, each equal;
    then 1 s of audio through the engine on the restored model, 25 mesh
    frames rendered (rasterizer launches counted) and written as yuv420
    planes and as RGB by write_video, each read back by the port's readers
    and checked (25 frames at 25 fps, 16 kHz audio of 16 000 samples, the
    RGB within 3 of the rendered frames on 2x2-constant blocks), and the
    PyAV readers run where av is installed, else raising their
    RuntimeError. Returns each kernel's launches (by pack for the block
    stacks) summed over the two windows, the engine's inference and the
    render."""
    cfg = tcfg.ModelConfig()
    out_dir = os.path.join(ROOT, "render_results", "chip_smoke", "checkpoint")
    engine = build_engine(dev, {}, cfg)
    original = engine.model
    want = {k: v.clone() for k, v in original.state_dict().items()}
    npz = os.path.join(out_dir, "params.npz")
    _, npz_save_s = timed(lambda: save_params_npz(original, npz))
    restored, npz_load_s = timed(lambda: load_params(npz, like=nan_model(cfg, dev)))
    bad = {"npz": unequal_tensors(restored, want)}
    counted: dict = {}
    with torch.no_grad():
        zero_launches()
        bits = window0_bits(restored, audio)
        exact_launches = launch_counts()
        add_launches(counted)
        restored.set_precision(bench.with_env(MODES["int8"], lambda: tcfg.precision_from_env(cfg)))
        zero_launches()
        bits8 = window0_bits(restored, audio)
        int8_launches = launch_counts()
        add_launches(counted)
    restored.set_precision(cfg)

    sharded_dir = os.path.join(out_dir, "sharded")
    info = initialize_multihost(coordinator_address=f"127.0.0.1:{free_port()}",
                                num_processes=1, process_id=0)
    try:
        mesh = make_mesh(device_type="cuda")
        shard_params(original, mesh)
        _, sh_save_s = timed(lambda: save_params_sharded(original, sharded_dir))
        loaded = {}
        for name, model in (("sharded", shard_params(nan_model(cfg, dev), mesh)),
                            ("plain", nan_model(cfg, dev))):
            model, loaded[name] = timed(lambda: load_params_sharded(sharded_dir, model))
            bad[f"sharded->{name}"] = unequal_tensors(model, want)
            del model
    finally:
        dist.destroy_process_group()
    model, loaded["plain, no group"] = timed(lambda: load_params_sharded(sharded_dir,
                                                                         nan_model(cfg, dev)))
    bad["sharded->plain, no group"] = unequal_tensors(model, want)
    files = sorted(os.listdir(sharded_dir))
    sizes = {"npz": os.path.getsize(npz), "sharded": sum(
        os.path.getsize(os.path.join(sharded_dir, f)) for f in files)}
    del model, original
    torch.cuda.empty_cache()

    engine.model = restored
    clip = audio[: engine.cfg.sample_rate]
    zero_launches()
    motions = engine.inference(clip)
    add_launches(counted)
    verts = engine.flame.motion_to_verts(torch.zeros(len(motions), 300, device=dev),
                                         torch.from_numpy(motions).to(dev))
    zero_launches()
    with torch.no_grad():
        rgb = torch.clamp(engine.mesh_renderer(verts), 0.0, 1.0)
        raster = since_zero()["rasterize"]
        add_launches(counted)
        planes = rgb_to_yuv420p(rgb, channel_axis=-1).cpu().numpy()
        rgb8 = torch.floor(torch.clamp(rgb * 255.0, 0.0, 255.0)).to(torch.uint8).cpu().numpy()
    # pixels of 2x2 blocks of one colour, where 4:2:0 chroma loses nothing
    blocks = rgb8.reshape(len(rgb8), IMAGE // 2, 2, IMAGE // 2, 2, 3)
    flat = (blocks == blocks[:, :, :1, :, :1]).all(axis=(2, 4, 5))
    flat = np.repeat(np.repeat(flat, 2, axis=1), 2, axis=2)
    videos = {"yuv420": write_video(planes, os.path.join(out_dir, "clip_yuv.mp4"), cfg.fps, clip,
                                    cfg.sample_rate, pix_fmt="yuv420"),
              "rgb24": write_video(rgb8, os.path.join(out_dir, "clip_rgb.mp4"), cfg.fps, clip,
                                   cfg.sample_rate, pix_fmt="rgb24")}
    read, video_err = {}, {}
    for fmt, path in videos.items():
        read[fmt] = r = read_back(path)
        if r["rgb"].shape != rgb8.shape or r["fps"] != cfg.fps or r["rate"] != cfg.sample_rate \
                or r["samples"] not in (None, len(clip)):
            raise AssertionError(f"[checkpoint] {path}: frames {r['rgb'].shape}, fps {r['fps']}, "
                                 f"audio {r['rate']} Hz x {r['samples']}, want {rgb8.shape}, "
                                 f"{cfg.fps}, {cfg.sample_rate} x {len(clip)}")
        diff = np.abs(r["rgb"].astype(np.int16) - rgb8.astype(np.int16)).max(axis=-1)
        video_err[fmt] = int(diff[flat].max())
    try:
        import av  # noqa: F401
        have_av = True
    except ImportError:
        have_av = False
    if have_av:
        av_read = {fmt: (get_video_info(p)["video"]["num_frames"],
                         read_all_video_frames(p)[0].shape) for fmt, p in videos.items()}
    else:
        av_read = {}
        for fn in (get_video_info, read_all_video_frames):
            try:
                fn(videos["rgb24"])
            except RuntimeError as e:
                av_read[fn.__name__] = str(e)
            else:
                raise AssertionError(f"[checkpoint] {fn.__name__} ran without PyAV")

    flipped = {"exact": int((bits != exact_bits).sum()), "int8": int((bits8 != int8_bits).sum())}
    print(f"[checkpoint] {smi}: npz save_params_npz {npz_save_s:.2f} s ({sizes['npz'] / 1e9:.3f} "
          f"GB stored), load_params {npz_load_s:.2f} s; sharded checkpoint on NCCL job {info},"
          f" mesh {tuple(mesh.shape)}: save_params_sharded {sh_save_s:.2f} s "
          f"({sizes['sharded'] / 1e9:.3f} GB in {files}), load_params_sharded "
          + ", ".join(f"{k} {v:.2f} s" for k, v in loaded.items()))
    print(f"[checkpoint] {smi}: tensors differing {bad}; the restored model's window-0 code "
          f"bits differing from phase 5's exact {flipped['exact']} and phase 8's int8 "
          f"{flipped['int8']} of {bits.size}; launches exact {exact_launches}, int8 "
          f"{int8_launches}; the phase's launches {counted}")
    print(f"[checkpoint] {smi}: {len(motions)} frames rendered with {raster} rasterizer "
          f"launches, written {videos}, read back at "
          + ", ".join(f"{f} {r['fps']} fps / {r['rate']} Hz" for f, r in read.items())
          + f"; RGB max abs err on 2x2-constant blocks ({flat.mean():.3f} of the pixels) "
          f"{video_err}; PyAV readers: {av_read}")
    if any(bad.values()) or any(flipped.values()):
        raise AssertionError(f"[checkpoint] tensors {bad}, bits {flipped}")
    if any(exact_launches.values()) or int8_launches != {"ar": len(cfg.vae.patch_nums),
                                                         "encoder": 1, "flash": 0}:
        raise AssertionError(f"[checkpoint] launches exact {exact_launches}, int8 "
                             f"{int8_launches}")
    if files != [".metadata", "__0_0.distcp"]:
        raise AssertionError(f"[checkpoint] the sharded checkpoint holds {files}")
    if len(motions) != 25 or raster != 25 or not flat.any() or any(
            video_err[f] > 3 for f, r in read.items() if r["lossless"]):
        raise AssertionError(f"[checkpoint] {len(motions)} frames, {raster} rasterizer launches, "
                             f"RGB errors {video_err}")
    no_other_launches("checkpoint", counted)
    return counted


def under(tools: dict, kernel: str) -> dict:
    """Phase 35's launches of ``kernel`` ("ar/int8" for a block stack's
    pack) by tool run, as counted, for the kernels line."""
    return {tag: launches[kernel] for tag, launches in tools.items() if launches[kernel]}


def wide_entry(rows: dict, kernel: str):
    """A block stack's phase 35 check at B = POOL_WIDE for the kernels line,
    or None where the pack was not run there."""
    if kernel not in rows:
        return None
    return {"batch": POOL_WIDE, **{k: v for k, v in rows[kernel].items() if k != "plain"},
            "max_abs_err": rows[kernel]["plain"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    flame_data = load_or_synthesize_flame(os.path.join(ROOT, "assets"))
    dev = torch.device("cuda")
    kernel = phase_kernel(flame_data, dev)
    phase_golden(dev)
    raster_launches, exact_bits, exact_ms, audio, motions, full_engine = phase_full(dev)
    sampled = {"exact": phase_sampled(full_engine, audio, "exact")}
    pool_wide = {"exact": phase_pool_wide(full_engine)}
    del full_engine
    torch.cuda.empty_cache()

    modes, engine = {"exact": {"ms_window": exact_ms}}, None
    for mode in MODES:
        engine = None
        torch.cuda.empty_cache()
        engine, modes[mode] = phase_mode(mode, dev, exact_bits)
    pool = phase_pool(engine)           # the int8 engine, the last mode
    pool_wide["int8"] = phase_pool_wide(engine)
    served = phase_server(engine, audio)
    sampled["int8"] = phase_sampled(engine, audio, "int8")
    model = engine.model
    ar_packs = {"f32": ar_stack.pack_block_weights(model.blocks, model.num_heads),
                "bf16": ar_stack.pack_block_weights(model.blocks, model.num_heads,
                                                    torch.bfloat16),
                "int8": model.fused_pack}
    enc_packs = {"f32": model.audio_encoder.pack_fused(torch.float32),
                 "bf16": model.audio_encoder.pack_fused(torch.bfloat16),
                 "int8": model.fused_audio_pack}
    ar_err = phase_ar_kernel(model, ar_packs)
    serving = {"ar/int8": phase_ar_serving(model, ar_packs["int8"])}
    enc_err = phase_encoder_kernel(model, enc_packs)
    serving["encoder/int8"] = phase_encoder_serving(model, enc_packs["int8"])
    times = phase_times(model, ar_packs, enc_packs)
    serving_times = phase_serving_times(model, ar_packs["int8"], enc_packs["int8"])
    del engine, model, ar_packs, enc_packs
    torch.cuda.empty_cache()
    conv = phase_conv_front(dev)
    splat, gaga_sorts, splat_scenes = phase_gaga_all(dev, audio, motions)
    phase_sort_path(splat_scenes["avatar"])
    torch.cuda.empty_cache()

    flash_err = phase_flash_kernel(dev)
    flash = {}
    for mode in FLASH_MODES:
        torch.cuda.empty_cache()
        flash[mode] = phase_flash_path(mode, dev, exact_bits, audio)
    hubert = phase_hubert(dev, audio)
    mimi = {}
    for mode in MIMI_MODES:
        torch.cuda.empty_cache()
        mimi[mode] = phase_mimi(mode, dev, audio)
    flash_times = phase_flash_times(dev, exact_ms)

    scene_keys = {f"{scene} scene": instance_keys(args) for scene, args in splat_scenes.items()}
    sort_err = phase_sort_kernel(dev, scene_keys)
    debug = phase_debug_renderers(dev, flame_data, motions)
    phase_evaluation(dev, flame_data, motions, modes["int8"]["motions"], audio)
    sort_times = phase_sort_times(dev, scene_keys["avatar scene"])
    phase_tf32_probe()

    torch.cuda.empty_cache()
    train_stages = {"vae": phase_train_vae(dev)}
    ar_model, train_stages["ar"] = phase_train_ar(dev)
    phase_train_cpu(ar_model, dev)
    train_launches = phase_train_kernel(ar_model, dev)
    del ar_model
    torch.cuda.empty_cache()
    checkpoint = phase_train_cli(dev, audio)
    torch.cuda.empty_cache()
    phase_export(dev, audio, checkpoint)
    torch.cuda.empty_cache()
    parallel = phase_parallel(dev, flame_data, audio, motions, exact_bits,
                              modes["int8"]["bits"])
    torch.cuda.empty_cache()
    phase_bench()
    torch.cuda.empty_cache()
    tools = phase_tools()
    torch.cuda.empty_cache()
    ckpt = phase_checkpoint(dev, audio, exact_bits, modes["int8"]["bits"], smi)
    print(f"[train summary] {smi}: " + "; ".join(
        f"{tag} {v['ms_step']:.3f} ms/step at batch {TRAIN_BATCH}, peak "
        f"{v['peak_gib']:.2f} GiB, bound {v['bound_ms']:.3f} ms ({v['bound_by']})"
        for tag, v in train_stages.items()))

    print(f"[summary] {smi}: inference ms/window by mode "
          + ", ".join(f"{m} {v['ms_window']:.2f}" for m, v in modes.items())
          + f"; StreamPool int8 {pool['ms_tick']:.2f} ms/tick (B = {POOL_WIDE}, least code "
          f"bits agreeing: exact {pool_wide['exact']['agree']}, int8 "
          f"{pool_wide['int8']['agree']}, int8's mean with batch-1 streams "
          f"{pool_wide['int8']['stream_agree']:.4f}); HTTP chunk request ms at 1 / 2 "
          f"sessions {served['ms_chunk_1']:.2f} / {served['ms_chunk_2']:.2f}, /v1/motion "
          f"{served['ms_motion']:.1f} ms; sampled launches int8 {sampled['int8']['launches']}"
          "; GAGAvatar ms/frame "
          + ", ".join(f"{m} {splat[c]['ms_frame']:.2f}" for m, c in GAGA_MODES.items())
          + "; flash wav2vec ms/window " + ", ".join(f"{m} {v['ms_window']:.2f}"
                                                     for m, v in flash.items())
          + "; HuBERT ms/call flash " + ", ".join(f"{v['flash']:.2f}" for v in hubert.values())
          + "; Mimi ms/window " + ", ".join(f"{m} {v['ms_window']:.2f}" for m, v in mimi.items())
          + f"; sort kernel {sort_times['ms']:.4f} ms a frame ({gaga_sorts} sorts in 250 exact "
          f"GAGAvatar frames; debug renderers {debug}); whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    kernels = [{"name": "rasterize", "route": "cuda",
                "source": "artalk_tpu_torch/csrc/rasterizer.cu",
                "replaces": "artalk_tpu/ops/rasterizer.py:196",
                "launches": raster_launches, "parallel_launches": parallel["rasterize"],
                "tool_launches": under(tools, "rasterize"),
                "checkpoint_launches": ckpt["rasterize"], **kernel}]
    for mode, pack in PACK_OF_MODE.items():
        name = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}[pack]
        kernels.append({"name": f"ar_block_stack/{name}", "route": "cuda",
                        "source": "artalk_tpu_torch/csrc/ar_block_stack.cu",
                        "replaces": "artalk_tpu/ops/ar_block_stack.py:350",
                        "launches": modes[mode]["launches"]["ar"],
                        "parallel_launches": parallel[f"ar/{name}"],
                        "tool_launches": under(tools, f"ar/{name}"),
                        "checkpoint_launches": ckpt[f"ar/{name}"],
                        "wide": wide_entry(pool_wide["int8"]["kernels"], f"ar/{name}"),
                        "serving": serving.get(f"ar/{name}"),
                        "serving_times": {k: v for k, v in serving_times.items()
                                          if k.startswith(f"ar/{name}/")},
                        "max_abs_err": ar_err[name], **times[f"ar/{name}"]})
        kernels.append({"name": f"encoder_block_stack/{name}", "route": "cuda",
                        "source": "artalk_tpu_torch/csrc/encoder_block_stack.cu",
                        "replaces": "artalk_tpu/ops/encoder_block_stack.py:339",
                        "launches": modes[mode]["launches"]["encoder"],
                        "parallel_launches": parallel[f"encoder/{name}"],
                        "tool_launches": under(tools, f"encoder/{name}"),
                        "checkpoint_launches": ckpt[f"encoder/{name}"],
                        "wide": wide_entry(pool_wide["int8"]["kernels"], f"encoder/{name}"),
                        "serving": serving.get(f"encoder/{name}"),
                        "serving_times": {k: v for k, v in serving_times.items()
                                          if k.startswith(f"encoder/{name}/")},
                        **train_launches.get(name, {
                            "train_launches": 0, "train_max_abs_err": None,
                            "train_condition_max_abs_err": None}),
                        "max_abs_err": enc_err[name], **times[f"encoder/{name}"]})
    for colors in ("f32", "bf16"):
        kernels.append({"name": f"gsplat/{colors}", "route": "cuda",
                        "source": "artalk_tpu_torch/csrc/gsplat.cu",
                        "replaces": "artalk_tpu/ops/gsplat.py:638",
                        "parallel_launches": parallel["gsplat"],
                        "checkpoint_launches": ckpt["gsplat"],
                        "tool_launches": under(tools, "gsplat") if colors == "f32" else {},
                        **{k: v for k, v in splat[colors].items() if k != "ms_frame"}})
    for tag, mode in (("f32", "exact"), ("bf16", "fast")):
        kernels.append({"name": f"flash_attention/{tag}", "route": "cuda",
                        "source": "artalk_tpu_torch/csrc/flash_attention.cu",
                        "replaces": "artalk_tpu/ops/attention.py:97",
                        "launches": flash[mode]["launches"]["flash"],
                        "parallel_launches": parallel["flash"],
                        "checkpoint_launches": ckpt["flash"],
                        "tool_launches": under(tools, "flash"),
                        "max_abs_err": flash_err[tag], **flash_times[tag]})
    kernels.append({"name": "sort_keys", "route": "cuda",
                    "source": "artalk_tpu_torch/csrc/sort.cu",
                    "replaces": "tools/exp_pallas_sort.py:106", "launches": gaga_sorts,
                    "parallel_launches": parallel["sort"], "checkpoint_launches": ckpt["sort"],
                    "tool_launches": under(tools, "sort"),
                    "max_abs_err": sort_err, **sort_times})
    kernels.append({"name": "conv_frontend", "route": "cuda",
                    "source": "artalk_tpu_torch/csrc/conv_frontend.cu",
                    "replaces": "cuDNN's float32 convolution of bf16 values (no pl.pallas_call)",
                    "launches": {m: modes[m]["conv_launches"] for m in MODES},
                    "layers": conv["layers"], "front": {k: v for k, v in conv.items()
                                                        if k.startswith("front/")},
                    "times": conv["times"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
