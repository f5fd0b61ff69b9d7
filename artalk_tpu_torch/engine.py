"""ARTAvatarInferEngine: the top-level speech -> talking-head pipeline.

Counterpart of ``artalk_tpu/engine.py``: ``inference`` (audio -> smoothed
106-d motion), ``stream`` (window by window with a resumable carry),
``set_style_motion``, and ``rendering`` with the mesh renderer
(``shape_id="mesh"``) or, with ``load_gaga=True``, the GAGAvatar renderer
(``shape_id=<avatar id>``). Everything runs on one ``device``: "cuda" by
default, where the rasterizer, the splat and the block stacks are CUDA
kernels; "cpu" runs the plain versions and must be asked for explicitly.

The precision mode is read from the environment at construction, as the JAX
engine reads it (``config.precision_from_env``), and the model is built in
it with its weight packs (``utils/params.load_model``).

The audio encoder follows the configuration: ``"AUDIO_ENCODER": "mimi"`` in
``<assets_dir>/config.json`` (``ARConfig.audio_encoder``) selects the Mimi
codec, ``"whisper"`` Whisper large-v3's encoder (widths from the optional
``WHISPER_CONFIG`` group), and ``Wav2VecConfig.use_flash_attention`` routes the
wav2vec2 layers' attention through the flash-attention kernel. On Whisper the
stream's carry (``last_stream_state``) holds the audio context too, so a
resumed stream hears its last 26 s.

The engine feeds the metrics registry (``utils/metrics.GLOBAL_METRICS``) at
the JAX engine's names and places: the stages ``inference.generate``,
``inference.postprocess``, ``stream.window_step``, ``render.flame_verts`` and
``render.rasterize``, the counters ``inference.windows``, ``inference.frames``
and ``render.frames``. Besides them, spans (in the registry's ring only, so
its snapshot stays the JAX engine's): ``inference.download`` (the motion's
copy to the host, which waits for the device), the window step's
``window.encode``, ``window.decode`` and ``window.vae`` (``ar_model.py``),
the Mimi encoder's ``mimi.*`` (``models/mimi.py``) and Whisper's
``whisper.*`` (``models/whisper.py``; their ``device_us`` read after
``inference.download``), the mesh renderer's ``mesh.*`` and
GAGAvatar's ``gaga.*``. A stage or span times the host and adds no
synchronisation.

Importing this module turns TF32 off for matmuls and cuDNN convolutions:
greedy code bits flip under TF32 (through the wav2vec conv frontend, the
grouped pos-conv and the exact resize matrices), so exact mode needs full
float32 everywhere.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from .config import ModelConfig, assets_config, precision_from_env
from .models.ar_model import WindowState
from .models.flame import FlameModel
from .models.gagavatar import GAGAvatar
from .models.nn import full_float32
from .models.renderer import MeshRenderer
from .ops.savgol import smooth_motion_savgol
from .utils.assets import load_or_synthesize_flame
from .utils.metrics import GLOBAL_METRICS
from .utils.params import load_model
from .utils.video import write_video

full_float32()


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' explicitly to "
                           "run the plain versions on the CPU")
    return device


class ARTAvatarInferEngine:
    def __init__(self, load_gaga: bool = False, fix_pose: bool = False,
                 clip_length: int = 750, assets_dir: str = "assets",
                 output_dir: Optional[str] = None,
                 config: Optional[ModelConfig] = None,
                 params: Optional[Dict[str, np.ndarray]] = None,
                 image_size: int = 512, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        """``params`` is a flat ``//``-keyed JAX parameter dict (see
        ``utils/params.py``); without it the engine loads
        ``<assets_dir>/artalk_params.npz`` when present, else initializes
        random weights from ``torch.Generator().manual_seed(seed)``. With
        ``load_gaga`` it also builds the GAGAvatar renderer
        (``models/gagavatar``; its own weights from
        ``<assets_dir>/gagavatar_params.npz`` or random)."""
        self.device = resolve_device(device)
        self.fix_pose = fix_pose
        self.clip_length = clip_length
        self.assets_dir = assets_dir

        self.cfg = precision_from_env(config or assets_config(assets_dir))
        self.model = load_model(self.cfg, params, os.path.join(assets_dir, "artalk_params.npz"),
                                seed, self.device)

        flame_data = load_or_synthesize_flame(assets_dir)
        self.flame = FlameModel(flame_data, n_shape=300, n_exp=100, scale=1.0).to(self.device)
        self.mesh_renderer = MeshRenderer(
            image_size=image_size, faces=flame_data["faces"], scale=1.0,
            template_verts=flame_data["v_template"], device=self.device)

        if load_gaga:
            self.gagavatar = GAGAvatar(assets_dir=assets_dir, device=self.device)
            self.gagavatar_flame = FlameModel(flame_data, n_shape=300, n_exp=100,
                                              scale=5.0).to(self.device)

        self.output_dir = output_dir or "render_results/ARTAvatar_tpu_torch"
        os.makedirs(self.output_dir, exist_ok=True)
        self.style_motion: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ style

    def set_style_motion(self, style_motion: Union[str, np.ndarray]) -> None:
        """Set the 50-frame (2 s) style clip: an id under assets/style_motion/
        (.npy or .pt) or an array."""
        if isinstance(style_motion, str):
            base = os.path.join(self.assets_dir, "style_motion", style_motion)
            if os.path.exists(base + ".npy"):
                style_motion = np.load(base + ".npy")
            elif os.path.exists(base + ".pt"):
                style_motion = torch.load(base + ".pt", map_location="cpu",
                                          weights_only=True).numpy()
            else:
                raise FileNotFoundError(f"no style motion {base}.npy / .pt")
        style_motion = np.asarray(style_motion, np.float32)
        assert style_motion.shape == (50, 106), \
            f"Invalid style_motion shape: {style_motion.shape}."
        self.style_motion = torch.from_numpy(style_motion)[None].to(self.device)

    def _style_cond(self) -> torch.Tensor:
        return self.model.encode_style(self.style_motion)

    # -------------------------------------------------------------- inference

    def _postprocess(self, motions: torch.Tensor, fix_pose: bool) -> torch.Tensor:
        """Savitzky-Golay smoothing + dim zeroing (pose dims with fix_pose,
        and always the last two jaw dims)."""
        smoothed = smooth_motion_savgol(motions)
        if fix_pose:
            smoothed[..., 100:103] = 0.0
        smoothed[..., 104:] = 0.0
        return smoothed

    def inference(self, audio: np.ndarray, clip_length: Optional[int] = None) -> np.ndarray:
        """16 kHz mono audio -> (T, 106) smoothed motion, T = ceil(len/640),
        cut to ``clip_length`` frames."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        cfg = self.cfg
        seq_length = math.ceil(len(audio) / cfg.sample_rate * cfg.fps)
        ws = self.model.window_samples
        n_windows = max(1, math.ceil(seq_length / cfg.vae.window))
        padded = np.zeros(n_windows * ws, np.float32)
        padded[: len(audio)] = audio[: n_windows * ws]
        chunks = torch.from_numpy(padded.reshape(n_windows, 1, ws)).to(self.device)
        with GLOBAL_METRICS.stage("inference.generate"):
            motions = self.model.generate(chunks, self._style_cond())
        GLOBAL_METRICS.count("inference.windows", n_windows)
        GLOBAL_METRICS.count("inference.frames", seq_length)
        with GLOBAL_METRICS.stage("inference.postprocess"):
            motions = self._postprocess(motions[:, :seq_length], self.fix_pose)
        clip_length = clip_length if clip_length is not None else self.clip_length
        with GLOBAL_METRICS.span("inference.download"):
            motions = motions[0].cpu().numpy()
        GLOBAL_METRICS.read_device_times()
        return motions[:clip_length]

    def stream(self, audio_chunks: Iterator[np.ndarray],
               state: Optional[WindowState] = None) -> Iterator[np.ndarray]:
        """Streaming decode: yields (frames, 106) raw motion per chunk of at
        most one window (4 s). Short chunks are zero-padded like the offline
        path; a longer chunk raises. ``last_stream_state`` holds the carry
        after each chunk; pass it as ``state`` to resume a stream."""
        ws = self.model.window_samples
        style_cond = self._style_cond()
        self.last_stream_state: Optional[WindowState] = state
        for chunk in audio_chunks:
            chunk = np.asarray(chunk, np.float32).reshape(-1)
            if len(chunk) > ws:
                raise ValueError(
                    f"stream chunk of {len(chunk)} samples exceeds the "
                    f"{ws}-sample (4 s) window; split it across chunks")
            n_valid = len(chunk)
            buf = np.zeros(ws, np.float32)
            buf[:n_valid] = chunk
            if state is None:
                state = self.model.initial_state(style_cond)
            with GLOBAL_METRICS.stage("stream.window_step"):
                state, motion = self.model.window_step(
                    state, torch.from_numpy(buf[None]).to(self.device), style_cond)
            self.last_stream_state = state
            n_frames = math.ceil(n_valid / self.cfg.sample_rate * self.cfg.fps)
            yield motion[0].cpu().numpy()[:n_frames]

    # -------------------------------------------------------------- rendering

    def rendering(self, audio: np.ndarray, pred_motions: np.ndarray,
                  shape_id: str = "mesh", shape_code: Optional[np.ndarray] = None,
                  save_name: str = "ARTAvatar") -> str:
        """Motions -> rendered video with muxed audio; returns the path.
        ``shape_id="mesh"`` renders the FLAME mesh, an avatar id the GAGAvatar
        (which needs ``load_gaga=True``)."""
        motions = torch.from_numpy(np.asarray(pred_motions, np.float32)).to(self.device)
        t = motions.shape[0]
        GLOBAL_METRICS.count("render.frames", int(t))
        if shape_id == "mesh":
            if shape_code is None:
                shape = motions.new_zeros((t, 300))
            else:
                code = torch.from_numpy(np.asarray(shape_code, np.float32).reshape(1, -1))
                shape = code.to(self.device).expand(t, -1)
            with GLOBAL_METRICS.stage("render.flame_verts"):
                verts = self.flame.motion_to_verts(shape, motions)
            with GLOBAL_METRICS.stage("render.rasterize"):
                frames = self.mesh_renderer.render_frames(verts)
        else:
            if not hasattr(self, "gagavatar"):
                raise RuntimeError(
                    f"shape_id={shape_id!r} requires the GAGAvatar renderer; construct "
                    "ARTAvatarInferEngine(load_gaga=True) or use shape_id='mesh'")
            frames = self.gagavatar.render_motion_sequence(
                shape_id, motions, self.gagavatar_flame, colorspace="yuv420")
        audio = np.asarray(audio, np.float32).reshape(-1)
        audio = audio[: int(t / self.cfg.fps * self.cfg.sample_rate)]
        out_path = os.path.join(self.output_dir, f"{save_name}.mp4")
        return write_video(frames, out_path, self.cfg.fps, audio, self.cfg.sample_rate,
                           pix_fmt="yuv420")

    # ------------------------------------------------------------------- misc

    @staticmethod
    def smooth_motion_savgol(motion: np.ndarray,
                             device: Union[str, torch.device] = "cuda") -> np.ndarray:
        """Savitzky-Golay smoothing of a (..., T, C) motion array on ``device``
        (the smoothing of ``inference``, without its dim zeroing); "cpu"
        must be asked for."""
        x = torch.from_numpy(np.asarray(motion, np.float32)).to(resolve_device(device))
        return smooth_motion_savgol(x).cpu().numpy()
