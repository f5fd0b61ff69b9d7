"""ARTAvatarInferEngine: the top-level speech -> talking-head pipeline.

Counterpart of ``artalk_tpu/engine.py`` on its default path:
``inference`` (audio -> smoothed 106-d motion), ``stream`` (window by window
with a resumable carry), ``set_style_motion``, and ``rendering`` with the
mesh renderer. Everything runs on one ``device``: "cuda" by default, where
the rasterizer is a CUDA kernel; "cpu" runs the plain versions and must be
asked for explicitly.

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

from .config import ModelConfig, load_config
from .models.ar_model import BitwiseARModel, WindowState
from .models.flame import FlameModel
from .models.renderer import MeshRenderer
from .ops.savgol import smooth_motion_savgol
from .utils.assets import load_or_synthesize_flame
from .utils.params import load_params_npz, params_from_flat
from .utils.video import write_video

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _check_ar_precision() -> None:
    """The ARTALK_AR_PRECISION / ARTALK_AR_FUSED switches of the JAX engine:
    only the default ("exact", unfused) is ported; the others raise."""
    ar_prec = os.environ.get("ARTALK_AR_PRECISION", "exact")
    if ar_prec not in ("exact", "fast", "int8"):
        raise ValueError(
            f"ARTALK_AR_PRECISION={ar_prec!r}: expected 'exact', 'fast' or 'int8'")
    if ar_prec != "exact":
        raise NotImplementedError(
            f"ARTALK_AR_PRECISION={ar_prec} is not ported yet (ROADMAP.md "
            "Queue 1 item 8, precision modes, with Queue 2 items 1-2)")
    if os.environ.get("ARTALK_AR_FUSED", "0") not in ("0", ""):
        raise NotImplementedError(
            "ARTALK_AR_FUSED is not ported yet (ROADMAP.md Queue 2 items 1-2: "
            "the ar_block_stack and encoder_block_stack kernels)")


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
        random weights from ``torch.Generator().manual_seed(seed)``."""
        if load_gaga:
            raise NotImplementedError(
                "the GAGAvatar renderer is not ported yet (ROADMAP.md Queue 1 item 10)")
        self.device = resolve_device(device)
        _check_ar_precision()
        self.fix_pose = fix_pose
        self.clip_length = clip_length
        self.assets_dir = assets_dir

        if config is None:
            cfg_path = os.path.join(assets_dir, "config.json")
            config = load_config(cfg_path) if os.path.exists(cfg_path) else ModelConfig()
        self.cfg = config
        if params is None:
            ckpt_path = os.path.join(assets_dir, "artalk_params.npz")
            if os.path.exists(ckpt_path):
                params = load_params_npz(ckpt_path)
            else:
                print(f"[artalk_tpu_torch] no checkpoint at {ckpt_path}; "
                      "initializing random weights")
        if params is None:
            model = BitwiseARModel(config).init(torch.Generator().manual_seed(seed))
        else:
            model = params_from_flat(params, config)
        self.model = model.to(self.device)

        flame_data = load_or_synthesize_flame(assets_dir)
        self.flame = FlameModel(flame_data, n_shape=300, n_exp=100, scale=1.0).to(self.device)
        self.mesh_renderer = MeshRenderer(
            image_size=image_size, faces=flame_data["faces"], scale=1.0,
            template_verts=flame_data["v_template"], device=self.device)

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
        motions = self.model.generate(chunks, self._style_cond())
        motions = self._postprocess(motions[:, :seq_length], self.fix_pose)
        clip_length = clip_length if clip_length is not None else self.clip_length
        return motions[0].cpu().numpy()[:clip_length]

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
            state, motion = self.model.window_step(
                state, torch.from_numpy(buf[None]).to(self.device), style_cond)
            self.last_stream_state = state
            n_frames = math.ceil(n_valid / self.cfg.sample_rate * self.cfg.fps)
            yield motion[0].cpu().numpy()[:n_frames]

    # -------------------------------------------------------------- rendering

    def rendering(self, audio: np.ndarray, pred_motions: np.ndarray,
                  shape_id: str = "mesh", shape_code: Optional[np.ndarray] = None,
                  save_name: str = "ARTAvatar") -> str:
        """Motions -> rendered mesh video with muxed audio; returns the path."""
        if shape_id != "mesh":
            raise NotImplementedError(
                f"shape_id={shape_id!r} needs the GAGAvatar renderer, which is not "
                "ported yet (ROADMAP.md Queue 1 item 10); use shape_id='mesh'")
        motions = torch.from_numpy(np.asarray(pred_motions, np.float32)).to(self.device)
        t = motions.shape[0]
        if shape_code is None:
            shape = motions.new_zeros((t, 300))
        else:
            code = torch.from_numpy(np.asarray(shape_code, np.float32).reshape(1, -1))
            shape = code.to(self.device).expand(t, -1)
        frames = self.mesh_renderer.render_frames(self.flame.motion_to_verts(shape, motions))
        audio = np.asarray(audio, np.float32).reshape(-1)
        audio = audio[: int(t / self.cfg.fps * self.cfg.sample_rate)]
        out_path = os.path.join(self.output_dir, f"{save_name}.mp4")
        return write_video(frames, out_path, self.cfg.fps, audio, self.cfg.sample_rate)
