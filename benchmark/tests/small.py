"""A cell of the benchmark shrunk to run on the CPU in a test: the same
drivers, reference and comparison, at widths a test can hold."""

from __future__ import annotations

import copy
import types

from benchmark import harness

SMALL_MODEL = {
    "sample_rate": 16000, "fps": 25, "window_samples": 2560, "clip_length": 750,
    "wav2vec": {"conv_dim": [16] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
                "conv_stride": [5, 2, 2, 2, 2, 2, 2], "hidden_size": 32,
                "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
                "num_conv_pos_embeddings": 8, "num_conv_pos_embedding_groups": 4,
                "layer_norm_eps": 1e-05, "do_stable_layer_norm": True},
    "ar": {"embed_dim": 32, "depth": 2, "num_heads": 4, "mlp_ratio": 4.0, "style_dim": 16,
           "prev_ratio": 1, "audio_dim": 32},
    "vae": {"motion_dim": 106, "code_dim": 8, "depth": 2, "num_heads": 2, "hidden_dim": 32,
            "patch_nums": [1, 2, 4]},
    "style_encoder": {"feature_dim": 16, "num_layers": 4, "num_heads": 4, "ffn_dim": 512,
                      "max_len": 600},
    "flame": {"num_verts": 5023, "n_shape": 300, "n_exp": 100, "asset_seed": 0},
    "renderer": {"kind": "mesh", "image_size": 64, "chunk": 25},
}


def small_context(workload: str, seed: int = 7, seconds: float = 1.0, traced: bool = False,
                  traffic: dict | None = None):
    """The run context of ``workload`` with the small model on the CPU."""
    import torch

    from benchmark.run import Context

    entry, cell, config = harness.cell_files(workload)
    cell = copy.deepcopy(cell)
    if traffic:
        cell["traffic"].update(traffic)
    config = dict(config, model=copy.deepcopy(SMALL_MODEL))
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=int(traced))
    return Context(args, entry, cell, config, torch.device("cpu"))
