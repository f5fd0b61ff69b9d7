"""Convert reference PyTorch checkpoints to parameter archives, without jax.

    python -m artalk_tpu_torch.convert_checkpoint KIND SRC DST

    artalk  assets/ARTalk_wav2vec.pt       assets/artalk_params.npz
    gaga    assets/GAGAvatar/GAGAvatar.pt  assets/gagavatar_params.npz
    flame   assets/FLAME_with_eye.pt       assets/flame.npz
    tracked assets/GAGAvatar/tracked.pt    assets/avatars/
    style   assets/style_motion/           assets/style_motion/

Counterpart of ``tools/convert_checkpoint.py``: each kind writes the same
archive, file for file (the parameter archives stored uncompressed), on ``utils/convert.py``,
``utils/params.save_params_npz`` and ``utils/assets.save_flame_npz``. Both
packages load what it writes. A sparse torch ``J_regressor``, which the JAX
tool cannot turn into an array, converts as its dense copy does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .utils.assets import save_flame_npz
from .utils.convert import convert_ar_model, convert_gagavatar
from .utils.params import save_params_npz


def _to_numpy_sd(sd):
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def _dense(x) -> np.ndarray:
    """A dense array of a torch tensor (sparse too) or a scipy matrix."""
    if isinstance(x, torch.Tensor):
        return (x.to_dense() if x.layout != torch.strided else x).numpy()
    return np.asarray(x.todense() if hasattr(x, "todense") else x)


def convert_artalk(src: str, dst: str) -> None:
    sd = _to_numpy_sd(torch.load(src, map_location="cpu", weights_only=True))
    save_params_npz(convert_ar_model(sd), dst)
    print(f"wrote {dst}")


def convert_gaga(src: str, dst: str) -> None:
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    sd = {k: v for k, v in sd.items() if "percep_loss" not in k}
    save_params_npz(convert_gagavatar(_to_numpy_sd(sd)), dst)
    print(f"wrote {dst}")


def convert_flame(src: str, dst: str) -> None:
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    fm = ckpt["flame_model"]
    posedirs = fm["posedirs"].numpy()
    data = {
        "v_template": fm["v_template"].numpy(),
        "shapedirs": fm["shapedirs"].numpy(),
        "posedirs": posedirs.reshape(-1, posedirs.shape[-1]).T.copy(),
        "J_regressor": _dense(fm["J_regressor"]),
        "parents": fm["kintree_table"][0].numpy().astype(np.int32),
        "lbs_weights": fm["weights"].numpy(),
        "faces": fm["f"].numpy().astype(np.int32),
    }
    lmk = ckpt.get("lmk_embeddings")
    if lmk is not None:
        data["full_lmk_faces_idx"] = np.asarray(
            lmk["full_lmk_faces_idx_with_eye"]).astype(np.int64).reshape(-1)
        data["full_lmk_bary_coords"] = np.asarray(
            lmk["full_lmk_bary_coords_with_eye"], np.float32).reshape(-1, 3)
        # 79 yaw-indexed dynamic contour tables (FLAME.py:52-53)
        if "dynamic_lmk_faces_idx" in lmk:
            data["dynamic_lmk_faces_idx"] = np.asarray(
                lmk["dynamic_lmk_faces_idx"]).astype(np.int64)
            data["dynamic_lmk_bary_coords"] = np.asarray(
                lmk["dynamic_lmk_bary_coords"], np.float32)
    save_flame_npz(data, dst)
    print(f"wrote {dst}")


def convert_tracked(src: str, dst_dir: str) -> None:
    # the avatar bank is a pickled dict of dicts: load only a trusted file
    bank = torch.load(src, map_location="cpu", weights_only=False)
    os.makedirs(dst_dir, exist_ok=True)
    for avatar_id, tracked in bank.items():
        out = {}
        for k, v in tracked.items():
            v = v.numpy() if hasattr(v, "numpy") else np.asarray(v, np.float32)
            out[k] = v
        name = os.path.splitext(str(avatar_id))[0]
        np.savez_compressed(os.path.join(dst_dir, f"{name}.npz"), **out)
    print(f"wrote {len(bank)} avatars to {dst_dir}")


def convert_style(src_dir: str, dst_dir: str) -> None:
    os.makedirs(dst_dir, exist_ok=True)
    count = 0
    for f in sorted(os.listdir(src_dir)):
        if not f.endswith(".pt"):
            continue
        motion = torch.load(os.path.join(src_dir, f), map_location="cpu",
                            weights_only=True).numpy()
        np.save(os.path.join(dst_dir, f[:-3] + ".npy"), motion)
        count += 1
    print(f"wrote {count} style motions to {dst_dir}")


CONVERTERS = {
    "artalk": convert_artalk,
    "gaga": convert_gaga,
    "flame": convert_flame,
    "tracked": convert_tracked,
    "style": convert_style,
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("kind", choices=sorted(CONVERTERS))
    parser.add_argument("src")
    parser.add_argument("dst")
    args = parser.parse_args(argv)
    CONVERTERS[args.kind](args.src, args.dst)


if __name__ == "__main__":
    main()
