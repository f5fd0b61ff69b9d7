"""The work models from shapes against torch's FLOP counter over the port's
plain path at a small size: the copy agreed when it was made."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import program, work
from benchmark.tests.small import SMALL_MODEL


def _model():
    from artalk_tpu_torch.models.ar_model import BitwiseARModel

    return BitwiseARModel(program.model_config(SMALL_MODEL)).init(
        torch.Generator().manual_seed(0))


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_window_step_and_bootstrap_flops():
    model = _model()
    style = model.encode_style(None)
    state = model.initial_state(style)
    audio = torch.randn(1, model.window_samples, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert _flops(lambda: model.window_step(state, audio, style)) == \
            work.window_step_flops(SMALL_MODEL, SMALL_MODEL["window_samples"])
        assert _flops(lambda: model.initial_state(style)) == work.initial_state_flops(SMALL_MODEL)


def test_clip_flops_match_engine_inference(tmp_path):
    from artalk_tpu_torch.engine import ARTAvatarInferEngine

    model = _model()
    engine = ARTAvatarInferEngine(config=model.cfg, device="cpu", clip_length=750,
                                  assets_dir=str(program.assets_dir(SMALL_MODEL)),
                                  output_dir=str(tmp_path), image_size=64,
                                  params={k.replace(".", "//"): v.numpy()
                                          for k, v in model.state_dict().items()})
    for seconds in (0.1, 0.5):          # savgol shrinks its windows below 9 frames
        audio = torch.randn(int(16000 * seconds)).numpy()
        frames = -(-len(audio) // 640)
        windows = -(-frames // SMALL_MODEL["vae"]["patch_nums"][-1])
        with torch.no_grad():
            assert _flops(lambda: engine.inference(audio)) == \
                work.clip_motion_flops(SMALL_MODEL, windows, frames)


def test_mesh_frame_flops():
    from artalk_tpu_torch.models.flame import FlameModel
    from artalk_tpu_torch.models.renderer import MeshRenderer
    import numpy as np

    data = dict(np.load(program.assets_dir(SMALL_MODEL) / "flame.npz"))
    flame = FlameModel(data, n_shape=300, n_exp=100)
    size = SMALL_MODEL["renderer"]["image_size"]
    render = MeshRenderer(image_size=size, faces=data["faces"], template_verts=data["v_template"],
                          device="cpu")
    m = torch.randn(2, 106, generator=torch.Generator().manual_seed(2)) * 0.1
    with torch.no_grad():
        got = _flops(lambda: render(flame.motion_to_verts(m.new_zeros(2, 300), m)))
    assert got == 2 * work.mesh_frame_flops(SMALL_MODEL)


def test_styleunet_flops():
    from artalk_tpu_torch.models.gagavatar.style_unet import StyleUNet

    net = StyleUNet(in_size=16, out_size=16).init(torch.Generator().manual_seed(0))
    assert _flops(lambda: net(torch.rand(1, 32, 16, 16))) == work.styleunet_flops(16)


def test_block_stack_work_is_the_frozen_model_at_one_row():
    from artalk_tpu_torch.utils import roofline

    for pn, start in ((1, 181), (100, 262)):
        ours = work.ar_level_work(12, 768, 3072, 12, pn, start, itemsize=1, int8=True,
                                  cache_bytes=2)
        theirs = roofline.ar_level_work(12, 768, 3072, 12, pn, start, torch.int8, 2)
        assert (ours.flops, ours.bytes) == (theirs.flops, theirs.bytes)
        rows = work.ar_level_work(12, 768, 3072, 12, pn, start, itemsize=1, int8=True,
                                  cache_bytes=2, rows=3)
        assert rows.flops == 3 * ours.flops and rows.bytes < 3 * ours.bytes
    ours = work.encoder_window_work(24, 1024, 4096, 199, itemsize=1, int8=True)
    theirs = roofline.encoder_window_work(24, 1024, 4096, 199, torch.int8)
    assert (ours.flops, ours.bytes) == (theirs.flops, theirs.bytes)
