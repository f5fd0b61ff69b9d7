"""The training slice of artalk_tpu_torch against the JAX package, on
tests/test_training.py's small CFG with the same seeded numpy inputs and the
same (JAX seed-0) parameters: the BSQ straight-through gradient, the stage-1
and stage-2 losses with the gradients of every leaf of the JAX tree, the
teacher-forced forward (DropPath off, and on with JAX's own masks), the
schedule and the optimizer against optax, the data pipeline's batches, and
the counterparts of tests/test_training.py's loops and of the train CLI.

Values agree to rtol 1e-5 / atol 1e-6 and gradients to 1e-5 of the leaf's
largest |gradient| (float32 on both sides; the sums run in another order).
Whole train steps are compared on the loss trajectory, not on parameters:
where a gradient sits at rounding noise, Adam's first update can take the
other sign."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from artalk_tpu.models.ar_model import BitwiseARModel as JaxARModel
from artalk_tpu.models.bitwise_vae import BitwiseVAE as JaxVAE
from artalk_tpu.models.bsq import MultiScaleBSQ as JaxBSQ
from artalk_tpu.models.bsq import bsq_quantize as jax_bsq_quantize
from artalk_tpu.training import data as jdata
from artalk_tpu.training import losses as jlosses
from artalk_tpu.training import trainer as jtrainer
from artalk_tpu.utils.checkpoint import _flatten, load_params

from artalk_tpu_torch.models.ar_model import BitwiseARModel, drop_path_masks
from artalk_tpu_torch.models.bitwise_vae import BitwiseVAE
from artalk_tpu_torch.models.bsq import MultiScaleBSQ, bsq_quantize
from artalk_tpu_torch.training import data as tdata
from artalk_tpu_torch.training import losses as tlosses
from artalk_tpu_torch.training import train as ttrain
from artalk_tpu_torch.training import trainer as ttrainer
from artalk_tpu_torch.utils.params import SEP, flat_from_module, load_flat_into

from test_torch_params import jax_model_and_flat, port_model, to_np, torch_config
from test_torch_params import torch_threads  # noqa: F401 (autouse)
from test_training import CFG

TCFG = torch_config(CFG)


@pytest.fixture(scope="module")
def batch():
    """tests/test_training.py's data fixture, as numpy."""
    rng = np.random.default_rng(0)
    w = CFG.vae.window
    return {
        "audio": rng.standard_normal((2, 2560)).astype(np.float32) * 0.1,
        "prev": rng.standard_normal((2, w, 12)).astype(np.float32),
        "this": rng.standard_normal((2, w, 12)).astype(np.float32),
        "style": rng.standard_normal((2, 10, 12)).astype(np.float32),
    }


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_grads_close(got: dict, want: dict) -> None:
    """Every leaf of ``want`` (flat JAX keys): ``got`` (None = zero) within
    1e-5 of the leaf's largest |gradient| (1e-12 absolute for a zero leaf)."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = np.zeros_like(w) if got[k] is None else to_np(got[k])
        tol = max(1e-5 * float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)


def port_grads(module: torch.nn.Module, loss: torch.Tensor) -> dict:
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n.replace(".", SEP): g for n, g in zip(names, grads)}


# ----------------------------------------------------------------- BSQ


def test_bsq_straight_through_gradient():
    """The quantizer's gradient is the straight-through estimator's, and the
    pyramid subtracts the detached upsampled value from the residual, as in
    JAX (the port's gradient used to be exactly 0)."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 100, 8)).astype(np.float32)
    w = rng.standard_normal((2, 100, 8)).astype(np.float32)

    want = jax.jit(jax.grad(lambda x: jnp.sum(jax_bsq_quantize(x, 8)[0] * w)))(jnp.asarray(z))
    zt = _t(z).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(bsq_quantize(zt, 8)[0] * _t(w)), zt)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-6)

    want = jax.jit(jax.grad(lambda x: jnp.sum(JaxBSQ(8).encode(x)[0] * w)))(jnp.asarray(z))
    (got,) = torch.autograd.grad(torch.sum(MultiScaleBSQ(8).encode(zt)[0] * _t(w)), zt)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-6)


def test_encode_with_losses_values_and_gradients():
    rng = np.random.default_rng(6)
    f = rng.standard_normal((2, 100, 8)).astype(np.float32)
    w = rng.standard_normal((2, 100, 8)).astype(np.float32)

    def jax_obj(x):
        q, bits, aux = JaxBSQ(8).encode_with_losses(x)
        return jnp.sum(q * w) + jnp.sum(aux * jnp.arange(1.0, 6.0)), (q, bits, aux)

    (_, (jq, jbits, jaux)), jg = jax.jit(jax.value_and_grad(jax_obj, has_aux=True))(
        jnp.asarray(f))
    ft = _t(f).requires_grad_(True)
    tq, tbits, taux = MultiScaleBSQ(8).encode_with_losses(ft)
    obj = torch.sum(tq * _t(w)) + torch.sum(taux * torch.arange(1.0, 6.0))
    (tg,) = torch.autograd.grad(obj, ft)
    np.testing.assert_array_equal(to_np(tbits), np.asarray(jbits))
    np.testing.assert_allclose(to_np(tq), np.asarray(jq), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(taux), np.asarray(jaux), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(tg), np.asarray(jg), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jg)).max()))


def test_encode_with_flips_extremes():
    """flip_ratio 0 gives ``encode``'s bits (and its values but for the last
    bit: the flipped path rebuilds them from the bits); flip_ratio 1 inverts
    every bit of level 0 (later levels see the flipped residual)."""
    f = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 100, 8)).astype(np.float32))
    bsq = MultiScaleBSQ(8)
    gen = torch.Generator().manual_seed(0)
    q0, bits0 = bsq.encode_with_flips(f, 0.0, gen)
    q, bits = bsq.encode(f)
    torch.testing.assert_close(q0, q, rtol=0, atol=1e-6)
    assert torch.equal(bits0, bits)
    _, bits1 = bsq.encode_with_flips(f, 1.0, gen)
    assert torch.equal(bits1[:, :1], 1 - bits[:, :1])


# ----------------------------------------------------------------- stage 1


@pytest.fixture(scope="module")
def vaes():
    """The JAX VAE with the VAE subtree of the seed-0 AR init, and the port's
    VAE holding the same parameters."""
    jvae = JaxVAE(CFG.vae)
    params = jax_model_and_flat(CFG)[1]["vae"]
    tvae = load_flat_into(BitwiseVAE(TCFG.vae), _flatten(params))
    return jvae, params, tvae


def test_vae_loss_value_and_every_gradient(vaes, batch):
    """reconstruct and vae_loss, and the gradient of every leaf of the JAX
    tree, motion_mean and motion_std included (parameters of the port)."""
    jvae, params, tvae = vaes
    prev, this = jnp.asarray(batch["prev"]), jnp.asarray(batch["this"])
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlosses.vae_loss(jvae, p, prev, this), has_aux=True))(params)
    jrec = jax.jit(jvae.reconstruct)(params, prev, this)

    tvae.requires_grad_(True)
    trec = tvae.reconstruct(_t(batch["prev"]), _t(batch["this"]))
    for got, want in zip(trec, jrec):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    tl, tm = tlosses.vae_loss(tvae, _t(batch["prev"]), _t(batch["this"]))
    for k in ("loss", "recon", "aux"):
        np.testing.assert_allclose(to_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    got = port_grads(tvae, tl)
    assert got["motion_mean"] is not None and got["motion_std"] is not None
    assert_grads_close(got, _flatten(jg))


# ----------------------------------------------------------------- stage 2


@pytest.fixture(scope="module")
def ar_models():
    jm, jp, _ = jax_model_and_flat(CFG)
    tm = port_model(CFG)
    return jm, jp, tm


def test_var_attn_bias_exact(ar_models):
    jm, _, tm = ar_models
    np.testing.assert_array_equal(to_np(tm.var_attn_bias()), np.asarray(jm.var_attn_bias()))
    np.testing.assert_allclose(to_np(tm.drop_path_rates()), np.asarray(jm.drop_path_rates()),
                               rtol=1e-6)


def jax_drop_masks(model, key, batch: int) -> np.ndarray:
    """The (depth, 2, B) keep masks JAX's forward_logits draws from ``key``
    (its split into one key per block and branch, then bernoulli over
    (B, 1, 1) at each block's keep probability)."""
    keys = jax.random.split(key, model.depth * 2)
    keys = keys.reshape((model.depth, 2) + keys.shape[1:])
    keep = 1.0 - model.drop_path_rates()
    return np.stack([np.stack([
        np.asarray(jax.random.bernoulli(keys[i, j], keep[i], (batch, 1, 1)))[:, 0, 0]
        for j in range(2)]) for i in range(model.depth)]).astype(np.float32)


def dropping_key(model, batch: int):
    """The first of PRNGKey(0), PRNGKey(1), ... whose masks drop a branch:
    at depth 2 the rates are 0 and 1/120, so most keys drop none."""
    for seed in range(1000):
        key = jax.random.PRNGKey(seed)
        if jax_drop_masks(model, key, batch).min() == 0.0:
            return key
    raise AssertionError("no key in 1000 drops a branch")


def test_drop_path_masks_shape_and_rate():
    rates = torch.tensor([0.0, 0.5])
    m = drop_path_masks(rates, 4000, torch.Generator().manual_seed(0))
    assert m.shape == (2, 2, 4000) and m.dtype == torch.float32
    assert bool((m[0] == 1).all())
    assert abs(float(m[1].mean()) - 0.5) < 0.03


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "jax_masks"])
def test_forward_logits(ar_models, drop):
    """The teacher-forced forward with DropPath off, and on with the masks
    JAX draws inside its forward fed to the port."""
    jm, jp, tm = ar_models
    rng = np.random.default_rng(11)
    b, d = 3, CFG.ar.embed_dim
    tokens = rng.standard_normal((b, jm.total_tokens, d)).astype(np.float32)
    cond = rng.standard_normal((b, jm.total_tokens, CFG.ar.audio_feature_dim)).astype(np.float32)
    prev = rng.standard_normal((b, jm.prev_len, d)).astype(np.float32)
    key = dropping_key(jm, b) if drop else None
    masks = None if key is None else jax_drop_masks(jm, key, b)
    want = jax.jit(jm.forward_logits)(jp, jnp.asarray(tokens), jnp.asarray(cond),
                                      jnp.asarray(prev), drop_path_rng=key)
    got = tm.forward_logits(_t(tokens), _t(cond), _t(prev),
                            None if masks is None else _t(masks))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["no_style", "style", "style_drop_path"])
def test_ar_loss_value_and_every_gradient(ar_models, batch, case):
    """ar_loss and the gradient of every leaf of the JAX tree: zero for the
    frozen VAE and audio encoder (None in the port), the style encoder's
    pe / motion_mean / motion_std included with a style clip."""
    jm, jp, tm = ar_models
    style = batch["style"] if case != "no_style" else None
    key = dropping_key(jm, 2) if case == "style_drop_path" else None
    args = [jnp.asarray(batch[k]) for k in ("audio", "prev", "this")]
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jlosses.ar_loss(jm, p, *args, None if style is None else jnp.asarray(style),
                                  drop_path_rng=key), has_aux=True))(jp)
    masks = None if key is None else _t(jax_drop_masks(jm, key, 2))
    tm.requires_grad_(True)
    try:
        tl, tmet = tlosses.ar_loss(tm, *(_t(batch[k]) for k in ("audio", "prev", "this")),
                                   None if style is None else _t(style), drop_masks=masks)
        got = port_grads(tm, tl)
    finally:
        tm.requires_grad_(False)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-6)
    assert float(tmet["bit_accuracy"]) == float(jmet["bit_accuracy"])
    assert all(got[k] is None for k in got if k.startswith(("vae//", "audio_encoder//")))
    if style is not None:
        assert got["style_encoder//motion_std"] is not None
    assert_grads_close(got, _flatten(jg))


# ----------------------------------------------------------------- optimizer


@pytest.mark.parametrize("warmup,total", [(3, 10), (1, 1), (0, 4)])
def test_schedule_matches_optax(warmup, total):
    opt = ttrainer.make_optimizer(lr=3e-4, warmup_steps=warmup, total_steps=total)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, max(total, warmup + 1))
    steps = sorted({0, 1, 2, 3, 4, 5, max(warmup - 1, 0), warmup, warmup + 1, total, total + 5})
    for s in steps:
        np.testing.assert_allclose(opt.learning_rate(s), float(sched(s)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {s}")
    assert opt.learning_rate(0) == 0.0 or warmup == 0


def test_optimizer_matches_optax_on_identical_gradients(ar_models):
    """The JAX trainer's optax chain and the port's AdamW fed the same
    gradients for 3 steps (global norms 3, 0.5 and 2: clipped, not clipped,
    clipped), zero for the frozen VAE and audio encoder (None in the port):
    every parameter agrees to 1e-6, and the frozen ones were decayed."""
    jm, jp, _ = ar_models
    optimizer = jtrainer.make_optimizer(lr=1e-2, warmup_steps=1)
    state = jtrainer.init_state(jp, optimizer)
    jupdate = jax.jit(optimizer.update)
    tm = port_model(CFG)
    topt = ttrainer.make_optimizer(lr=1e-2, warmup_steps=1)
    tstate = ttrainer.init_state(tm, topt)
    names = [n.replace(".", SEP) for n, _ in tm.named_parameters()]
    flat0 = _flatten(jp)
    rng = np.random.default_rng(3)
    frozen = lambda k: k.startswith(("vae//", "audio_encoder//"))  # noqa: E731
    for target in (3.0, 0.5, 2.0):
        g = {k: (np.zeros_like(v) if frozen(k)
                 else rng.standard_normal(v.shape).astype(np.float32)) for k, v in flat0.items()}
        norm = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g.values()))
        g = {k: (v * (target / norm)).astype(np.float32) for k, v in g.items()}
        jgrads = load_params_from_flat(g, jp)
        updates, opt_state = jupdate(jgrads, state.opt_state, state.params)
        state = jtrainer.TrainState(jax.jit(optax.apply_updates)(state.params, updates), opt_state,
                                    state.step + 1)
        tgrads = [None if frozen(n) else _t(g[n]) for n in names]
        opt_st, norm_t = topt.update(list(tm.parameters()), tgrads, tstate.opt_state)
        tstate = ttrainer.TrainState(tm, opt_st, tstate.step + 1)
        np.testing.assert_allclose(float(norm_t), target, rtol=1e-5)
    want = _flatten(state.params)
    got = {n: to_np(p) for n, p in zip(names, tm.parameters())}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    k = "vae//encoder//inp//w"
    assert not np.array_equal(got[k], flat0[k])   # decayed though frozen
    np.testing.assert_allclose(got[k], flat0[k] * (1 - 1e-2 * 0.01) ** 2, rtol=1e-6)


def test_grad_norm_accurate_on_large_tensors():
    """The clip's global norm of a 16.8 M-element gradient equals the
    float64 norm to 1e-6 (the CPU's float32 ``vector_norm`` of such a
    tensor is off by about 1e-3)."""
    g = torch.randn((4, 1024, 4096), generator=torch.Generator().manual_seed(0)) * 1e-3
    p = torch.zeros_like(g)
    opt = ttrainer.make_optimizer()
    _, norm = opt.update([p], [g], opt.init([p]))
    want = float(g.double().norm())
    np.testing.assert_allclose(float(norm), want, rtol=1e-6)


def load_params_from_flat(flat: dict, like):
    """A JAX pytree shaped like ``like`` from flat ``//`` arrays."""
    paths = jax.tree_util.tree_flatten_with_path(like)[0]
    treedef = jax.tree_util.tree_structure(like)
    leaves = [jnp.asarray(flat[SEP.join(str(p.key) if hasattr(p, "key") else str(p.idx)
                                        for p in path)]) for path, _ in paths]
    return jax.tree_util.tree_unflatten(treedef, leaves)


# ----------------------------------------------------------------- steps


def test_vae_steps_follow_jax_loss_trajectory(vaes, batch):
    """4 whole stage-1 steps from the same weights: the losses of both
    packages agree step by step to rtol 1e-4."""
    jvae, params, _ = vaes
    jopt = jtrainer.make_optimizer(lr=1e-3, warmup_steps=1)
    jstep = jtrainer.make_vae_train_step(jvae, jopt)
    jstate = jtrainer.init_state(params, jopt)
    tvae = load_flat_into(BitwiseVAE(TCFG.vae), _flatten(params))
    topt = ttrainer.make_optimizer(lr=1e-3, warmup_steps=1)
    tstep = ttrainer.make_vae_train_step(tvae, topt)
    tstate = ttrainer.init_state(tvae, topt)
    for _ in range(4):
        jstate, jm = jstep(jstate, jnp.asarray(batch["prev"]), jnp.asarray(batch["this"]))
        tstate, tm = tstep(tstate, _t(batch["prev"]), _t(batch["this"]))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert tstate.step == 4


def test_ar_steps_follow_jax_loss_trajectory(batch):
    """4 whole stage-2 steps with style clips and DropPath off."""
    jm, jp, _ = jax_model_and_flat(CFG)
    jopt = jtrainer.make_optimizer(lr=1e-3, warmup_steps=1)
    jstep = jtrainer.make_ar_train_step(jm, jopt, drop_path=False)
    jstate = jtrainer.init_state(jp, jopt)
    tm = port_model(CFG)
    topt = ttrainer.make_optimizer(lr=1e-3, warmup_steps=1)
    tstep = ttrainer.make_ar_train_step(tm, topt, drop_path=False)
    tstate = ttrainer.init_state(tm, topt)
    for _ in range(4):
        jstate, jmet = jstep(jstate, *(jnp.asarray(batch[k])
                                       for k in ("audio", "prev", "this", "style")))
        tstate, tmet = tstep(tstate, *(_t(batch[k]) for k in ("audio", "prev", "this", "style")))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, err_msg=k)


def test_vae_training_decreases_loss(batch):
    vae = BitwiseVAE(TCFG.vae).init(torch.Generator().manual_seed(0))
    optimizer = ttrainer.make_optimizer(lr=1e-3, warmup_steps=1)
    step = ttrainer.make_vae_train_step(vae, optimizer)
    state = ttrainer.init_state(vae, optimizer)
    losses = []
    for _ in range(8):
        state, metrics = step(state, _t(batch["prev"]), _t(batch["this"]))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_ar_training_decreases_loss(batch):
    model = port_model(CFG)
    optimizer = ttrainer.make_optimizer(lr=1e-3, warmup_steps=1)
    step = ttrainer.make_ar_train_step(model, optimizer)
    state = ttrainer.init_state(model, optimizer)
    losses = []
    for _ in range(8):
        state, metrics = step(state, _t(batch["audio"]), _t(batch["prev"]), _t(batch["this"]))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert state.step == 8


# ----------------------------------------------------------------- data


def test_dataset_batches_equal_jax():
    """synthetic_clips and MotionAudioDataset.batches of one seed give the
    JAX module's arrays bit for bit."""
    jclips = jdata.synthetic_clips(num_clips=3, frames=60, motion_dim=12, seed=4)
    tclips = tdata.synthetic_clips(num_clips=3, frames=60, motion_dim=12, seed=4)
    for (ja, jmo), (ta, tmo) in zip(jclips, tclips):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tmo, jmo)
    jds = jdata.MotionAudioDataset(jclips, window=4, style_frames=10)
    tds = tdata.MotionAudioDataset(tclips, window=4, style_frames=10)
    for jb, tb in zip(jds.batches(3, seed=2, num_batches=3),
                      tds.batches(3, seed=2, num_batches=3)):
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_prefetch_yields_tensors_and_raises_producer_errors():
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    got = list(tdata.prefetch_to_device(iter(batches), device="cpu"))
    assert [int(b["x"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in got)

    def broken():
        yield batches[0]
        raise RuntimeError("bad clip")

    it = tdata.prefetch_to_device(broken(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="bad clip"):
        next(it)


def test_data_pipeline_end_to_end():
    """Dataset -> prefetch -> AR train step with style clips, 4 batches."""
    window = CFG.vae.window
    clips = tdata.synthetic_clips(num_clips=2, frames=6 * window, motion_dim=12)
    ds = tdata.MotionAudioDataset(clips, window=window, style_frames=10)
    ex = ds.sample_window_pair(np.random.default_rng(0))
    assert ex["prev_motion"].shape == (window, 12)
    assert ex["audio"].shape == (window * 640,)

    model = port_model(CFG)
    optimizer = ttrainer.make_optimizer(lr=1e-3, warmup_steps=1)
    step = ttrainer.make_ar_train_step(model, optimizer)
    state = ttrainer.init_state(model, optimizer)
    losses = []
    for b in tdata.prefetch_to_device(ds.batches(batch_size=4, num_batches=4), device="cpu"):
        state, metrics = step(state, b["audio"], b["prev_motion"], b["this_motion"],
                              b["style_motion"])
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and len(losses) == 4


def test_overfit_one_clip_learns_decode_path(batch):
    """Teacher-forced training on one clip drives bit accuracy to ~1, and
    the free-running KV-cached decode then reproduces the clip's codes: the
    teacher-forced loss and the inference decode are the same model."""
    model = port_model(CFG, seed=3)
    optimizer = ttrainer.make_optimizer(lr=3e-3, weight_decay=0.0, warmup_steps=20,
                                        total_steps=400)
    state = ttrainer.init_state(model, optimizer)
    step = ttrainer.make_ar_train_step(model, optimizer, drop_path=False)
    audio, prev, this = (_t(batch[k][:1]) for k in ("audio", "prev", "this"))
    acc = 0.0
    for i in range(400):
        state, metrics = step(state, audio, prev, this)
        if (i + 1) % 25 == 0:
            acc = float(metrics["bit_accuracy"])
            if acc >= 0.995:
                break
    assert acc >= 0.98, f"failed to overfit one clip: bit_acc={acc}"

    model.requires_grad_(False)
    with torch.no_grad():
        prev_bits, this_bits = model.vae.encode_to_bits(prev, this)
        style_cond = model.null_style_cond
        prefix = model._prefix_from_bits(style_cond, prev_bits, tile=True)
        audio_cond = model.audio_condition(audio)
        decoded = model.decode_window(audio_cond, style_cond, prefix)
        assert decoded.shape == this_bits.shape
        match = float((decoded == this_bits).float().mean())
        assert match >= 0.95, f"free-running decode reproduces only {match:.3f} of codes"
        model.cfg = dataclasses.replace(model.cfg, bf16_ar=True)
        agree = float((model.decode_window(audio_cond, style_cond, prefix)
                       == decoded).float().mean())
    assert agree >= 0.97, f"bf16 decode agreement on trained weights: {agree:.3f}"


def test_eval_decode_readout():
    """--eval: free-running decode of clip 0 + the motion-space readout of a
    non-FLAME config."""
    model = port_model(CFG)
    ds = tdata.MotionAudioDataset(tdata.synthetic_clips(num_clips=1, frames=60, motion_dim=12),
                                  window=CFG.vae.window)
    metrics = ttrain._eval_decode(model, ds, TCFG)
    assert metrics["frames"] == 60
    assert np.isfinite(metrics["motion_l2"])
    assert 0.0 <= metrics["beat_align"] <= 1.0


# ----------------------------------------------------------------- CLI


@pytest.mark.parametrize("stage", ["vae", "ar"])
def test_train_main_writes_params_jax_loads(stage, tmp_path, monkeypatch):
    """``train.main`` on the CPU (the small CFG in place of ModelConfig())
    writes an npz that the JAX package's ``load_params(like=init)`` accepts
    and that holds the trained weights; the AR stage runs --eval."""
    monkeypatch.setattr(ttrain, "ModelConfig", lambda: TCFG)
    out = tmp_path / "trained.npz"
    metrics = ttrain.main(["--stage", stage, "--synthetic", "--steps", "2", "--batch_size", "2",
                           "--out", str(out), "--device", "cpu", "--log_every", "1"]
                          + (["--eval"] if stage == "ar" else []))
    jmodel = JaxARModel(CFG) if stage == "ar" else JaxVAE(CFG.vae)
    like = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    loaded = _flatten(load_params(str(out), like=like))
    assert set(loaded) == set(_flatten(like))
    assert all(np.isfinite(v).all() for v in loaded.values())
    tmodel = BitwiseARModel(TCFG) if stage == "ar" else BitwiseVAE(TCFG.vae)
    init = flat_from_module(tmodel.init(torch.Generator().manual_seed(0)))  # --seed 0
    assert not np.array_equal(loaded["decoder//inp//w" if stage == "vae" else "blocks//q//w"],
                              init["decoder//inp//w" if stage == "vae" else "blocks//q//w"])
    if stage == "ar":
        assert metrics["frames"] == 500 and np.isfinite(metrics["motion_l2"])
        # the frozen VAE is not trained (its decay at lr 1e-7 is below float32's step)
        np.testing.assert_allclose(loaded["vae//decoder//inp//w"], init["vae//decoder//inp//w"],
                                   rtol=1e-6)
