"""ray_tpu_torch's loss, gradients and train step against the JAX package.

``debug`` preset, float32 compute on both sides, the JAX weights carried
over with ``params_from_jax``, tokens from numpy with a seed, CPU. JAX's
flash attention runs its Pallas kernels in interpret mode, the port's its
plain versions. Tolerance 1e-4 of the reference's max |value| per leaf, the
reference's own gradient tolerance (tests/test_long_context.py:57): the
two sides do the same fp32 math in another summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.parallel import train_step as jts
from ray_tpu.util import flops as jflops
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.util import flops as tflops

REL = 1e-4
B, S = 2, 24


def _configs(**over):
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32, **over)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = jllama.init_params(jax.random.key(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_jax(np_params, tcfg, device="cpu",
                               dtype=torch.float32)


def _batch(seed=1, b=B, s=S, mask=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 256, size=(b, s + 1)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return batch


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _flat(tree):
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update({f"{name}/{k}": v for k, v in node.items()})
        else:
            out[name] = node
    return out


def _torch_grads(params, batch, cfg):
    leaves = tts._leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tllama.lm_loss(params, tb, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for t in leaves.values():
        t.requires_grad_(False)
    return float(loss.detach()), dict(zip(leaves, (g.numpy() for g in grads)))


@pytest.mark.parametrize("chunk,mask", [(0, False), (0, True), (8, False),
                                        (8, True)])
def test_lm_loss_matches_jax(chunk, mask):
    jcfg, tcfg = _configs(loss_chunk=chunk)
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(mask=mask)
    ref = float(jllama.lm_loss(jp, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jcfg))
    with torch.no_grad():
        got = float(tllama.lm_loss(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg))
    assert abs(got - ref) / abs(ref) < REL


@pytest.mark.parametrize("attn_impl,chunk", [("xla", 0), ("flash", 0),
                                             ("xla", 8)])
def test_grads_match_jax(attn_impl, chunk):
    """Every leaf's gradient of lm_loss, remat on (both defaults), with a
    loss mask."""
    jcfg, tcfg = _configs(attn_impl=attn_impl, loss_chunk=chunk)
    jp, tp = _params(jcfg, tcfg, seed=2)
    batch = _batch(seed=3, mask=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss, ref = jax.value_and_grad(jllama.lm_loss)(jp, jb, jcfg)
    loss, got = _torch_grads(tp, batch, tcfg)
    assert abs(loss - float(ref_loss)) / abs(float(ref_loss)) < REL
    ref = _flat(ref)
    assert set(got) == set(ref)
    for name in ref:
        assert _rel(got[name], ref[name]) < REL, name


def test_remat_does_not_change_grads():
    _, tcfg = _configs(attn_impl="flash")
    jcfg, _ = _configs()
    _, tp = _params(jcfg, tcfg, seed=4)
    batch = _batch(seed=5)
    loss_on, on = _torch_grads(tp, batch, tcfg)
    loss_off, off = _torch_grads(tp, batch,
                                 dataclasses.replace(tcfg, remat=False))
    assert loss_on == loss_off
    for name in on:
        np.testing.assert_allclose(on[name], off[name], rtol=0, atol=1e-6)


def test_train_steps_match_optax():
    """Three steps of the port's make_train_step against JAX's (no mesh,
    optax's default_optimizer): per-step loss and grad_norm, and every
    param after, the first step's lr of 0 included."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg, seed=6)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=50)
    jopt, topt = jts.default_optimizer(**kw), tts.default_optimizer(**kw)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jstep = jts.make_train_step(jcfg, jopt)
    tstep = tts.make_train_step(tcfg, topt, device="cpu")
    for i in range(3):
        batch = _batch(seed=10 + i, b=4)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in
                                            batch.items()})
        tp, tstate, tm = tstep(tp, tstate, batch)
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) / float(jm[key]) \
                < REL, (i, key)
    assert tstate["count"] == 3
    ref = _flat(jax.tree_util.tree_map(np.asarray, jp))
    got = _flat(params_to_numpy(tp))
    for name in ref:
        assert _rel(got[name], ref[name]) < REL, name


def test_first_step_has_lr_zero():
    jcfg, tcfg = _configs()
    _, tp = _params(jcfg, tcfg, seed=7)
    before = params_to_numpy(tp)
    opt = tts.default_optimizer(lr=1e-2, warmup_steps=3, total_steps=50)
    assert [opt.schedule(c) for c in (0, 3)] == [0.0, 1e-2]
    state = opt.init(tp)
    tts.make_train_step(tcfg, opt, device="cpu")(tp, state, _batch())
    after = params_to_numpy(tp)
    for name, leaf in _flat(before).items():
        np.testing.assert_array_equal(leaf, _flat(after)[name])
    assert float(state["mu"]["embed"].abs().max()) > 0


def test_multi_step_equals_single_steps():
    jcfg, tcfg = _configs()
    _, tp1 = _params(jcfg, tcfg, seed=8)
    _, tp2 = _params(jcfg, tcfg, seed=8)
    opt = tts.default_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)
    s1, s2 = opt.init(tp1), opt.init(tp2)
    batches = [_batch(seed=20 + i) for i in range(3)]
    step = tts.make_train_step(tcfg, opt, device="cpu")
    singles = []
    for b in batches:
        tp1, s1, m = step(tp1, s1, b)
        singles.append(float(m["loss"]))
    stacked = {"tokens": np.stack([b["tokens"] for b in batches])}
    tp2, s2, ms = tts.make_multi_step(tcfg, opt, 3, device="cpu")(
        tp2, s2, stacked)
    assert ms["loss"].shape == (3,) and ms["loss"].tolist() == singles
    for name, leaf in _flat(params_to_numpy(tp1)).items():
        np.testing.assert_array_equal(leaf, _flat(params_to_numpy(tp2))[name])


def test_loss_decreases():
    """The port's twin of test_model_llama.py:100-113: debug preset at its
    default bf16 compute, fp32 masters, 10 steps on one batch."""
    cfg = tllama.PRESETS["debug"]
    opt = tts.default_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)
    params, state = tts.init_state(
        cfg, opt, generator=torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"].dtype == torch.float32
    step = tts.make_train_step(cfg, opt, device="cpu")
    batch = _batch(seed=9, b=4, s=32)
    losses = []
    for _ in range(10):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_train_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = tllama.PRESETS["debug"]
    opt = tts.default_optimizer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.init_state(cfg, opt, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.make_train_step(cfg, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.make_multi_step(cfg, opt, 2)
    params, state = tts.init_state(cfg, opt, generator=torch.Generator(),
                                   device="cpu")
    step = tts.make_train_step(cfg, opt, device="cpu")
    assert step(params, state, _batch())[0] is params


@pytest.mark.parametrize("stacked", [False, True])
def test_batch_tokens_match_jax(stacked):
    tokens = np.zeros((3, 4, 17) if stacked else (4, 17), np.int32)
    for batch in ({"tokens": tokens}, {"x": tokens}, {"x": np.zeros(3)}):
        assert tts._batch_tokens(batch, stacked) == \
            jts._batch_tokens(batch, stacked)


@pytest.mark.parametrize("family,preset", [
    *(("llama", p) for p in jllama.PRESETS),
    *(("moe", p) for p in jmoe.PRESETS)])
def test_train_flops_match_jax(family, preset):
    """Every preset of both families: a MoE config counts its active
    params (8x410m: 3.79 GFLOP a token at seq 2048, not 11.27)."""
    jfam, tfam = {"llama": (jllama, tllama), "moe": (jmoe, tmoe)}[family]
    jcfg, tcfg = jfam.PRESETS[preset], tfam.PRESETS[preset]
    assert tcfg.num_params() == jcfg.num_params()
    assert tflops.train_flops_per_token(tcfg, 2048) == \
        jflops.train_flops_per_token(jcfg, 2048)
    assert tflops.train_step_flops(tcfg, 4, 2048) == \
        jflops.train_step_flops(jcfg, 4, 2048)
    if preset == "8x410m":
        assert round(tflops.train_flops_per_token(tcfg, 2048) / 1e9, 2) \
            == 3.79
    step_flops = tflops.train_step_flops(tcfg, 4, 2048)
    assert tflops.mfu(step_flops, 1.0) == step_flops / 989e12
    assert tflops.mfu(step_flops, 0.0) == 0.0


def test_params_to_numpy_inverts_params_from_jax():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg, seed=11)
    ref = _flat(jax.tree_util.tree_map(np.asarray, jp))
    got = _flat(params_to_numpy(tp))
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], ref[name])
