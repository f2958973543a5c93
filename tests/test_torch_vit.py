"""ray_tpu_torch's ViT against the JAX package's (ray_tpu/models/vit.py).

``debug`` preset, float32 compute on both sides, JAX's params carried
over through numpy, images from numpy with a seed, CPU. Values within
1e-5 absolute, gradients within 1e-4 of the reference's max |value| per
leaf (tests/test_long_context.py:34 and :57). The shape and param-count
checks are tests/test_model_vit.py's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu.util import flops as jflops
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import vit_params_from_jax
from ray_tpu_torch.parallel.train_step import Adam, _leaves, value_and_grad
from ray_tpu_torch.util import flops as tflops

ATOL, REL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(remat=True):
    jcfg = dataclasses.replace(jvit.PRESETS["debug"],
                               compute_dtype=jnp.float32, remat=remat)
    tcfg = dataclasses.replace(tvit.PRESETS["debug"],
                               compute_dtype=torch.float32, remat=remat)
    return jcfg, tcfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _toy_batch(n=16, seed=0):
    """tests/test_model_vit.py's 2-class toy: the class is which half of
    the image is brighter."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (n, 32, 32, 3)).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.int32)
    imgs[labels == 1, :16] += 1.0
    imgs[labels == 0, 16:] += 1.0
    return {"images": imgs, "labels": labels}


def test_forward_shapes_and_param_count():
    cfg = tvit.PRESETS["debug"]
    params = tvit.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    imgs = torch.zeros((2, 32, 32, 3))
    assert tvit.patchify(imgs, cfg).shape == (2, 16, 8 * 8 * 3)
    logits = tvit.forward(params, imgs, cfg)
    assert logits.shape == (2, 10) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    actual = sum(t.numel() for t in _leaves(params).values())
    assert actual == cfg.num_params() == jvit.PRESETS["debug"].num_params()
    jp = jvit.init_params(jax.random.key(0), jvit.PRESETS["debug"])
    assert {k: tuple(v.shape) for k, v in _leaves(params).items()} == \
        {k: tuple(np.shape(v)) for k, v in _leaves(_np(jp)).items()}
    for name in ("s16", "b16"):
        assert tvit.PRESETS[name].num_params() == \
            jvit.PRESETS[name].num_params()


def test_patchify_matches_jax_and_roundtrips_content():
    cfg = tvit.PRESETS["debug"]
    imgs = np.arange(2 * 32 * 32 * 3, dtype=np.float32).reshape(2, 32, 32, 3)
    p = tvit.patchify(torch.from_numpy(imgs), cfg).numpy()
    np.testing.assert_array_equal(
        p, np.asarray(jvit.patchify(jnp.asarray(imgs),
                                    jvit.PRESETS["debug"])))
    # patch (0, 1) = rows 0..7, cols 8..15
    np.testing.assert_array_equal(p[0, 1], imgs[0, 0:8, 8:16].reshape(-1))


def test_forward_matches_jax():
    jcfg, tcfg = _configs()
    jp = jvit.init_params(jax.random.key(1), jcfg)
    tp = vit_params_from_jax(_np(jp), tcfg, device="cpu")
    batch = _toy_batch()
    want = np.asarray(jvit.forward(jp, jnp.asarray(batch["images"]), jcfg))
    got = tvit.forward(tp, torch.from_numpy(batch["images"]), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("remat", [True, False])
def test_cls_loss_and_grads_match_jax(remat):
    jcfg, tcfg = _configs(remat)
    jp = jvit.init_params(jax.random.key(2), jcfg)
    tp = vit_params_from_jax(_np(jp), tcfg, device="cpu")
    batch = _toy_batch(seed=3)
    jl, jg = jax.value_and_grad(jvit.cls_loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tl, tg = value_and_grad(
        lambda p: tvit.cls_loss(p, {k: torch.from_numpy(v) for k, v in
                                    batch.items()}, tcfg), tp)
    assert float(tl) == pytest.approx(float(jl), abs=ATOL)
    want = {k: np.asarray(v) for k, v in _leaves(_np(jg)).items()}
    assert tg.keys() == want.keys()
    for name, g in tg.items():
        g, w = g.numpy().astype(np.float64), want[name]
        assert np.abs(g - w).max() <= REL * (np.abs(w).max() + 1e-12), name


def test_vit_learns_toy_classification():
    """A few constant-Adam steps on the toy (tests/test_model_vit.py's
    task, shortened): the loss falls."""
    cfg = tvit.PRESETS["debug"]
    params = tvit.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    opt = Adam(1e-3)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v) for k, v in _toy_batch(64).items()}
    losses = []
    for _ in range(15):
        loss, grads = value_and_grad(lambda p: tvit.cls_loss(p, batch, cfg),
                                     params)
        opt.update(params, grads, state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses


def test_vit_step_flops_match_jax():
    for name, cfg in tvit.PRESETS.items():
        assert tflops.vit_step_flops(cfg, 64) == \
            jflops.vit_step_flops(jvit.PRESETS[name], 64)
