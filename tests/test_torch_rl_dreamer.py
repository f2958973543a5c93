"""ray_tpu_torch's DreamerV3 against the JAX package's, in one process:
the RSSM helpers, the straight-through latent draw, the world-model loss,
a whole three-optimizer update against JAX's jitted ``train_step``,
collection, replay and an iteration.

Conventions in ``tests/_torch_rl_offpolicy.py``. Every categorical draw
is JAX's: the port draws through ``models.gumbel``, which these tests
replace with a replay of JAX's keys in the port's draw order
(``JaxDraws``): an update splits its key into a world-model key (split
into T step keys, one posterior latent each) and an actor key (split into
H step keys, each split into an action key and a prior latent key); a
collection step splits its key into a posterior key and an action key.
Debug widths: deter 16, 2x4 stochastic, embed 16, T 4, H 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rl_offpolicy import (ATOL, REL, JaxDraws, assert_metrics_close,
                                 assert_tree_close, carry, closure, np_tree,
                                 one_thread,  # noqa: F401
                                 rel, tree_equal)
from ray_tpu import rl as jrl
from ray_tpu.rl.algorithms import dreamer as jdreamer
from ray_tpu_torch import rl as trl
from ray_tpu_torch.parallel.train_step import _leaves, value_and_grad
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl.algorithms import dreamer as tdreamer
from ray_tpu_torch.rl.env import EnvSpec

pytestmark = pytest.mark.usefixtures("one_thread")

KW = {"num_envs_per_runner": 2, "rollout_fragment_length": 4,
      "deter_dim": 16, "stoch_groups": 2, "stoch_classes": 4,
      "embed_dim": 16, "hidden": (16,), "imag_horizon": 3, "batch_seqs": 2,
      "learning_starts": 24, "updates_per_iter": 2, "seed": 1}
T, H = KW["rollout_fragment_length"], KW["imag_horizon"]


def _cfg(pkg, **kw):
    return pkg.DreamerV3Config().training(**{**KW, **kw})


def _pair():
    jalgo = _cfg(jrl).build()
    talgo = _cfg(trl).build(device="cpu")
    talgo.wm = carry(jalgo.wm, talgo.wm)
    talgo.actor = carry(jalgo.actor, talgo.actor)
    talgo.critic = carry(jalgo.critic, talgo.critic)
    return jalgo, talgo


def _batch(seed=0, B=2, obs_dim=4, A=2):
    rng = np.random.default_rng(seed)
    is_first = (rng.random((B, T)) < 0.2).astype(np.float32)
    is_first[:, 0] = 1.0
    return {"obs": rng.normal(size=(B, T, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, A, (B, T)),
            "rewards": rng.normal(size=(B, T)).astype(np.float32),
            "conts": (rng.random((B, T)) > 0.1).astype(np.float32),
            "is_first": is_first}


def _update_keys(key):
    """The port's draw order of one update from JAX's ``key``."""
    k1, k2 = jax.random.split(key)
    out = list(jax.random.split(k1, T))
    for k in jax.random.split(k2, H):
        out += list(jax.random.split(k))
    return out


def _collect_keys(key, steps):
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out += list(jax.random.split(sub))
    return key, out


def _to_torch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def test_gru_unimix_kl_match_jax():
    rng = np.random.default_rng(0)
    p = {"wi": rng.normal(size=(6, 15)).astype(np.float32),
         "wh": rng.normal(size=(5, 15)).astype(np.float32) * 0.4,
         "b": rng.normal(size=15).astype(np.float32)}
    h = rng.normal(size=(3, 5)).astype(np.float32)
    x = rng.normal(size=(3, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tdreamer._gru(_to_torch(p), torch.tensor(h), torch.tensor(x)),
        np.asarray(jdreamer._gru(p, h, x)), rtol=0, atol=ATOL)
    la = rng.normal(scale=3, size=(3, 2, 4)).astype(np.float32)
    lb = rng.normal(scale=3, size=(3, 2, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tdreamer._unimix(torch.tensor(la), 4),
        np.asarray(jdreamer._unimix(la, 4)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        tdreamer._kl_cat(torch.tensor(la), torch.tensor(lb)),
        np.asarray(jdreamer._kl_cat(la, lb)), rtol=0, atol=ATOL)


def test_st_sample_value_and_straight_through_gradient(monkeypatch):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(5, 2, 4)).astype(np.float32)
    w = rng.normal(size=(5, 2, 4)).astype(np.float32)
    key = jax.random.key(3)
    want, jg = jax.value_and_grad(
        lambda l: jnp.sum(w * jdreamer._st_sample(key, l)))(logits)
    draws = JaxDraws.of_keys([key, key])
    draws.install(monkeypatch, tmodels, gumbel=True)
    onehot = tdreamer._st_sample(torch.Generator(), torch.tensor(logits))
    np.testing.assert_allclose(
        onehot.numpy(), np.asarray(jdreamer._st_sample(key, logits)),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(onehot.sum(-1), np.ones((5, 2)), atol=1e-6)
    got, tg = value_and_grad(
        lambda p: torch.sum(torch.tensor(w) * tdreamer._st_sample(
            torch.Generator(), p["l"])), {"l": torch.tensor(logits)})
    assert abs(float(got) - float(want)) < ATOL
    assert rel(tg["l"], np.asarray(jg)) < REL


def test_wm_loss_matches_jax(monkeypatch):
    jalgo, talgo = _pair()
    batch = _batch()
    key = jax.random.key(5)
    jwm_loss = closure(jalgo._train_step, "wm_loss")
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda w: jwm_loss(w, {k: jnp.asarray(v) for k, v in batch.items()},
                           key), has_aux=True))(jalgo.wm)
    draws = JaxDraws.of_keys(jax.random.split(key, T))
    draws.install(monkeypatch, tmodels, gumbel=True)
    (tl, taux), tg = value_and_grad(
        lambda w: talgo._fns.wm_loss(w, _to_torch(batch), torch.Generator()),
        talgo.wm,
        has_aux=True)
    assert draws.calls == T
    assert abs(float(tl) - float(jl)) < ATOL * max(1.0, abs(float(jl)))
    for k in ("recon_loss", "rew_loss", "cont_loss", "kl_dyn"):
        assert abs(float(taux[k]) - float(jaux[k])) < ATOL, k
    for got, want in zip(taux["states"], jaux["states"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    want = {k: np.asarray(v) for k, v in _leaves(np_tree(jg)).items()}
    assert tg.keys() == want.keys()
    for k in want:
        assert rel(tg[k], want[k]) < REL, (k, rel(tg[k], want[k]))


@pytest.mark.parametrize("ret_scale", [1.0, 2.5])
def test_train_step_matches_jax(monkeypatch, ret_scale):
    """A whole update — the world model first, the actor on the updated
    world model from the pre-update states, the critic on the same
    rollout — against JAX's jitted ``train_step``: every metric, and the
    three trees after their clipped Adam steps."""
    jalgo, talgo = _pair()
    batch = _batch(2)
    key = jax.random.key(7)
    jstates = (jalgo._wm_state, jalgo._a_state, jalgo._c_state)
    jwm, jactor, jcritic, _, jm = jalgo._train_step(
        jalgo.wm, jalgo.actor, jalgo.critic, jstates,
        {k: jnp.asarray(v) for k, v in batch.items()}, key, ret_scale)
    draws = JaxDraws.of_keys(_update_keys(key))
    draws.install(monkeypatch, tmodels, gumbel=True)
    twm, tactor, tcritic, _, tm = talgo._fns.train_step(
        talgo.wm, talgo.actor, talgo.critic,
        (talgo._wm_state, talgo._a_state, talgo._c_state),
        _to_torch(batch), torch.Generator(), ret_scale)
    assert not draws.pending
    assert tm.keys() == jm.keys()
    for k, v in jm.items():
        v = float(v)
        assert abs(float(tm[k]) - v) < ATOL * max(1.0, abs(v)), (k, tm[k], v)
    assert_tree_close(twm, jwm)
    assert_tree_close(tactor, jactor)
    assert_tree_close(tcritic, jcritic)


def test_collect_sample_batch_and_iteration_match_jax(monkeypatch):
    """Two collecting iterations (posterior filter, action draws, chunks,
    is_first), the replayed batch (first step forced to is_first), then an
    iteration with two updates; ret_scale's EMA as JAX's. The world model
    and the actor are held per leaf; the critic against its largest value
    (``critic_close``)."""
    jalgo, talgo = _pair()
    key = jax.random.key(KW["seed"] + 99)
    keys = []
    for it in range(3):
        key, ks = _collect_keys(key, T)
        keys += ks
    for _ in range(KW["updates_per_iter"]):
        key, sub = jax.random.split(key)
        keys += _update_keys(sub)
    draws = JaxDraws.of_keys(keys)
    draws.install(monkeypatch, tmodels, gumbel=True)
    for it in range(3):
        jm, tm = jalgo.train(), talgo.train()
        assert_metrics_close(tm, jm)
        if it == 1:
            assert len(talgo._chunks) == len(jalgo._chunks) == 2
            for tc, jc in zip(talgo._chunks, jalgo._chunks):
                for k in jc:
                    np.testing.assert_allclose(tc[k], jc[k], rtol=0,
                                               atol=ATOL, err_msg=k)
            state = talgo._rng.bit_generator.state
            jb, tb = jalgo._sample_batch(), talgo._sample_batch()
            talgo._rng.bit_generator.state = state
            jalgo._rng.bit_generator.state = state
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
            assert (tb["is_first"][:, 0] == 1).all()
    assert not draws.pending
    assert "wm_loss" in tm and tm["ret_scale"] == pytest.approx(
        jm["ret_scale"], abs=1e-7)
    assert_tree_close(talgo.wm, jalgo.wm)
    assert_tree_close(talgo.actor, jalgo.actor)
    critic_close(talgo.critic, jalgo.critic)


def critic_close(got, want):
    """The critic within REL of its largest |value|. Its biases start at
    zero and its gradients on CartPole's returns are small: Adam maps a
    gradient element g to about lr * g / (|g| + 1e-8), so where |g| is
    near 1e-8 a float32 rounding difference of 1e-11 in g moves a bias by
    1e-7, which is 1e-3 of that bias leaf's max |value| after two steps of
    lr 1e-4 (measured: 4.4e-8 absolute on one element of layer 0's bias,
    every other leaf of the three trees within 1e-5 per leaf)."""
    scale = max(float(np.abs(v).max())
                for v in _leaves(np_tree(want)).values())
    for k, v in _leaves(np_tree(want)).items():
        err = float(np.abs(_leaves(got)[k].numpy() - np.asarray(v)).max())
        assert err < REL * scale, (k, err, scale)


def test_rejects_continuous_and_pixel_specs():
    for pkg, kw in ((jrl, {}), (trl, {"device": "cpu"})):
        with pytest.raises(ValueError, match="discrete"):
            _cfg(pkg, env="Pendulum-v1").build(**kw)

    class Pixels:
        spec = EnvSpec(obs_shape=(8, 8, 1), num_actions=2)

    trl.register_env("PixelToy-v0", lambda cfg: Pixels())
    with pytest.raises(ValueError, match="vector observations"):
        _cfg(trl, env="PixelToy-v0").build(device="cpu")


def test_checkpoint_roundtrip_and_evaluate(tmp_path):
    algo = _cfg(trl).build(device="cpu")
    for _ in range(3):
        algo.train()
    algo.save(str(tmp_path))
    fresh = _cfg(trl).build(device="cpu")
    fresh.restore(str(tmp_path))
    assert tree_equal(fresh.get_params(), algo.get_params())
    assert fresh._ret_scale == algo._ret_scale != 1.0
    ev = fresh.evaluate(num_episodes=2)
    assert ev["episodes"] >= 2 and np.isfinite(ev["episode_return_mean"])
