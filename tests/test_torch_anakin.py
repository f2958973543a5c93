"""ray_tpu_torch's device env, policy MLP, PPO loss, constant Adam and
fused Anakin iteration against the JAX package's.

CPU, float32 on both sides, JAX's params carried over through numpy.
Values within 1e-5 absolute, gradients and params within 1e-4 of the
reference's max |value| per leaf (tests/test_long_context.py:34 and :57).
jax.random cannot be reproduced in torch, so the comparisons that run the
env start both sides from the same numpy state (``from_host_state``),
compare transitions only up to each env's first ``done`` (after it the
reset noise differs), and patch ``categorical_sample`` to the argmax in
both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rl import anakin as janakin
from ray_tpu.rl import models as jmodels
from ray_tpu.rl.algorithms.ppo import make_ppo_loss as jmake_ppo_loss
from ray_tpu.rl.env import EnvSpec as JEnvSpec
from ray_tpu.rl.jax_env import JaxCartPole
from ray_tpu_torch.models.convert import (params_to_numpy,
                                          policy_params_from_jax)
from ray_tpu_torch.parallel.train_step import Adam, _leaves, value_and_grad
from ray_tpu_torch.rl import anakin as tanakin
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl.algorithms.ppo import make_ppo_loss as tmake_ppo_loss
from ray_tpu_torch.rl.device_env import TorchCartPole, make_device_env
from ray_tpu_torch.rl.env import EnvSpec

ATOL, REL = 1e-5, 1e-4
HIDDEN = (16, 16)
SPEC = JaxCartPole.spec


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _assert_tree_close(got: dict, want, rel=REL):
    """got: name -> array; want: a JAX tree with the same leaf paths."""
    want = {k: np.asarray(v) for k, v in _leaves(_np(want)).items()}
    assert got.keys() == want.keys()
    for name in want:
        assert _rel(got[name], want[name]) < rel, name


def _policy(seed=0, hidden=HIDDEN):
    jp = jmodels.init_policy(jax.random.key(seed), SPEC, hidden=hidden)
    return jp, policy_params_from_jax(_np(jp), SPEC, hidden, device="cpu")


def test_cartpole_step_matches_jax():
    b, steps = 16, 60
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.15, 0.15, (b, 4)).astype(np.float32)
    t0 = rng.integers(0, 3, b).astype(np.int32)
    t0[0] = 497    # reaches the 500-step limit on step 3
    acts = rng.integers(0, 2, (steps, b))
    js = JaxCartPole.from_host_state(x0, jax.random.key(1), t=t0)
    ts = TorchCartPole.from_host_state(x0, torch.Generator().manual_seed(1),
                                       t=t0, device="cpu")
    jstep = jax.jit(JaxCartPole.step_batch)
    live = np.ones(b, bool)      # no done seen yet
    for i in range(steps):
        js, jobs, jrew, jdone = jstep(js, jnp.asarray(acts[i], jnp.int32))
        ts, tobs, trew, tdone = TorchCartPole.step_batch(
            ts, torch.from_numpy(acts[i]))
        jdone, tdone = np.asarray(jdone), tdone.numpy()
        np.testing.assert_array_equal(tdone[live], jdone[live])
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        ok = live & ~jdone
        np.testing.assert_allclose(tobs.numpy()[ok], np.asarray(jobs)[ok],
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(ts.t.numpy()[live],
                                      np.asarray(js.t)[live])
        # a done env is reset in place: fresh state in range, t at 0
        assert (np.abs(tobs.numpy()[tdone]) <= 0.05).all()
        live &= ~jdone
    assert live.sum() < b - 2      # some envs ended, the t limit among them
    assert not live[0]
    assert make_device_env("CartPole-v1") is TorchCartPole
    with pytest.raises(KeyError):
        make_device_env("Pong")


def test_reset_batch_draws_in_range():
    state, obs = TorchCartPole.reset_batch(torch.Generator().manual_seed(3),
                                           32)
    assert obs.shape == (32, 4) and obs.dtype == torch.float32
    assert (obs.abs() <= 0.05).all() and (state.t == 0).all()
    again, _ = TorchCartPole.reset_batch(torch.Generator().manual_seed(3),
                                         32)
    assert torch.equal(again.x, state.x)


def test_mlp_logits_and_value_match_jax():
    jp, tp = _policy()
    obs = np.random.default_rng(2).standard_normal((10, 4)).astype(
        np.float32)
    for jf, tf in ((jmodels.policy_logits, tmodels.policy_logits),
                   (jmodels.value, tmodels.value)):
        want = np.asarray(jf(jp, jnp.asarray(obs)))
        got = tf(tp, torch.from_numpy(obs)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    logits = jmodels.policy_logits(jp, jnp.asarray(obs))
    acts = np.random.default_rng(3).integers(0, 2, 10)
    np.testing.assert_allclose(
        tmodels.categorical_logp(torch.from_numpy(np.array(logits)),
                                 torch.from_numpy(acts)).numpy(),
        np.asarray(jmodels.categorical_logp(logits, jnp.asarray(acts))),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tmodels.categorical_entropy(
            torch.from_numpy(np.array(logits))).numpy(),
        np.asarray(jmodels.categorical_entropy(logits)), atol=ATOL, rtol=0)
    # the port's own init: JAX's tree, shapes and count
    own = tmodels.init_policy(torch.Generator().manual_seed(0), SPEC,
                              hidden=HIDDEN)
    assert {k: tuple(v.shape) for k, v in _leaves(own).items()} == \
        {k: tuple(v.shape) for k, v in _leaves(_np(jp)).items()}
    assert sum(t.numel() for t in _leaves(own).values()) == \
        jmodels.num_params(jp)
    w = own["pi"]["layers"][1]["w"]          # orthogonal, gain sqrt(2)
    torch.testing.assert_close(w.T @ w, 2.0 * torch.eye(16), atol=1e-5,
                               rtol=0)
    # a continuous spec, once refused, now gets JAX's tree (log_std too)
    cont = tmodels.init_policy(torch.Generator(), EnvSpec(obs_dim=3,
                                                          action_dim=1),
                               hidden=HIDDEN)
    jcont = jmodels.init_policy(jax.random.key(0),
                                JEnvSpec(obs_dim=3, action_dim=1),
                                hidden=HIDDEN)
    assert {k: tuple(v.shape) for k, v in _leaves(cont).items()} == \
        {k: tuple(v.shape) for k, v in _leaves(_np(jcont)).items()}


def test_categorical_sample_draws_from_the_softmax():
    logits = torch.log(torch.tensor([[0.2, 0.8]])).expand(20000, 2)
    draws = tmodels.categorical_sample(torch.Generator().manual_seed(0),
                                       logits)
    assert draws.shape == (20000,)
    assert abs(draws.float().mean().item() - 0.8) < 0.015


def _ppo_batch(n=24, seed=4):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "logp": (rng.standard_normal(n) * 0.1 - 0.7).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": rng.standard_normal(n).astype(np.float32)}


def test_ppo_loss_and_grads_match_jax():
    jp, tp = _policy()
    batch = _ppo_batch()
    jloss = jmake_ppo_loss(SPEC, 0.2, 0.5, 0.01)
    tloss = tmake_ppo_loss(SPEC, 0.2, 0.5, 0.01)
    (jv, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    (tv, taux), tg = value_and_grad(
        lambda p: tloss(p, {k: torch.from_numpy(v) for k, v in
                            batch.items()}, None), tp, has_aux=True)
    assert float(tv) == pytest.approx(float(jv), abs=ATOL)
    assert taux.keys() == jaux.keys()
    for k in jaux:
        assert float(taux[k]) == pytest.approx(float(jaux[k]), abs=ATOL), k
    _assert_tree_close({k: g.numpy() for k, g in tg.items()}, jg)
    # continuous actions, once refused, now take the Gaussian branch
    cspec = EnvSpec(obs_dim=4, action_dim=1)
    jc = jmodels.init_policy(jax.random.key(1),
                             JEnvSpec(obs_dim=4, action_dim=1), hidden=HIDDEN)
    tc = policy_params_from_jax(_np(jc), cspec, HIDDEN, device="cpu")
    cbatch = dict(batch, actions=np.random.default_rng(5).standard_normal(
        (len(batch["obs"]), 1)).astype(np.float32))
    jv, _ = jmake_ppo_loss(JEnvSpec(obs_dim=4, action_dim=1), 0.2, 0.5,
                           0.01)(jc, {k: jnp.asarray(v)
                                      for k, v in cbatch.items()}, None)
    tv, _ = tmake_ppo_loss(cspec, 0.2, 0.5, 0.01)(
        tc, {k: torch.from_numpy(v) for k, v in cbatch.items()}, None)
    assert float(tv) == pytest.approx(float(jv), abs=ATOL)


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_constant_adam_matches_optax(grad_clip):
    jp, tp = _policy(seed=5)
    opt = optax.adam(1e-2) if grad_clip is None else optax.chain(
        optax.clip_by_global_norm(grad_clip), optax.adam(1e-2))
    jstate = opt.init(jp)
    tadam = Adam(1e-2, grad_clip=grad_clip)
    tstate = tadam.init(tp)
    rng = np.random.default_rng(6)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape)
                                  .astype(np.float32)), jp)
        tgrads = {k: torch.from_numpy(np.array(v)) for k, v in
                  _leaves(_np(grads)).items()}
        upd, jstate = opt.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = tadam.update(tp, tgrads, tstate)
        assert float(norm) == pytest.approx(float(optax.global_norm(grads)),
                                            rel=1e-6)
        _assert_tree_close({k: v.numpy() for k, v in _leaves(tp).items()},
                           jp)
    assert tstate["count"] == 3


def _carries(cfg, x0):
    jp, tp = _policy(seed=cfg.seed, hidden=cfg.hidden)
    jopt = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                       optax.adam(cfg.lr))
    jcarry = (jp, jopt.init(jp),
              JaxCartPole.from_host_state(x0, jax.random.key(7)),
              jnp.asarray(x0), jax.random.key(8))
    ts = TorchCartPole.from_host_state(x0, torch.Generator().manual_seed(7),
                                       device="cpu")
    tcarry = (tp, Adam(cfg.lr, grad_clip=cfg.grad_clip).init(tp), ts, ts.x,
              torch.Generator().manual_seed(8))
    return jcarry, tcarry


def test_fused_iterations_match_jax(monkeypatch):
    monkeypatch.setattr(jmodels, "categorical_sample",
                        lambda key, logits: jnp.argmax(logits, -1))
    monkeypatch.setattr(tmodels, "categorical_sample",
                        lambda gen, logits: torch.argmax(logits, -1))
    cfg = janakin.AnakinConfig(num_envs=8, rollout_len=4, hidden=HIDDEN,
                               lr=1e-2)
    tcfg = tanakin.AnakinConfig(**dataclasses.asdict(cfg))
    x0 = np.random.default_rng(9).uniform(-0.01, 0.01, (8, 4)).astype(
        np.float32)
    jcarry, tcarry = _carries(cfg, x0)
    jstep = jax.jit(janakin.make_anakin_step(cfg))
    tstep = tanakin.make_anakin_step(tcfg)
    for _ in range(2):
        jcarry, jm = jstep(jcarry)
        tcarry, tm = tstep(tcarry)
        assert float(jm["episodes_done"]) == float(tm["episodes_done"]) == 0
        assert tm.keys() == jm.keys()
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), abs=ATOL), k
        _assert_tree_close({k: v.numpy() for k, v in
                            _leaves(tcarry[0]).items()}, jcarry[0])
        np.testing.assert_allclose(tcarry[3].numpy(),
                                   np.asarray(jcarry[3]), atol=ATOL, rtol=0)
    assert tcarry[1]["count"] == 2 * cfg.num_epochs


def test_runner_compiles_once_and_trains():
    runner = tanakin.AnakinRunner(num_envs=8, rollout_len=6, hidden=HIDDEN,
                                  device="cpu")
    first = params_to_numpy(runner.params)
    out = runner.train(3)
    assert runner.compile_count() == 1
    out = runner.train(2)
    assert runner.compile_count() == 1
    assert out["iterations"] == 5 and out["env_steps_total"] == 5 * 48
    assert all(np.isfinite(v) for v in out.values())
    assert out["reward_mean_per_step"] == 1.0
    runner.block()
    after = params_to_numpy(runner.params)
    assert any(not np.array_equal(a, b) for a, b in
               zip(_leaves(after).values(), _leaves(first).values()))
    assert tanakin.AnakinConfig().env_steps_per_iter == 64 * 32
