"""ray_tpu_torch's continuous-control RL (SAC, DDPG, TD3, Ape-X DDPG)
against the JAX package's, in one process.

Conventions in ``tests/_torch_rl_offpolicy.py``. The noise inside SAC's
and TD3's losses is JAX's: the port draws it through ``models.normal``,
which these tests replace with a replay of JAX's key chain
(``JaxDraws``). Exploration is made deterministic on both sides: DDPG's
and TD3's Gaussian runner samples are patched to their mean in both
packages, and SAC's squashed runner runs with ``log_std`` -20 (std 2e-9,
so the two packages' different draws move an action by under 1e-8).
Pendulum's env columns are then held within 1e-5 absolute. JAX's
``training_step`` runs as written, its sampling over the plain class of
its runner actor; Ape-X DDPG's round robin is driven by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rl_offpolicy import (ATOL, JaxDraws, JEnvRunner,
                                 assert_loss_parity, assert_tree_close,
                                 carry, drive_jax_sampling, jax_algo,
                                 shares_storage)
from ray_tpu.rl import models as jmodels
from ray_tpu.rl.algorithms.apex import ApexDDPG as JApexDDPG
from ray_tpu.rl.algorithms.ddpg import DDPG as JDDPG
from ray_tpu.rl.algorithms.ddpg import TD3 as JTD3
from ray_tpu.rl.algorithms.sac import SAC as JSAC
from ray_tpu.rl.algorithms.sac import _squashed_sample_logp as jsquashed
from ray_tpu.rl.config import AlgorithmConfig as JAlgorithmConfig
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl.algorithms import ddpg as tddpg
from ray_tpu_torch.rl.algorithms import sac as tsac
from ray_tpu_torch.rl.env import EnvSpec

HIDDEN = (16, 16)
PENDULUM = EnvSpec(obs_dim=3, action_dim=1, action_low=-2.0,
                   action_high=2.0)
LOSSES = {"SAC": (JSAC, tsac.make_sac_loss, 2),
          "DDPG": (JDDPG, lambda s, c: tddpg.make_ddpg_loss(s, c, False), 0),
          "TD3": (JTD3, lambda s, c: tddpg.make_ddpg_loss(s, c, True), 0)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def mean_actions(monkeypatch):
    """Gaussian runner samples are their mean in both packages."""
    monkeypatch.setattr(jmodels, "gaussian_sample",
                        lambda key, mean, log_std: mean)
    monkeypatch.setattr(tmodels, "gaussian_sample",
                        lambda gen, mean, log_std: mean)


def _transitions(n, seed=0, adim=1):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 3)).astype(np.float32),
            "actions": rng.uniform(-2, 2, (n, adim)).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
            "dones": rng.random(n) < 0.2}


def _config(cls, **kw):
    """``cls()`` (its own defaults first), then the test's fields."""
    return cls().training(**{"hidden": HIDDEN, "seed": 1, **kw})


def test_squashed_sample_logp_on_given_eps(monkeypatch):
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(5, 2)).astype(np.float32)
    log_std = rng.normal(scale=2.0, size=(5, 2)).astype(np.float32)
    key = jax.random.key(7)
    want_a, want_lp = jsquashed(mean, log_std, key, -2.0, 2.0)
    draws = JaxDraws.of_key(key, 0)
    draws.install(monkeypatch, tmodels)
    got_a, got_lp = tsac._squashed_sample_logp(
        torch.tensor(mean), torch.tensor(log_std), torch.Generator(), -2.0,
        2.0)
    assert draws.calls == 1
    np.testing.assert_allclose(got_a.numpy(), want_a, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,do_actor", [("SAC", None), ("DDPG", 0.0),
                                           ("DDPG", 1.0), ("TD3", 0.0),
                                           ("TD3", 1.0)])
def test_losses_match_jax_with_its_draws(monkeypatch, name, do_actor):
    """JAX's params (its own init), one batch; TD3's smoothing noise and
    SAC's two squashed samples are JAX's draws from the loss's key."""
    jcls, make_loss, n_keys = LOSSES[name]
    jcfg = _config(JAlgorithmConfig, gamma=0.95)
    if name == "DDPG":
        jcfg.policy_delay, jcfg.target_noise = 1, 0.0
    jalgo = jax_algo(jcls, jcfg, PENDULUM)
    jparams = jalgo.learner.params
    # targets away from the online nets, so the gradients see them
    for k in [k for k in jparams if k.endswith("_target")]:
        jparams[k] = jax.tree_util.tree_map(lambda x: x * 0.9, jparams[k])
    batch = _transitions(24)
    if do_actor is not None:
        batch["do_actor"] = np.full(1, do_actor, np.float32)
        batch["weights"] = np.random.default_rng(3).uniform(
            0.2, 1.0, 24).astype(np.float32)
    key = jax.random.key(11)
    draws = JaxDraws.of_key(key, n_keys)
    draws.install(monkeypatch, tmodels)
    tcfg = _config(trl.AlgorithmConfig, gamma=0.95, policy_delay=jcfg
                   .policy_delay, target_noise=jcfg.target_noise)
    gen = torch.Generator()
    like = trl.SACConfig if name == "SAC" else (
        trl.TD3Config if name == "TD3" else trl.DDPGConfig)
    talgo = _config(like, learning_starts=10**9).build(device="cpu")
    assert_loss_parity(make_loss(talgo.spec, tcfg), carry(jparams, talgo),
                       jalgo.learner._loss_fn, jparams, batch, key, gen)
    assert draws.calls == {"SAC": 2, "DDPG": 0, "TD3": 1}[name]


@pytest.mark.parametrize("name", ["SAC", "TD3"])
def test_polyak_matches_jax_and_never_aliases(name):
    jcls = {"SAC": JSAC, "TD3": JTD3}[name]
    jalgo = jax_algo(jcls, _config(JAlgorithmConfig, tau=0.3), PENDULUM)
    jp = dict(jalgo.learner.params)
    for k in ("q1", "q2") + (("pi",) if name == "TD3" else ()):
        jp[k] = jax.tree_util.tree_map(lambda x: x + 0.5, jp[k])
    like = {"SAC": trl.SACConfig, "TD3": trl.TD3Config}[name]
    talgo = _config(like).build(device="cpu")
    tp = carry(jp, talgo)
    names = ("q1", "q2") + (("pi",) if name == "TD3" else ())
    got = tddpg.polyak(tp, names, 0.3)
    assert_tree_close(got, jalgo._polyak(jp), tol=1e-6)
    for n in names:
        assert shares_storage(got[n], got[f"{n}_target"]) == []
        assert got[n] is tp[n]


def _sac_deterministic(algo, jalgo):
    """SAC's runners with log_std -20 in both packages."""
    torig, jorig = algo._runner_params, jalgo._runner_params
    algo._runner_params = lambda: dict(
        torig(), log_std=torch.full((1,), -20.0))
    jalgo._runner_params = lambda: dict(jorig(),
                                        log_std=jnp.full((1,), -20.0))


@pytest.mark.parametrize("name", ["SAC", "DDPG", "TD3"])
def test_two_iterations_match_jax(monkeypatch, mean_actions, name):
    """Two iterations of 4 envs x 16 steps, learning from the first (two
    updates of 32 each); TD3 runs its delayed actor and smoothing noise,
    SAC its autotuned alpha."""
    kw = dict(num_env_runners=1, num_envs_per_runner=4,
              rollout_fragment_length=16, learning_starts=64,
              minibatch_size=32, lr=1e-3, seed=2)
    tcls, jcls, n_keys = {"SAC": (trl.SACConfig, JSAC, 2),
                          "DDPG": (trl.DDPGConfig, JDDPG, 0),
                          "TD3": (trl.TD3Config, JTD3, 0)}[name]
    algo = _config(tcls, **kw).build(device="cpu")
    jcfg = _config(JAlgorithmConfig, **kw)
    if name == "DDPG":
        jcfg.policy_delay, jcfg.target_noise = 1, 0.0
    jalgo = jax_algo(jcls, jcfg, algo.spec)
    explore = "squashed_gaussian" if name == "SAC" else "stochastic"
    drive_jax_sampling(jalgo, [JEnvRunner("Pendulum-v1", 4, 16, seed=2,
                                          explore=explore)])
    if name == "SAC":
        _sac_deterministic(algo, jalgo)
    algo.set_params(carry(jalgo.learner.params, algo))
    if name != "DDPG":
        JaxDraws(jcfg.seed, n_keys).install(monkeypatch, tmodels)
    for it in range(2):
        want = jalgo.training_step()
        got = algo.train()
        assert_tree_close(algo.get_params(), jalgo.learner.params)
        np.testing.assert_allclose(
            algo.buffer._storage["obs"], jalgo.buffer._storage["obs"],
            rtol=0, atol=ATOL)
        for k, v in want.items():
            assert abs(got[k] - float(v)) < ATOL * max(1, abs(float(v))), k
    assert got["buffer_size"] == 128
    p = algo.get_params()
    for n in ("q1", "q2", "pi"):
        if n in p and f"{n}_target" in p:
            assert shares_storage(p[n], p[f"{n}_target"]) == []
    ev = algo.evaluate(1)
    assert ev["episodes"] >= 1 and np.isfinite(ev["episode_return_mean"])


def test_apex_ddpg_round_robin_matches_jax(mean_actions):
    """The sigma ladder equals JAX's; two runners consumed round robin
    under their submitted params, prioritized replay, against JAX driven
    by hand."""
    def cfg(cls):
        return _config(cls, num_env_runners=2, num_envs_per_runner=2,
                       rollout_fragment_length=16, learning_starts=32,
                       minibatch_size=16, updates_per_iter=3,
                       prioritized_replay=True, seed=5, lr=1e-3)

    algo = cfg(trl.ApexDDPGConfig).build(device="cpu")
    jc = cfg(JAlgorithmConfig)
    jc.apex_sigma_base, jc.apex_sigma_alpha = 0.4, 3.0
    jc.policy_delay, jc.target_noise = 1, 0.0
    jalgo = jax_algo(JApexDDPG, jc, algo.spec, runners=[None, None])
    assert algo._runner_sigmas == jalgo._runner_sigmas == [0.4, 0.4 ** 4]
    algo.set_params(carry(jalgo.learner.params, algo))
    jrunners = [JEnvRunner("Pendulum-v1", 2, 16, seed=5 + 1000 * i)
                for i in range(2)]
    inflight = {i: jalgo._params_for(i) for i in range(2)}
    for _ in range(2):
        for i in (0, 1):
            frag = jrunners[i].sample(inflight.pop(i))
            inflight[i] = jalgo._params_for(i)
            jalgo._store_batch(frag)
        want = jalgo._replay_updates(3)
        got = algo.train()
        assert got["env_steps_this_iter"] == 64
        assert_tree_close(algo.get_params(), jalgo.learner.params)
        np.testing.assert_allclose(algo.buffer._tree, jalgo.buffer._tree,
                                   rtol=1e-5)
        for k, v in want.items():
            assert abs(got[k] - v) < ATOL * max(1, abs(v)), k
    assert got["num_updates"] == jalgo._updates == 6
