"""ray_tpu_torch's offline RL (BC, MARWIL, CQL, CRR) against the JAX
package's, in one process.

Conventions in ``tests/_torch_rl_offpolicy.py``. CQL's and CRR's losses
draw their noise through ``models.normal`` / ``models.uniform``, replaced
here by a replay of JAX's key chain (``JaxDraws``). The datasets are
seeded numpy dicts; minibatches come from numpy generators seeded alike
in both packages, so JAX's ``training_step`` runs as written on the same
rows.
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

from _torch_rl_offpolicy import (ATOL, JaxDraws, assert_loss_parity,
                                 assert_tree_close, carry, jax_algo,
                                 shares_storage)
from ray_tpu.rl import models as jmodels
from ray_tpu.rl.algorithms.cql import CQL as JCQL
from ray_tpu.rl.algorithms.cql import CQLConfig as JCQLConfig
from ray_tpu.rl.algorithms.crr import CRR as JCRR
from ray_tpu.rl.algorithms.crr import CRRConfig as JCRRConfig
from ray_tpu.rl.algorithms.offline import BC as JBC
from ray_tpu.rl.algorithms.offline import BCConfig as JBCConfig
from ray_tpu.rl.algorithms.offline import MARWIL as JMARWIL
from ray_tpu.rl.algorithms.offline import MARWILConfig as JMARWILConfig
from ray_tpu.rl.algorithms.offline import _mc_returns as jmc_returns
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl import train as ttrain
from ray_tpu_torch.rl.algorithms import cql as tcql
from ray_tpu_torch.rl.algorithms import crr as tcrr
from ray_tpu_torch.rl.algorithms import offline as toffline
from ray_tpu_torch.rl.env import EnvSpec

HIDDEN = (16, 16)
CARTPOLE = EnvSpec(obs_dim=4, num_actions=2)
PENDULUM = EnvSpec(obs_dim=3, action_dim=1, action_low=-2.0,
                   action_high=2.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cartpole_data(n=96, seed=0, env_ids=False):
    rng = np.random.default_rng(seed)
    data = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": np.ones(n, np.float32),
            "dones": rng.random(n) < 0.08}
    if env_ids:
        data["env_ids"] = np.arange(n) % 4
    return data


def _pendulum_data(n=96, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 3)).astype(np.float32),
            "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
            "dones": rng.random(n) < 0.1}


@pytest.mark.parametrize("with_env_ids", [False, True])
def test_mc_returns_match_jax(with_env_ids):
    d = _cartpole_data(64, seed=3, env_ids=with_env_ids)
    d["rewards"] = np.random.default_rng(4).normal(size=64).astype(
        np.float32)
    ids = d.get("env_ids")
    got = toffline._mc_returns(d["rewards"], d["dones"], 0.9, env_ids=ids)
    want = jmc_returns(d["rewards"], d["dones"], 0.9, env_ids=ids)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.float32


def _config(cls, **kw):
    """``cls()`` (its own defaults first), then the test's fields."""
    return cls().training(**{"hidden": HIDDEN, "seed": 1, **kw})


def _jpolicy(spec, seed):
    p = jmodels.init_policy(jax.random.key(seed), spec, HIDDEN)
    if not spec.discrete:   # a log_std away from 0
        p["log_std"] = p["log_std"] - 0.3
    return p


@pytest.mark.parametrize("name,env", [("BC", "CartPole-v1"),
                                      ("MARWIL", "CartPole-v1"),
                                      ("BC", "Pendulum-v1"),
                                      ("MARWIL", "Pendulum-v1")])
def test_bc_marwil_loss_and_two_iterations_match_jax(name, env):
    spec = CARTPOLE if env == "CartPole-v1" else PENDULUM
    data = (_cartpole_data(env_ids=True) if spec.discrete
            else _pendulum_data())
    kw = dict(env=env, offline_data=data, minibatch_size=32, lr=1e-3,
              beta=0.7)
    tcls, jcls, jcfg_cls = {"BC": (trl.BCConfig, JBC, JBCConfig),
                            "MARWIL": (trl.MARWILConfig, JMARWIL,
                                       JMARWILConfig)}[name]
    algo = _config(tcls, **kw).build(device="cpu")
    jalgo = jax_algo(jcls, _config(jcfg_cls, **kw), spec)
    jalgo.learner.params = _jpolicy(spec, 2)
    algo.set_params(carry(jalgo.learner.params, algo))
    np.testing.assert_array_equal(algo._data.get("returns"),
                                  jalgo._data.get("returns"))
    beta = 0.0 if name == "BC" else 0.7
    mb = {k: v[:32] for k, v in jalgo._data.items()}
    assert_loss_parity(
        toffline.make_marwil_loss(algo.spec, beta, algo.config.vf_coeff),
        algo.get_params(), jalgo.learner._loss_fn, jalgo.learner.params,
        mb, jax.random.key(0))
    for _ in range(2):
        want, got = jalgo.training_step(), algo.train()
        assert_tree_close(algo.get_params(), jalgo.learner.params)
        for k, v in want.items():
            assert abs(got[k] - float(v)) < ATOL * max(1, abs(float(v))), k
    assert got["samples_this_iter"] == 96 and got["env_steps_total"] == 192
    assert np.isfinite(algo.evaluate(1)["episode_return_mean"])


def _draws_of(name):
    return {"CQL": 4, "CRR": 2}[name]


@pytest.mark.parametrize("name,weight_type", [("CQL", None), ("CRR", "exp"),
                                              ("CRR", "bin")])
def test_cql_crr_loss_and_two_iterations_match_jax(monkeypatch, name,
                                                   weight_type):
    """The loss on one batch with JAX's draws from a key, then two
    iterations of 3 updates with JAX's learner's draws."""
    kw = dict(offline_data=_pendulum_data(), minibatch_size=32,
              updates_per_iter=3, lr=1e-3, tau=0.1)
    if name == "CQL":
        kw.update(cql_num_actions=3)
    else:
        kw.update(crr_num_actions=3, crr_weight_type=weight_type)
    tcls, jcls, jcfg_cls, make_loss = {
        "CQL": (trl.CQLConfig, JCQL, JCQLConfig, tcql.make_cql_loss),
        "CRR": (trl.CRRConfig, JCRR, JCRRConfig, tcrr.make_crr_loss)}[name]
    algo = _config(tcls, **kw).build(device="cpu")
    jalgo = jax_algo(jcls, _config(jcfg_cls, **kw), PENDULUM)
    jp = jalgo.learner.params
    for k in ("q1_target", "q2_target"):
        jp[k] = jax.tree_util.tree_map(lambda x: x * 0.9, jp[k])
    algo.set_params(carry(jp, algo))
    key = jax.random.key(3)
    draws = JaxDraws.of_key(key, _draws_of(name))
    draws.install(monkeypatch, tmodels)
    assert_loss_parity(make_loss(algo.spec, algo.config), algo.get_params(),
                       jalgo.learner._loss_fn, jp,
                       {k: v[:32] for k, v in jalgo._data.items()}, key,
                       torch.Generator())
    assert draws.calls == _draws_of(name)
    JaxDraws(1, _draws_of(name)).install(monkeypatch, tmodels)
    for _ in range(2):
        want, got = jalgo.training_step(), algo.train()
        assert_tree_close(algo.get_params(), jalgo.learner.params)
        for k, v in want.items():
            assert abs(got[k] - float(v)) < ATOL * max(1, abs(float(v))), k
    p = algo.get_params()
    assert shares_storage(p["q1"], p["q1_target"]) == []
    assert algo._env_steps_total == 0


def _one_step_dataset(n=2048, seed=0):
    """tests/test_rl_extras.py:174's 1-step continuous MDP: reward =
    -(a - f(s))^2 with behavior actions near the optimum, so actions far
    from it are out of distribution."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    opt = np.tanh(obs[:, :1])
    actions = (opt + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    rewards = (-np.square(actions - opt).sum(-1)).astype(np.float32)
    return {"obs": obs, "actions": actions, "rewards": rewards,
            "next_obs": obs, "dones": np.ones(n, dtype=bool)}


def test_cql_penalizes_out_of_distribution_actions():
    """CQL's defining property, as tests/test_rl_extras.py:187 holds
    JAX's: Q on dataset-supported actions above Q on actions near the
    edge of the action space, and above Q on uniform random actions."""
    algo = _config(trl.CQLConfig, offline_data=_one_step_dataset(),
                   updates_per_iter=100, minibatch_size=256,
                   cql_alpha=10.0).build(device="cpu")
    for _ in range(2):
        m = algo.train()
    assert np.isfinite(m["bellman_loss"])
    probe = _one_step_dataset(256, seed=9)
    in_dist = np.tanh(probe["obs"][:, :1])
    q_in = algo.q_value(probe["obs"], in_dist).mean()
    q_ood = algo.q_value(probe["obs"], np.full_like(in_dist, 1.9)).mean()
    q_rand = algo.q_value(probe["obs"], np.random.default_rng(1).uniform(
        -2, 2, in_dist.shape).astype(np.float32)).mean()
    assert q_in > q_ood and q_in > q_rand, (q_in, q_ood, q_rand)


def test_refusals():
    with pytest.raises(ValueError, match="continuous control"):
        trl.CRRConfig().training(env="CartPole-v1",
                                 offline_data=_cartpole_data()).build(
                                     device="cpu")
    with pytest.raises(ValueError, match="crr_weight_type"):
        trl.CRRConfig().training(offline_data=_pendulum_data(),
                                 crr_weight_type="max").build(device="cpu")
    with pytest.raises(TypeError, match="ROADMAP item R"):
        trl.BCConfig(offline_data=[{"obs": [0.0] * 4}]).build(device="cpu")
    for cfg in (trl.BCConfig(), trl.MARWILConfig(), trl.CQLConfig(),
                trl.CRRConfig()):
        with pytest.raises(ValueError, match="offline_data"):
            cfg.build(device="cpu")
    with pytest.raises(ValueError, match="missing 'next_obs'"):
        trl.CQLConfig().training(offline_data=_cartpole_data()).build(
            device="cpu")


@pytest.mark.parametrize("run,env", [("BC", "CartPole-v1"),
                                     ("MARWIL", "CartPole-v1"),
                                     ("CQL", "Pendulum-v1"),
                                     ("CRR", "Pendulum-v1")])
def test_run_train_offline(run, env):
    """Two iterations through ``run_train``, the dataset given as JSON
    lists (read back as float32, as JAX's device arrays hold it)."""
    data = _cartpole_data(48) if env == "CartPole-v1" else _pendulum_data(48)
    config = {"offline_data": {k: v.tolist() for k, v in data.items()},
              "hidden": [8], "minibatch_size": 16}
    if run in ("CQL", "CRR"):
        config["updates_per_iter"] = 2
    out = io.StringIO()
    res = ttrain.run_train(run, env=env, config_json=json.dumps(config),
                           stop_iters=2, out=out, device="cpu")
    assert res["training_iteration"] == 2 and "iter 2/2" in out.getvalue()
    assert all(np.isfinite(v) for k, v in res.items()
               if isinstance(v, float))
