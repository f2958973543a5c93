"""ray_tpu_torch's value-based RL (DQN, SimpleQ, Ape-X DQN, R2D2) against
the JAX package's, in one process, and the RL registry and tuned examples.

Conventions in ``tests/_torch_rl_offpolicy.py``. Exploration is made
greedy on both sides (epsilon 0, or Ape-X's ladder base 0), so CartPole's
numpy env sees the same actions and the transitions are held to
equality; R2D2's epsilon-greedy draws come from numpy in both packages
and run with JAX's own schedule. JAX's DQN ``training_step`` runs as
written, its sampling over the plain class of its runner actor; Ape-X's
round robin is driven by hand.
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

from _torch_rl_offpolicy import (ATOL, JEnvRunner, assert_loss_parity,
                                 assert_tree_close, carry, drive_jax_sampling,
                                 jax_algo, np_tree, shares_storage)
from ray_tpu.rl import models as jmodels
from ray_tpu.rl import train as jtrain
from ray_tpu.rl.algorithms import r2d2 as jr2d2
from ray_tpu.rl.algorithms.apex import ApexDQN as JApexDQN
from ray_tpu.rl.algorithms.dqn import DQN as JDQN
from ray_tpu.rl.config import AlgorithmConfig as JAlgorithmConfig
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import train as ttrain
from ray_tpu_torch.rl.algorithms import r2d2 as tr2d2
from ray_tpu_torch.rl.algorithms.dqn import make_dqn_loss
from ray_tpu_torch.rl.env import EnvSpec

HIDDEN = (16, 16)
CARTPOLE = EnvSpec(obs_dim=4, num_actions=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jq(seed):
    return jmodels.init_policy(jax.random.key(seed), CARTPOLE, HIDDEN)


def _transitions(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "dones": rng.random(n) < 0.2}


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_dqn_loss_matches_jax(double_q, weighted):
    jcfg = JAlgorithmConfig(double_q=double_q, gamma=0.97, hidden=HIDDEN)
    jalgo = jax_algo(JDQN, jcfg, CARTPOLE, init_policy_params=lambda: _jq(1))
    jparams = dict(jalgo.learner.params, target=_jq(2))
    batch = _transitions(32)
    if weighted:
        batch["weights"] = np.random.default_rng(1).uniform(
            0.1, 1.0, 32).astype(np.float32)
    tparams = carry(jparams, {"q": trl.models.init_policy(
        torch.Generator().manual_seed(0), CARTPOLE, HIDDEN),
        "target": trl.models.init_policy(torch.Generator(), CARTPOLE,
                                         HIDDEN)})
    assert_loss_parity(make_dqn_loss(0.97, double_q), tparams,
                       jalgo.learner._loss_fn, jparams, batch,
                       jax.random.key(0))


def test_simpleq_strips_dqn_addons():
    """As tests/test_rl_cli.py:105 holds JAX's."""
    cfg = ttrain.get_algorithm_config("SimpleQ")
    assert cfg.double_q is False and cfg.prioritized_replay is False
    assert ttrain.get_algorithm_config("DQN").double_q is True
    algo = cfg.build(device="cpu")
    assert type(algo).__name__ == "SimpleQ" and isinstance(algo, trl.DQN)
    assert type(algo.buffer).__name__ == "ReplayBuffer"


def _dqn_config(cls, **kw):
    """``cls()`` with these fields set after its own defaults."""
    return cls().training(num_env_runners=1, num_envs_per_runner=4,
                          rollout_fragment_length=16, learning_starts=32,
                          minibatch_size=16, target_update_freq=3,
                          prioritized_replay=True, epsilon_initial=0.0,
                          epsilon_final=0.0, hidden=HIDDEN, seed=2, lr=1e-3,
                          **kw)


def _assert_buffer_same(tbuf, jbuf):
    assert (len(tbuf), tbuf._next) == (len(jbuf), jbuf._next)
    for k, v in jbuf._storage.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(tbuf._storage[k], v, rtol=0,
                                       atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(tbuf._storage[k], v, err_msg=k)
    if hasattr(jbuf, "_tree"):
        np.testing.assert_allclose(tbuf._tree, jbuf._tree, rtol=1e-5)
    assert tbuf._rng.bit_generator.state == jbuf._rng.bit_generator.state


def test_dqn_three_iterations_match_jax():
    """Prioritized replay, double-Q, hard syncs every 3 updates (4 updates
    an iteration): params, the buffer's rows, priorities and generator,
    and the metrics after each iteration."""
    algo = _dqn_config(trl.DQNConfig).build(device="cpu")
    jcfg = _dqn_config(JAlgorithmConfig)
    jalgo = jax_algo(JDQN, jcfg, algo.spec,
                     init_policy_params=lambda: _jq(5))
    drive_jax_sampling(jalgo, [JEnvRunner(
        "CartPole-v1", 4, 16, jcfg.gamma, jcfg.lambda_, seed=jcfg.seed,
        explore="epsilon_greedy")])
    algo.set_params(carry(jalgo.learner.params, algo))
    for it in range(3):
        want = jalgo.training_step()
        got = algo.train()
        assert_tree_close(algo.get_params(), jalgo.learner.params)
        _assert_buffer_same(algo.buffer, jalgo.buffer)
        for k in ("epsilon", "buffer_size", "num_updates"):
            assert got[k] == want[k], k
        assert abs(got["td_abs_mean"] - want["td_abs_mean"]) < ATOL
    assert got["num_updates"] == 12 and got["env_steps_total"] == 192
    # the last sync (update 12) left a copy of q, not q itself
    p = algo.get_params()
    assert shares_storage(p["q"], p["target"]) == []
    assert all(torch.equal(a, b) for a, b in zip(
        trl.models._leaves(p["q"]).values(),
        trl.models._leaves(p["target"]).values()))
    assert algo.get_extra_state() == {"updates": 12}


def test_hard_sync_copies_never_aliases():
    """The target after a sync is a copy: an in-place change of q (or an
    optimizer that updated in place) does not move it."""
    algo = _dqn_config(trl.DQNConfig, updates_per_iter=3).build(device="cpu")
    for _ in range(2):
        algo.train()
    p = algo.get_params()
    assert algo._updates % 3 == 0 and shares_storage(p["q"], p["target"]) \
        == []
    before = p["target"]["pi"]["layers"][0]["w"].clone()
    with torch.no_grad():
        p["q"]["pi"]["layers"][0]["w"].add_(1.0)
    assert torch.equal(p["target"]["pi"]["layers"][0]["w"], before)


def test_apex_dqn_ladder_and_round_robin_match_jax():
    """The ladder equals JAX's; two iterations of two runners consumed
    round robin under the params they were submitted with (the ladder's
    base 0 makes every runner greedy) against JAX driven by hand."""
    jcfg = JAlgorithmConfig(num_env_runners=4, prioritized_replay=True)
    jcfg.apex_eps_base, jcfg.apex_eps_alpha = 0.4, 7.0
    jladder = jax_algo(JApexDQN, jcfg, CARTPOLE, runners=[None] * 4,
                       init_policy_params=lambda: _jq(0))._runner_eps
    tcfg = trl.ApexDQNConfig(hidden=HIDDEN, num_envs_per_runner=2,
                             rollout_fragment_length=4)
    assert trl.ApexDQNConfig().num_env_runners == 4
    assert tcfg.build(device="cpu")._runner_eps == jladder

    def cfg(cls):
        c = cls().training(num_env_runners=2, num_envs_per_runner=4,
                           rollout_fragment_length=8, learning_starts=32,
                           minibatch_size=16, updates_per_iter=3,
                           target_update_freq=2, prioritized_replay=True,
                           hidden=HIDDEN, seed=4, lr=1e-3)
        c.apex_eps_base, c.apex_eps_alpha = 0.0, 7.0
        return c

    algo = cfg(trl.ApexDQNConfig).build(device="cpu")
    jalgo = jax_algo(JApexDQN, cfg(JAlgorithmConfig), algo.spec,
                     runners=[None, None], init_policy_params=lambda: _jq(6))
    assert algo._runner_eps == jalgo._runner_eps == [0.0, 0.0]
    algo.set_params(carry(jalgo.learner.params, algo))
    jrunners = [JEnvRunner("CartPole-v1", 4, 8, seed=4 + 1000 * i,
                           explore="epsilon_greedy") for i in range(2)]
    inflight = {i: jalgo._params_for(i) for i in range(2)}
    for it in range(2):
        for i in (0, 1):
            frag = jrunners[i].sample(inflight.pop(i))
            inflight[i] = jalgo._params_for(i)
            jalgo._store_batch(frag)
        td = (jalgo._replay_updates(3)
              if len(jalgo.buffer) >= 32 else None)
        got = algo.train()
        assert got["env_steps_this_iter"] == 64
        _assert_buffer_same(algo.buffer, jalgo.buffer)
        assert_tree_close(algo.get_params(), jalgo.learner.params)
        if td is not None:
            assert abs(got["td_abs_mean"] - td) < ATOL
    assert got["num_updates"] == jalgo._updates == 6
    with pytest.raises(ValueError, match="requires prioritized_replay"):
        trl.ApexDQNConfig().training(prioritized_replay=False).build(
            device="cpu")
    with pytest.raises(ValueError, match="requires prioritized_replay"):
        trl.ApexDDPGConfig().training(prioritized_replay=False).build(
            device="cpu")


def _gru_inputs(seed=0, B=3, L=5, E=6, H=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, E)).astype(np.float32),
            rng.normal(size=(B, H)).astype(np.float32))


def test_gru_step_and_unroll_match_jax():
    jp = jr2d2.init_gru(jax.random.key(3), 6, 8)
    x, h = _gru_inputs()
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    np.testing.assert_allclose(
        tr2d2.gru_step(tp, torch.tensor(h), torch.tensor(x[:, 0])).numpy(),
        np.asarray(jr2d2.gru_step(jp, h, x[:, 0])), rtol=0, atol=ATOL)
    # the unroll: JAX's lax.scan over gru_step (r2d2.py:133-141) against
    # the port's loop, through an encoder and a head
    net = {"enc": jmodels.init_mlp(jax.random.key(4), (6, 6),
                                   out_scale=1.0),
           "gru": jp, "head": jmodels.init_mlp(jax.random.key(5), (8, 2))}

    def jax_unroll(n, obs, h0):
        emb = jax.numpy.tanh(jmodels.mlp_forward(n["enc"], obs))
        _, hs = jax.lax.scan(
            lambda c, e: (jr2d2.gru_step(n["gru"], c, e),) * 2, h0,
            jax.numpy.swapaxes(emb, 0, 1))
        return jmodels.mlp_forward(n["head"], jax.numpy.swapaxes(hs, 0, 1))

    tnet = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                  net)
    np.testing.assert_allclose(
        tr2d2.unroll(tnet, torch.tensor(x), torch.tensor(h)).numpy(),
        np.asarray(jax_unroll(net, x, h)), rtol=0, atol=ATOL)
    h2, q = tr2d2.act_q(tnet, torch.tensor(h), torch.tensor(x[:, 0]))
    assert h2.shape == (3, 8) and q.shape == (3, 2)
    # init's recipe: uniform within 1/sqrt(fan), zero bias
    g = tr2d2.init_gru(torch.Generator().manual_seed(0), 6, 8)
    assert g["wx"].shape == (6, 24) and g["wh"].shape == (8, 24)
    assert g["wx"].abs().max() <= 1 / np.sqrt(6) and not g["b"].any()


def _r2d2_config(cls):
    cfg = cls()
    return cfg.training(num_envs_per_runner=4, rollout_fragment_length=24,
                        hidden=(8,), gru_hidden=8, seq_len=6, burn_in=2,
                        learning_starts=8, minibatch_size=6,
                        updates_per_iter=3, target_update_freq=4,
                        epsilon_decay_steps=200, seed=3, lr=1e-3)


def _r2d2_pair():
    algo = _r2d2_config(trl.R2D2Config).build(device="cpu")
    jalgo = jr2d2.R2D2({"__algo_config": _r2d2_config(jr2d2.R2D2Config)})
    algo.set_params(carry(jalgo.learner.params, algo))
    return algo, jalgo


def _assert_r2d2_state(algo, jalgo):
    _assert_buffer_same(algo.buffer, jalgo.buffer)
    np.testing.assert_allclose(algo._h, jalgo._h, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(algo._obs, jalgo._obs)
    for t, j in zip(algo._open, jalgo._open):
        assert {k: len(v) for k, v in t.items() if k != "h0"} == \
            {k: len(v) for k, v in j.items() if k != "h0"}
        np.testing.assert_allclose(t["h0"], j["h0"], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(t["actions"], j["actions"])
    assert algo._return_window == jalgo._return_window
    assert algo._env_steps_total == jalgo._env_steps_total


def test_r2d2_sequences_and_masked_loss_match_jax():
    """Collection (sequences cut at seq_len and episode ends, the stored
    h0, the zeroed state at episode ends, numpy's epsilon-greedy draws),
    then the masked double-Q loss on one sampled minibatch."""
    algo, jalgo = _r2d2_pair()
    algo._collect(24)
    jalgo._collect(24)
    _assert_r2d2_state(algo, jalgo)
    valid = algo.buffer._storage["valid"][:len(algo.buffer)]
    assert (valid.sum(1) < 6).any() and (valid.sum(1) == 6).any()
    mb = algo.buffer.sample(6)
    jalgo.buffer.sample(6)
    assert_loss_parity(tr2d2.make_r2d2_loss(algo.config.gamma, 2),
                       algo.get_params(), jalgo.learner._loss_fn,
                       jalgo.learner.params, mb, jax.random.key(0))


def test_r2d2_two_steps_match_jax(tmp_path):
    algo, jalgo = _r2d2_pair()
    for _ in range(2):
        want, got = jalgo.train(), algo.train()
        _assert_r2d2_state(algo, jalgo)
        assert_tree_close(algo.get_params(), jalgo.learner.params)
        assert want.keys() - {"time_total_s"} <= got.keys()
        for k in ("epsilon", "buffer_sequences", "env_steps_total",
                  "episode_return_mean"):
            assert got[k] == pytest.approx(want[k], abs=1e-9), k
        for k in ("loss", "td_abs_mean", "q_mean", "grad_norm"):
            assert abs(got[k] - want[k]) < ATOL * max(1, abs(want[k])), k
    assert algo._grad_updates == 6
    p = algo.get_params()
    assert shares_storage(p["q"], p["target"]) == []
    ev = algo.evaluate(2)
    assert ev["episodes"] >= 2 and np.isfinite(ev["episode_return_mean"])
    path = algo.save(str(tmp_path / "r2d2"))
    algo2 = _r2d2_config(trl.R2D2Config).build(device="cpu")
    algo2.restore(path)
    assert_tree_close(algo2.get_params(), np_tree(jalgo.learner.params))
    assert algo2._env_steps_total == algo._env_steps_total
    with pytest.raises(ValueError, match="discrete"):
        trl.R2D2Config().training(env="Pendulum-v1").build(device="cpu")


PORTED = ("PPO", "APPO", "IMPALA", "A2C", "PG", "DQN", "SIMPLEQ", "APEXDQN",
          "APEXDDPG", "SAC", "DDPG", "TD3", "BC", "MARWIL", "CQL", "CRR",
          "R2D2", "MAML", "MBMPO", "QMIX", "MADDPG", "DREAMERV3", "ES",
          "ARS", "ALPHAZERO", "LEELACHESSZERO", "DT", "SLATEQ",
          "BANDITLINUCB", "BANDITLINTS")


def test_registry_and_tuned_examples_match_jax():
    """The registry holds exactly the ported names, each building the
    class JAX's name builds; every bundled yaml is JAX's copy and runs a
    registered algorithm."""
    reg, jreg = ttrain.algorithm_registry(), jtrain.algorithm_registry()
    assert sorted(reg) == sorted(PORTED) == sorted(jreg)
    for name in PORTED:
        assert ttrain.get_algorithm_config(name).algo_class.__name__ \
            == jtrain.get_algorithm_config(name).algo_class.__name__, name
    names = ttrain.list_tuned_examples()
    assert len(names) == 18
    for name in names:
        exp = ttrain.load_tuned_example(name)
        assert exp == jtrain.load_tuned_example(name), name
        cfg = ttrain.get_algorithm_config(exp["run"])
        cfg.update_from_dict(exp["config"])   # every key is known


@pytest.mark.parametrize("run,env,config,steps", [
    ("DQN", "CartPole-v1", {"learning_starts": 16}, 32),
    ("SIMPLEQ", "CartPole-v1", {"learning_starts": 16}, 32),
    ("APEXDQN", "CartPole-v1", {"num_env_runners": 2, "learning_starts": 16,
                                "updates_per_iter": 2}, 64),
    ("R2D2", "CartPoleNoVel-v0", {"learning_starts": 2, "seq_len": 4,
                                  "burn_in": 1, "gru_hidden": 8,
                                  "minibatch_size": 4,
                                  "updates_per_iter": 2}, 32)])
def test_run_train_value_based(run, env, config, steps):
    """Two iterations through ``run_train`` on the CPU, updates in the
    second."""
    config = dict(config, num_envs_per_runner=4, rollout_fragment_length=8,
                  hidden=[8])
    out = io.StringIO()
    res = ttrain.run_train(run, env=env, config_json=json.dumps(config), stop_iters=2, out=out, device="cpu")
    assert res["training_iteration"] == 2 and "iter 2/2" in out.getvalue()
    assert res["env_steps_total"] == 2 * steps
    assert np.isfinite(res["td_abs_mean"])


@pytest.mark.parametrize("name", ["cartpole-dqn", "cartpole-apex-dqn",
                                  "masked-cartpole-r2d2", "pendulum-sac",
                                  "pendulum-ddpg", "pendulum-td3",
                                  "pendulum-apex-ddpg"])
def test_run_tuned_example_off_policy(name):
    """One iteration of each off-policy tuned example, at its own config,
    through ``run_tuned_example`` on the CPU."""
    exp = ttrain.load_tuned_example(name)
    cfg = dict(exp["config"])
    want = (max(1, cfg["num_env_runners"]) * cfg["num_envs_per_runner"]
            * cfg.get("rollout_fragment_length", 64))
    res = ttrain.run_tuned_example(name, stop_iters=1, out=io.StringIO(),
                                   device="cpu")
    assert res["training_iteration"] == 1
    assert res["env_steps_total"] == want
