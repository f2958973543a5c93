"""ray_tpu_torch's EnvRunner and Algorithm (PPO, IMPALA; PG through the
tuned examples) against the JAX package's, in one process.

CPU, float32 on both sides, JAX's params carried over through numpy.
Sampling is made deterministic: ``categorical_sample`` is patched to the
argmax and ``gaussian_sample`` to the mean in both packages before the
first call (JAX's jitted ``act`` reads the module attribute when it
traces). CartPole's numpy env and connectors then see the same actions,
so its obs, actions, rewards and dones are held to equality; Pendulum's
actions are the policy's float means, so its env columns are held, as
logp, values and GAE are, within 1e-5 absolute
(tests/test_long_context.py:34); params
after updates within 1e-4 of the reference's max |value| per leaf
(:57). The JAX side is driven by hand: ``EnvRunner._cls`` (the plain
class of JAX's actor) and JAX's ``Learner``, no cluster.
"""

import dataclasses
import io
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import models as jmodels
from ray_tpu.rl.algorithms.impala import IMPALA as JIMPALA
from ray_tpu.rl.algorithms.ppo import make_ppo_loss as jmake_ppo_loss
from ray_tpu.rl.config import AlgorithmConfig as JAlgorithmConfig
from ray_tpu.rl.connectors import build_connectors as jbuild_connectors
from ray_tpu.rl.env import EnvSpec as JEnvSpec
from ray_tpu.rl.env_runner import EnvRunner as JEnvRunnerActor
from ray_tpu.rl.learner import Learner as JLearner
from ray_tpu_torch import rl as trl
from ray_tpu_torch.models.convert import (params_to_numpy,
                                          policy_params_from_jax)
from ray_tpu_torch.parallel.train_step import _leaves
from ray_tpu_torch.rl import anakin as tanakin
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl import train as ttrain
from ray_tpu_torch.rl.env_runner import EnvRunner

JEnvRunner = JEnvRunnerActor._cls
ATOL, REL = 1e-5, 1e-4
HIDDEN = (16, 16)
EXACT = ("obs", "actions", "actions_executed", "rewards", "dones",
         "next_obs")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def greedy(monkeypatch):
    """Deterministic sampling in both packages."""
    monkeypatch.setattr(jmodels, "categorical_sample",
                        lambda key, logits: jnp.argmax(logits, axis=-1))
    monkeypatch.setattr(jmodels, "gaussian_sample",
                        lambda key, mean, log_std: mean)
    monkeypatch.setattr(tmodels, "categorical_sample",
                        lambda gen, logits: torch.argmax(logits, dim=-1))
    monkeypatch.setattr(tmodels, "gaussian_sample",
                        lambda gen, mean, log_std: mean)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _assert_tree_close(got, want, rel=REL):
    got = {k: np.asarray(v) for k, v in _leaves(got).items()}
    want = {k: np.asarray(v) for k, v in _leaves(_np(want)).items()}
    assert got.keys() == want.keys()
    for name in want:
        assert _rel(got[name], want[name]) < rel, name


def _assert_batch_close(got, want, discrete):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
        if discrete and k in EXACT:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                       err_msg=k)


def _jspec(spec):
    return JEnvSpec(**dataclasses.asdict(spec))


def _jax_policy(spec, seed=0):
    jp = jmodels.init_policy(jax.random.key(seed), _jspec(spec), HIDDEN)
    return jp, _np(jp)


@pytest.mark.parametrize("env,connectors", [
    ("CartPole-v1", ["mean_std_filter", {"type": "clip_reward",
                                         "limit": 0.5}]),
    ("Pendulum-v1", ["mean_std_filter"])], ids=["cartpole", "pendulum"])
def test_env_runner_sample_matches_jax(greedy, env, connectors):
    """Three fragments each (episodes end inside them), key by key."""
    kw = dict(gamma=0.97, lam=0.9, seed=5, connectors=connectors)
    jr = JEnvRunner(env, 4, 70, **kw)
    tr = EnvRunner(env, 4, 70, device="cpu", **kw)
    jp, npp = _jax_policy(tr.spec, seed=1)
    tp = policy_params_from_jax(npp, tr.spec, HIDDEN, device="cpu")
    for _ in range(3):
        _assert_batch_close(tr.sample(tp), jr.sample(jp), tr.spec.discrete)
        ts, js = tr.episode_stats(), jr.episode_stats()
        assert ts["episodes"] == js["episodes"]
        np.testing.assert_allclose(ts["mean_return"], js["mean_return"],
                                   rtol=ATOL)
        deltas_t, deltas_j = tr.pop_connector_deltas(), \
            jr.pop_connector_deltas()
        same = (np.testing.assert_array_equal if tr.spec.discrete else
                lambda a, b: np.testing.assert_allclose(a, b, rtol=ATOL))
        jax.tree_util.tree_map(same, deltas_t, deltas_j)
    assert tr.get_spec() == tr.spec and tr.get_pid() == os.getpid()


def _ppo_config(mod_cfg, **kw):
    cfg = mod_cfg(num_env_runners=2, num_envs_per_runner=4,
                  rollout_fragment_length=16, minibatch_size=32,
                  num_epochs=2, hidden=HIDDEN, seed=3,
                  connectors=["mean_std_filter"], **kw)
    return cfg


def test_ppo_two_iterations_match_hand_driven_jax(greedy):
    cfg = _ppo_config(trl.PPOConfig)
    algo = cfg.build(device="cpu")
    jp, npp = _jax_policy(algo.spec, seed=2)
    algo.set_params(npp)
    # JAX's PPO iteration by hand: the runners (seeds cfg.seed + 1000 i),
    # the connector sync, the concatenation, Learner.update
    jcfg = _ppo_config(JAlgorithmConfig)
    jrunners = [JEnvRunner("CartPole-v1", 4, 16, jcfg.gamma, jcfg.lambda_,
                           seed=jcfg.seed + 1000 * i,
                           connectors=jcfg.connectors) for i in range(2)]
    loss = jmake_ppo_loss(_jspec(algo.spec), jcfg.clip_param,
                          jcfg.vf_coeff, jcfg.entropy_coeff)
    jl = JLearner(jp, loss, jcfg.lr, grad_clip=jcfg.grad_clip,
                  seed=jcfg.seed)
    merger = jbuild_connectors(jcfg.connectors, 4)
    state, steps = None, 0
    for i in range(2):
        frags = [r.sample(jl.get_params()) for r in jrunners]
        state = merger.merge_deltas(
            state, [r.pop_connector_deltas() for r in jrunners])
        for r in jrunners:
            r.set_connector_globals(state)
        batch = {k: np.concatenate([f[k] for f in frags]) for k in frags[0]
                 if k != "last_values"}
        steps += len(batch["rewards"])
        jm = jl.update(batch, num_epochs=jcfg.num_epochs,
                       minibatch_size=jcfg.minibatch_size,
                       seed=jcfg.seed + i)
        result = algo.train()
        _assert_tree_close(algo.get_params(), jl.get_params())
        assert result["env_steps_total"] == steps
        assert result["env_steps_this_iter"] == 128
        assert result["training_iteration"] == i + 1
        assert abs(result["loss"] - jm["loss"]) < ATOL * max(
            1.0, abs(jm["loss"]))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           algo._connector_state, state)


def test_impala_two_iterations_match_round_robin_jax(greedy):
    """The runners are consumed round robin, each sampled with the params
    it was submitted with and resubmitted with the current params before
    the update on its fragment."""
    cfg = trl.IMPALAConfig(num_envs_per_runner=4, rollout_fragment_length=8,
                           hidden=HIDDEN, seed=1, lr=1e-3)
    algo = cfg.build(device="cpu")
    jp, npp = _jax_policy(algo.spec, seed=4)
    algo.set_params(npp)
    jcfg = JAlgorithmConfig(num_env_runners=2, num_envs_per_runner=4,
                            rollout_fragment_length=8, hidden=HIDDEN,
                            seed=1, lr=1e-3, entropy_coeff=0.01)
    jalgo = JIMPALA.__new__(JIMPALA)   # its loss, without its actors
    jalgo.config, jalgo.spec = jcfg, _jspec(algo.spec)
    jalgo.init_policy_params = lambda: jp
    jalgo.build_learner()
    jl = jalgo.learner
    jrunners = [JEnvRunner("CartPole-v1", 4, 8, seed=1 + 1000 * i)
                for i in range(2)]
    inflight = {0: jl.get_params(), 1: jl.get_params()}
    for it in range(2):
        metrics = []
        for i in (0, 1):
            frag = jrunners[i].sample(inflight.pop(i))
            inflight[i] = jl.get_params()
            metrics.append(jl.update_minibatch(frag))
        result = algo.train()
        _assert_tree_close(algo.get_params(), jl.get_params())
        assert result["env_steps_this_iter"] == 2 * 4 * 8
        want = float(np.mean([float(m["loss"]) for m in metrics]))
        assert abs(result["loss"] - want) < ATOL * max(1.0, abs(want))
    assert result["env_steps_total"] == 2 * 2 * 4 * 8
    algo.stop()


def test_save_restore_round_trip(tmp_path):
    cfg = _ppo_config(trl.PPOConfig)
    algo = cfg.build(device="cpu")
    algo.train()
    path = algo.save(str(tmp_path / "ckpt"))
    with open(os.path.join(path, "trainable.pkl"), "rb") as f:
        payload = pickle.load(f)
    assert payload["iteration"] == 1
    jtree = _np(jmodels.init_policy(jax.random.key(0), _jspec(algo.spec),
                                    HIDDEN))
    assert jax.tree_util.tree_structure(payload["data"]["params"]) \
        == jax.tree_util.tree_structure(jtree)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_equal(
        a.shape, b.shape), payload["data"]["params"], jtree)
    algo2 = trl.PPO.from_checkpoint(path, cfg, device="cpu")
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_numpy(algo2.get_params()),
                           params_to_numpy(algo.get_params()))
    assert algo2._iteration == 1
    assert algo2._env_steps_total == algo._env_steps_total
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           algo2._connector_state, algo._connector_state)
    assert algo2.train()["training_iteration"] == 2


def test_evaluate_leaves_training_state():
    algo = _ppo_config(trl.PPOConfig).build(device="cpu")
    for _ in range(2):
        algo.train()
    steps, window = algo._env_steps_total, list(algo._return_window)
    conn = algo._connector_state
    runner_globals = [r._connectors.get_globals() for r in algo.runners]
    out = algo.evaluate(num_episodes=3)
    assert out["episodes"] >= 3 and np.isfinite(out["episode_return_mean"])
    assert algo._env_steps_total == steps
    assert algo._return_window == window
    assert algo._connector_state is conn
    for r, g in zip(algo.runners, runner_globals):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               r._connectors.get_globals(), g)


def test_failing_runner_dropped_and_rebuilt():
    algo = _ppo_config(trl.PPOConfig).build(device="cpu")
    first = algo.runners[1]

    def boom(params):
        raise RuntimeError("runner lost")

    first.sample = boom
    result = algo.train()
    assert result["env_steps_this_iter"] == 64       # one fragment lost
    assert algo.runners[1] is not first                # rebuilt
    assert algo._restarts_left == [2, 1]
    assert algo.train()["env_steps_this_iter"] == 128
    for r in algo.runners:
        r.sample = boom
    with pytest.raises(RuntimeError, match="runner lost"):
        algo.train()
    # IMPALA drops the lost fragment and evicts a runner that keeps failing
    imp = trl.IMPALAConfig(num_envs_per_runner=2, rollout_fragment_length=4,
                           hidden=HIDDEN,
                           restart_failed_env_runners=False).build(
                               device="cpu")
    imp.runners[0].sample = boom
    for _ in range(3):
        assert imp.train()["env_steps_this_iter"] == 8
    assert 0 not in imp._inflight and imp._runner_failures[0] == 3


def test_run_train_and_tuned_example(tmp_path):
    out = io.StringIO()
    res = ttrain.run_train(
        "ppo", env="CartPole-v1",
        config_json='{"num_env_runners": 1, "num_envs_per_runner": 4, '
                    '"rollout_fragment_length": 16, "hidden": [8]}',
        stop_iters=2, checkpoint_dir=str(tmp_path / "ck"), out=out,
        device="cpu")
    assert res["training_iteration"] == 2 and "iter 2/2" in out.getvalue()
    ev = ttrain.run_evaluate(str(tmp_path / "ck"), episodes=1, out=out,
                             device="cpu")
    assert ev["episodes"] >= 1
    assert ttrain.list_tuned_examples() == [
        "cartpole-apex-dqn", "cartpole-dqn", "cartpole-dreamerv3",
        "cartpole-es", "cartpole-impala", "cartpole-pg", "cartpole-ppo",
        "connect4-lc0", "coordination-qmix", "masked-cartpole-r2d2",
        "pendulum-apex-ddpg", "pendulum-ddpg", "pendulum-mbmpo",
        "pendulum-sac", "pendulum-td3", "pointgoal-maml", "recsim-slateq",
        "spread-maddpg"]
    exp = ttrain.load_tuned_example("cartpole-pg")
    assert exp["run"] == "PG" and exp["stop"]["training_iteration"] == 40
    res = ttrain.run_tuned_example("cartpole-pg", stop_iters=1, out=out,
                                   device="cpu")
    assert res["env_steps_this_iter"] == 2 * 8 * 128
    assert res["training_iteration"] == 1
    with pytest.raises(ValueError, match="unknown algorithm"):
        ttrain.get_algorithm_config("NO_SUCH_ALGO")
    with pytest.raises(FileNotFoundError, match="bundled"):
        ttrain.load_tuned_example("no-such-example")


def test_refusals_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP item R"):
        trl.PPOConfig(num_learners=2, hidden=HIDDEN).build(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item R"):
        trl.A2CConfig(num_learners=1).build(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item R"):
        trl.PPOConfig(env="external://0").build(device="cpu")
    with pytest.raises(NotImplementedError, match="11c"):
        trl.Learner({"w": np.zeros(2, np.float32)}, None, 1e-3,
                    mesh=object(), device="cpu")


def test_other_algorithms_and_bench_run_on_cpu():
    """A2C, APPO and PPO on Pendulum take iterations with finite metrics
    (log_std moves); the fused-vs-host bench returns JAX's keys."""
    for cfg in (trl.A2CConfig(num_envs_per_runner=4,
                              rollout_fragment_length=8, hidden=HIDDEN),
                trl.APPOConfig(num_envs_per_runner=4,
                               rollout_fragment_length=8, hidden=HIDDEN),
                trl.PPOConfig(env="Pendulum-v1", num_envs_per_runner=4,
                              rollout_fragment_length=16, hidden=HIDDEN)):
        algo = cfg.build(device="cpu")
        before = tmodels.params_to_device(algo.get_params(), "cpu")
        before = {k: v.clone() for k, v in _leaves(before).items()}
        for _ in range(2):
            res = algo.train()
        assert all(np.isfinite(v) for k, v in res.items()
                   if isinstance(v, float) and k != "episode_return_mean")
        after = _leaves(algo.get_params())
        assert any(not torch.equal(after[k], before[k]) for k in before)
        if "log_std" in after:
            assert not torch.equal(after["log_std"], before["log_std"])
    res = tanakin.bench_fused_vs_host(num_envs=4, rollout_len=8, iters=2,
                                      warmup=1, device="cpu")
    assert {"fused_env_steps_per_s", "host_env_steps_per_s",
            "fused_vs_host_ratio", "fused_compile_count",
            "methodology"} <= res.keys()
    assert res["fused_compile_count"] == 1 and res["host_env_steps_per_s"] > 0
