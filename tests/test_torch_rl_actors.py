"""RL on the port's actors (``ray_tpu_torch/rl/algorithm.py``): runner,
worker and learner actors against JAX's runners and learners driven by
hand, and against the port's one-process algorithms.

CPU, float32. Sampling is greedy in both packages (the argmax and the
mean): in this process through the ``greedy`` fixture (the local
backend's actors are threads here), in a worker process through
``_torch_actor_cases.GreedyRunner``, which the tests put in place of the
algorithm's ``EnvRunner``. PPO with a ``LearnerGroup`` of two and A2C
with one, on the local and the cluster backend, against JAX's runners
(``EnvRunner._cls``) and JAX's ``LearnerGroup`` on JAX's local backend:
params within 1e-4 of the reference's max |value| per leaf, losses
within 1e-5 (tests/test_long_context.py:34, :57), CartPole's columns and
the fleet's connector state exact. IMPALA with one runner actor against
JAX's by hand (one runner: ``wait`` order is fixed). ES, ARS and LC0 on
worker actors equal the one-process iterations (held against JAX in
tests/test_torch_rl_es.py and test_torch_rl_alphazero.py). A killed
runner's fragment is dropped, its actor restarts and serves the next
iteration; save, restore and ``stop()``; the external runner as an
actor. One port cluster for the module.
"""

import dataclasses
import os
import threading

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_actor_cases as cases
import ray_tpu
import ray_tpu_torch as rt
from ray_tpu.rl import learner as jlearner
from ray_tpu.rl import models as jmodels
from ray_tpu.rl.algorithms.a2c import make_a2c_loss as jmake_a2c_loss
from ray_tpu.rl.algorithms.impala import IMPALA as JIMPALA
from ray_tpu.rl.algorithms.ppo import make_ppo_loss as jmake_ppo_loss
from ray_tpu.rl.config import AlgorithmConfig as JAlgorithmConfig
from ray_tpu.rl.connectors import build_connectors as jbuild_connectors
from ray_tpu.rl.env import EnvSpec as JEnvSpec
from ray_tpu.rl.env_runner import EnvRunner as JEnvRunnerActor
from ray_tpu_torch import rl as trl
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.parallel.train_step import _leaves
from ray_tpu_torch.rl import algorithm as talgorithm
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl.env import CartPole, make_env
from ray_tpu_torch.rl.policy_server import PolicyClient

JEnvRunner = JEnvRunnerActor._cls
ATOL, REL = 1e-5, 1e-4
HIDDEN = (16, 16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here and in every worker the runtime spawns (the
    workers inherit the environment): one summation order on both sides,
    so a gradient near zero keeps its sign in Adam's first steps."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    env_before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    cloudpickle.register_pickle_by_value(cases)
    yield
    if rt.is_initialized():
        rt.shutdown()
    cloudpickle.unregister_pickle_by_value(cases)
    if env_before is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env_before
    torch.set_num_threads(before)


def _runtime(backend: str) -> None:
    """The port's runtime on ``backend``: the module's cluster is kept
    up from one test to the next; the local backend is started anew."""
    if backend == "cluster" and rt.global_worker().mode == "driver":
        return
    if rt.is_initialized():
        rt.shutdown()
    if backend == "local":
        rt.init(local_mode=True, num_cpus=8)
    else:
        rt.init(num_cpus=8, num_gpus=0)


@pytest.fixture
def greedy(monkeypatch):
    """Deterministic sampling in both packages, in this process."""
    monkeypatch.setattr(jmodels, "categorical_sample",
                        lambda key, logits: jnp.argmax(logits, axis=-1))
    monkeypatch.setattr(jmodels, "gaussian_sample",
                        lambda key, mean, log_std: mean)
    monkeypatch.setattr(tmodels, "categorical_sample",
                        lambda gen, logits: torch.argmax(logits, dim=-1))
    monkeypatch.setattr(tmodels, "gaussian_sample",
                        lambda gen, mean, log_std: mean)


def _runner_class(monkeypatch, backend, cls=None):
    """The algorithm's runner class for ``backend``: greedy in a worker
    process; on the local backend the ``greedy`` fixture does it."""
    cls = cls or (cases.GreedyRunner if backend == "cluster"
                  else cases.ConnRunner)
    monkeypatch.setattr(talgorithm, "EnvRunner", cls)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _assert_tree_close(got, want, rel=REL):
    got = {k: np.asarray(v) for k, v in _leaves(params_to_numpy(got)).items()}
    want = {k: np.asarray(v) for k, v in _leaves(_np(want)).items()}
    assert got.keys() == want.keys()
    for name in want:
        assert _rel(got[name], want[name]) < rel, name


def _jspec(spec):
    return JEnvSpec(**dataclasses.asdict(spec))


ON_POLICY = {
    # name: (port config, learners, JAX loss, JAX update kwargs by iteration)
    "ppo": (trl.PPOConfig, 2,
            lambda spec, c: jmake_ppo_loss(spec, c.clip_param, c.vf_coeff,
                                           c.entropy_coeff),
            lambda c, i: dict(num_epochs=c.num_epochs,
                              minibatch_size=c.minibatch_size,
                              seed=c.seed + i)),
    "a2c": (trl.A2CConfig, 1,
            lambda spec, c: jmake_a2c_loss(spec, c.vf_coeff,
                                           c.entropy_coeff),
            lambda c, i: dict(num_epochs=1,
                              minibatch_size=c.minibatch_size or 0)),
}


def _on_policy_config(mod_cfg, learners):
    cfg = mod_cfg(num_env_runners=2, num_envs_per_runner=4,
                  rollout_fragment_length=16, minibatch_size=16,
                  hidden=HIDDEN, seed=3, connectors=["mean_std_filter"])
    cfg.num_epochs = 2 if learners == 2 else 1
    cfg.num_learners = learners
    return cfg


_JAX_RUNS = {}


def _jax_run(name, spec, jp):
    """JAX's two iterations by hand, once per algorithm: runners (seeds
    cfg.seed + 1000 i), the connector sync, the concatenation and JAX's
    LearnerGroup on its local backend. Returns each iteration's (params,
    loss, env steps so far), the merged connector state and a runner's
    connector globals."""
    if name in _JAX_RUNS:
        return _JAX_RUNS[name]
    _, learners, jloss_fn, jupdate = ON_POLICY[name]
    jcfg = _on_policy_config(JAlgorithmConfig, learners)
    jcfg.entropy_coeff = ON_POLICY[name][0]().entropy_coeff
    jrunners = [JEnvRunner("CartPole-v1", 4, 16, jcfg.gamma, jcfg.lambda_,
                           seed=jcfg.seed + 1000 * i,
                           connectors=jcfg.connectors) for i in range(2)]
    loss = jloss_fn(spec, jcfg)
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(local_mode=True, num_cpus=4)
    try:
        jgroup = jlearner.LearnerGroup(
            lambda: jlearner.Learner(jp, loss, jcfg.lr,
                                     grad_clip=jcfg.grad_clip,
                                     seed=jcfg.seed), learners)
        merger = jbuild_connectors(jcfg.connectors, 4)
        state, steps, iters = None, 0, []
        for i in range(2):
            frags = [r.sample(jgroup.get_params()) for r in jrunners]
            state = merger.merge_deltas(
                state, [r.pop_connector_deltas() for r in jrunners])
            for r in jrunners:
                r.set_connector_globals(state)
            batch = {k: np.concatenate([f[k] for f in frags])
                     for k in frags[0] if k != "last_values"}
            steps += len(batch["rewards"])
            jm = jgroup.update(batch, **jupdate(jcfg, i))
            iters.append((_np(jgroup.get_params()), jm["loss"], steps))
    finally:
        ray_tpu.shutdown()
    _JAX_RUNS[name] = (iters, state, jrunners[0]._connectors.get_globals())
    return _JAX_RUNS[name]


@pytest.mark.parametrize("backend", ["local", "cluster"])
@pytest.mark.parametrize("name", ["ppo", "a2c"])
def test_on_policy_with_learner_group_matches_jax(greedy, monkeypatch,
                                                  backend, name):
    """Two iterations: runner actors sample, the connector state merges
    and goes back to the runners, the LearnerGroup updates."""
    mod_cfg, learners, _, _ = ON_POLICY[name]
    _runner_class(monkeypatch, backend)
    spec = _jspec(make_env("CartPole-v1", 1).spec)
    jp = jmodels.init_policy(jax.random.key(2), spec, HIDDEN)
    iters, state, runner_globals = _jax_run(name, spec, jp)
    _runtime(backend)
    algo = _on_policy_config(mod_cfg, learners).build(device="cpu")
    assert all(isinstance(r, rt.ActorHandle) for r in algo.runners)
    assert isinstance(algo.learner, trl.LearnerGroup)
    algo.set_params(_np(jp))
    for i, (jparams, jloss, steps) in enumerate(iters):
        result = algo.train()
        _assert_tree_close(algo.get_params(), jparams)
        assert result["env_steps_total"] == steps
        assert result["training_iteration"] == i + 1
        assert abs(result["loss"] - jloss) < ATOL * max(1.0, abs(jloss))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           algo._connector_state, state)
    for got in rt.get([r.connector_globals.remote() for r in algo.runners]):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                               runner_globals)
    algo.stop()


def test_impala_one_runner_actor_matches_jax(greedy, monkeypatch):
    """One runner in flight: the fragment consumed each step was sampled
    with the params before the previous update, as in JAX's pipeline."""
    _runner_class(monkeypatch, "cluster")
    _runtime("cluster")
    cfg = trl.IMPALAConfig(num_envs_per_runner=4, rollout_fragment_length=8,
                           hidden=HIDDEN, seed=1, lr=1e-3)
    cfg.num_env_runners = 1      # IMPALAConfig sets 2 after its kwargs
    algo = cfg.build(device="cpu")
    assert len(algo.runners) == 1
    jp = jmodels.init_policy(jax.random.key(4), _jspec(algo.spec), HIDDEN)
    algo.set_params(_np(jp))
    jcfg = JAlgorithmConfig(num_env_runners=1, num_envs_per_runner=4,
                            rollout_fragment_length=8, hidden=HIDDEN,
                            seed=1, lr=1e-3, entropy_coeff=0.01)
    jalgo = JIMPALA.__new__(JIMPALA)   # its loss, without its actors
    jalgo.config, jalgo.spec = jcfg, _jspec(algo.spec)
    jalgo.init_policy_params = lambda: jp
    jalgo.build_learner()
    jl = jalgo.learner
    jrunner = JEnvRunner("CartPole-v1", 4, 8, seed=1)
    inflight = jl.get_params()
    for it in range(3):
        frag = jrunner.sample(inflight)
        inflight = jl.get_params()
        m = jl.update_minibatch(frag)
        result = algo.train()
        _assert_tree_close(algo.get_params(), jl.get_params())
        assert result["env_steps_this_iter"] == 4 * 8
        assert abs(result["loss"] - float(m["loss"])) < ATOL * max(
            1.0, abs(float(m["loss"])))
    algo.stop()


def _search_population_runs():
    """ES and ARS two iterations, LC0 one: (ES center, ARS center and
    filter, LC0 params, their metrics)."""
    # an XConfig sets its own defaults after its kwargs: .training() after
    es = trl.ESConfig().training(
        num_env_runners=2, num_perturbations=4, hidden=(8,),
        max_episode_len=40, seed=5).build(device="cpu")
    ars = trl.ARSConfig().training(
        num_env_runners=2, num_perturbations=4, top_directions=2,
        hidden=(8,), max_episode_len=40, seed=6).build(device="cpu")
    lc0 = trl.LeelaChessZeroConfig().training(
        num_workers=2, games_per_iter=2, num_simulations=4, hidden=(16, 16),
        minibatch_size=32, updates_per_iter=2, seed=7).build(device="cpu")
    try:
        metrics = [es.train(), es.train(), ars.train(), ars.train(),
                   lc0.train()]
        return (es._center.copy(), ars._center.copy(), ars._f_sum.copy(),
                params_to_numpy(lc0.learner.get_params()), metrics,
                [type(w) for w in (es._workers + ars._workers
                                   + lc0.workers)])
    finally:
        for a in (es, ars, lc0):
            a.stop()


def test_es_ars_lc0_on_worker_actors_equal_one_process():
    if rt.is_initialized():
        rt.shutdown()
    want = _search_population_runs()
    assert not any(t is rt.ActorHandle for t in want[5])
    _runtime("cluster")
    got = _search_population_runs()
    assert all(t is rt.ActorHandle for t in got[5])
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got[3], want[3])
    for m_got, m_want in zip(got[4], want[4]):
        for k in ("mean_return", "best_return", "loss", "draw_rate"):
            if k in m_want:
                assert m_got[k] == m_want[k], k


def test_killed_runner_checkpoint_restore_and_stop(tmp_path, monkeypatch):
    """A runner whose process dies mid-sample loses its fragment; its
    actor restarts (max_env_runner_restarts) and serves the next
    iteration from a new process. Save and restore under the runtime:
    params, counters and the connector state come back, and the restore
    broadcasts the state to the runner actors. ``stop()`` kills the
    runner and learner actors."""
    _runner_class(monkeypatch, "cluster", cases.FlakyRunner)
    _runtime("cluster")
    cfg = trl.PPOConfig(num_env_runners=2, num_envs_per_runner=2,
                        rollout_fragment_length=8, hidden=HIDDEN,
                        minibatch_size=16, num_epochs=1, num_learners=1,
                        connectors=["mean_std_filter"])
    algo = cfg.build(device="cpu")
    pids = rt.get([r.get_pid.remote() for r in algo.runners])
    rt.get(algo.runners[1].arm_crash.remote())
    assert algo.train()["env_steps_this_iter"] == 16   # one fragment lost
    assert algo.train()["env_steps_this_iter"] == 32
    new = rt.get([r.get_pid.remote() for r in algo.runners])
    assert new[0] == pids[0] and new[1] != pids[1]

    path = algo.save(str(tmp_path / "ckpt"))
    saved = params_to_numpy(algo.get_params())
    saved_conn = algo._connector_state
    algo.train()                       # moves params, steps and filters
    algo.restore(path)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_numpy(algo.get_params()), saved)
    assert algo._env_steps_total == 48 and algo._iteration == 2
    for got in rt.get([r.connector_globals.remote() for r in algo.runners]):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                               saved_conn)
    calls = [(r, "get_pid") for r in algo.runners] + \
        [(a, "ping") for a in algo.learner.actors]
    algo.stop()
    for actor, method in calls:
        with pytest.raises(rt.exceptions.RayTpuError):
            rt.get(getattr(actor, method).remote(), timeout=60)


def test_external_runner_is_an_actor():
    """PPO on ``external://0``: the policy server runs in the runner
    actor's process; a simulator thread here drives it over HTTP."""
    _runtime("cluster")
    cfg = trl.PPOConfig()
    cfg.env = "external://0"
    cfg.env_config = {"spec": {"obs_dim": 4, "num_actions": 2}}
    cfg.env_runners(num_env_runners=1, num_envs_per_runner=1,
                    rollout_fragment_length=32)
    cfg.num_epochs, cfg.minibatch_size, cfg.hidden = 1, 32, HIDDEN
    algo = cfg.build(device="cpu")
    assert isinstance(algo.runners[0], rt.ActorHandle)
    port = algo.server_ports[0]
    stop = threading.Event()

    def simulator():
        client = PolicyClient(f"http://127.0.0.1:{port}")
        env = CartPole(1, seed=3)
        while not stop.is_set():
            eid = client.start_episode()
            obs = env.reset()
            for _ in range(100):
                a = client.get_action(eid, obs[0])
                obs, r, d = env.step(np.array([a]))
                client.log_returns(eid, float(r[0]))
                if d[0] or stop.is_set():
                    break
            client.end_episode(eid)

    t = threading.Thread(target=simulator, daemon=True)
    t.start()
    try:
        result = algo.train()
    finally:
        stop.set()
        t.join(timeout=30)
    assert result["env_steps_this_iter"] >= 32
    assert np.isfinite(result["loss"])
    algo.stop()
