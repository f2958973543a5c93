"""ray_tpu_torch's multi-agent RL (``rl/multi_agent.py``), its
``rl/evaluation.py`` and the ``models.gumbel`` draw under every
categorical sample, against the JAX package's, in one process.

Conventions in ``tests/_torch_rl_offpolicy.py``. The actions of an
independent-PPO iteration are JAX's: the port draws them through
``models.gumbel``, which these tests replace with a replay of JAX's key
chain (``JaxDraws.gumbel``: ``jax.random.categorical(key, logits)`` is
the argmax of ``logits + jax.random.gumbel(key, logits.shape)``).
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

from _torch_rl_offpolicy import (JaxDraws, assert_metrics_close,
                                 assert_tree_close, carry,
                                 one_thread, tree_equal)  # noqa: F401
from ray_tpu import rl as jrl
from ray_tpu.rl import evaluation as jeval
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import evaluation as teval
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl import train as ttrain

pytestmark = pytest.mark.usefixtures("one_thread")


def _ippo_config(pkg, **kw):
    cfg = pkg.AlgorithmConfig(algo_class=pkg.MultiAgentPPO)
    for k, v in {"env": "coordination", "num_envs_per_runner": 4,
                 "rollout_fragment_length": 8, "lr": 3e-3, "num_epochs": 2,
                 "minibatch_size": 16, "hidden": (16, 16), "seed": 2,
                 **kw}.items():
        setattr(cfg, k, v)
    return cfg


def test_categorical_sample_draws_are_unchanged():
    """``categorical_sample`` through ``gumbel`` picks what the seeded
    generator picked before the helper existed, bit for bit."""
    logits = torch.randn((64, 6), generator=torch.Generator().manual_seed(1))
    got = trl.models.categorical_sample(torch.Generator().manual_seed(5),
                                        logits)
    gen = torch.Generator().manual_seed(5)
    u = torch.rand(logits.shape, generator=gen).clamp_(
        min=torch.finfo(torch.float32).tiny)
    want = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    assert torch.equal(got, want)
    noise = trl.models.gumbel(torch.Generator().manual_seed(5), logits.shape)
    assert torch.equal(logits + noise,
                       logits - torch.log(-torch.log(u)))


@pytest.mark.parametrize("shape", [(16, 8, 8), (5, 3)])
def test_gumbel_replays_jax_categorical(monkeypatch, shape):
    """JAX's categorical draw through the port's ``categorical_sample``."""
    logits = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    keys = jax.random.split(jax.random.key(4), 6)
    draws = JaxDraws.of_keys(keys)
    draws.install(monkeypatch, tmodels, gumbel=True)
    for k in keys:
        want = np.asarray(jax.random.categorical(k, logits))
        got = tmodels.categorical_sample(torch.Generator(),
                                         torch.tensor(logits))
        np.testing.assert_array_equal(got.numpy(), want)
    assert draws.calls == 6


@pytest.mark.parametrize("name", ["coordination", "spread"])
def test_envs_bit_equal(name):
    kw = {"num_envs": 5, "seed": 3}
    jenv = {"coordination": jrl.CoordinationGame,
            "spread": jrl.SpreadGame}[name](**kw)
    tenv = {"coordination": trl.CoordinationGame,
            "spread": trl.SpreadGame}[name](**kw)
    assert jenv.agents == tenv.agents
    for a in jenv.agents:
        assert jenv.spec[a].__dict__ == tenv.spec[a].__dict__
    rng = np.random.default_rng(0)
    jo, to = jenv.reset(), tenv.reset()
    for _ in range(40):
        for a in jenv.agents:
            np.testing.assert_array_equal(to[a], jo[a])
        if name == "coordination":
            acts = {a: rng.integers(0, 3, 5) for a in jenv.agents}
        else:
            acts = {a: rng.uniform(-1.5, 1.5, (5, 2)).astype(np.float32)
                    for a in jenv.agents}
        jo, jr, jd = jenv.step(acts)
        to, tr, td = tenv.step(acts)
        np.testing.assert_array_equal(td, jd)
        for a in jenv.agents:
            np.testing.assert_array_equal(tr[a], jr[a])
            assert tr[a].dtype == jr[a].dtype


def test_register_multi_agent_env():
    from ray_tpu_torch.rl import multi_agent

    trl.register_multi_agent_env("coord5", lambda num_envs, **kw:
                                 trl.CoordinationGame(num_envs, k=5, **kw))
    try:
        env = multi_agent.make_multi_agent_env(
            _ippo_config(trl, env="coord5"))
        assert env.k == 5 and env.num_envs == 4
    finally:
        del multi_agent._MA_ENVS["coord5"]


def test_run_episodes_and_return_window_equal():
    rng = np.random.default_rng(1)
    script = [(rng.normal(size=4), rng.random(4) < 0.3) for _ in range(60)]

    def stepper():
        it = iter(script)
        return lambda: next(it)

    for n_eps in (3, 1000):
        want = jeval.run_episodes(stepper(), n_eps, 4, max_steps=50)
        got = teval.run_episodes(stepper(), n_eps, 4, max_steps=50)
        assert got == want or (np.isnan(got["episode_return_mean"])
                               and got["episodes"] == want["episodes"])
    jw, tw = jeval.ReturnWindow(4, size=7), teval.ReturnWindow(4, size=7)
    assert tw.mean() is None and jw.mean() is None
    for r, d in script:
        jw.add(r, d)
        tw.add(r, d)
        assert tw.mean() == jw.mean()


@pytest.mark.parametrize("mapping", ["identity", "shared"])
def test_ippo_iteration_matches_jax(monkeypatch, mapping):
    """One MultiAgentPPO iteration from JAX's params with JAX's action
    draws: the rollout, GAE, each policy's update and the metrics."""
    kw = ({"policy_mapping_fn": lambda a: "shared"} if mapping == "shared"
          else {})
    jalgo = _ippo_config(jrl, **kw).build()
    talgo = _ippo_config(trl, **kw).build(device="cpu")
    assert list(talgo.learners) == list(jalgo.learners)
    for pid, ln in talgo.learners.items():
        ln.set_params(carry(jalgo.learners[pid].get_params(), ln))
    JaxDraws(2 + 777, 0).install(monkeypatch, tmodels, gumbel=True)
    jm, tm = jalgo.train(), talgo.train()
    assert_metrics_close(tm, jm)
    for pid, ln in talgo.learners.items():
        assert_tree_close(ln.get_params(),
                          jalgo.learners[pid].get_params())
    if mapping == "shared":
        assert list(talgo.learners) == ["shared"]
        assert "shared/policy_loss" in tm


def test_ippo_checkpoint_roundtrip(tmp_path):
    algo = _ippo_config(trl).build(device="cpu")
    algo.train()
    algo.save(str(tmp_path))
    algo2 = _ippo_config(trl).build(device="cpu")
    algo2.restore(str(tmp_path))
    assert algo2._iteration == 1
    for pid in algo.learners:
        assert tree_equal(algo2.learners[pid].get_params(),
                          algo.learners[pid].get_params())


@pytest.mark.parametrize("name", ["MultiAgentPPO", "QMIX", "MADDPG", "MAML",
                                  "MBMPO", "DreamerV3"])
def test_entry_points_default_to_cuda(monkeypatch, name):
    """Without ``device`` every new trainable asks for cuda, and raises
    on a machine without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls = getattr(trl, name)
    cfg = (_ippo_config(trl) if name == "MultiAgentPPO"
           else cls.get_default_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.build()


@pytest.mark.parametrize("run,env,config", [
    ("QMIX", "coordination", {"learning_starts": 16, "updates_per_iter": 2,
                              "rollout_fragment_length": 4,
                              "num_envs_per_runner": 4, "hidden": [8],
                              "mixing_embed_dim": 4}),
    ("MADDPG", "spread", {"learning_starts": 16, "updates_per_iter": 2,
                          "rollout_fragment_length": 4, "minibatch_size": 8,
                          "num_envs_per_runner": 4, "hidden": [8, 8]}),
    ("MAML", "pointgoal", {"meta_batch_size": 2, "num_envs_per_runner": 4,
                           "horizon": 4, "hidden": [8]}),
    ("MBMPO", "Pendulum-v1", {"num_envs_per_runner": 4,
                              "real_steps_per_iter": 16, "ensemble_size": 2,
                              "model_hidden": [8], "model_epochs": 1,
                              "imag_horizon": 2, "imag_envs": 4,
                              "meta_steps_per_iter": 1, "hidden": [8]}),
    ("DREAMERV3", "CartPole-v1", {"num_envs_per_runner": 2,
                                  "rollout_fragment_length": 4,
                                  "learning_starts": 8, "updates_per_iter": 1,
                                  "batch_seqs": 2, "deter_dim": 8,
                                  "stoch_groups": 2, "stoch_classes": 2,
                                  "embed_dim": 8, "hidden": [8],
                                  "imag_horizon": 2})])
def test_run_train_and_evaluate_by_registry_name(tmp_path, run, env, config):
    """Each new algorithm trains from its registry name through
    ``run_train`` (each updates by its second iteration), saves, and
    ``run_evaluate`` rebuilds it from the checkpoint."""
    out = io.StringIO()
    res = ttrain.run_train(run, env=env, config_json=json.dumps(config),
                           stop_iters=2, checkpoint_dir=str(tmp_path),
                           out=out, device="cpu")
    assert res["training_iteration"] == 2 and "iter 2/2" in out.getvalue()
    ev = ttrain.run_evaluate(str(tmp_path), episodes=2, out=out,
                             device="cpu")
    assert all(np.isfinite(v) for v in ev.values())
