"""ray_tpu_torch's numpy envs, connectors, GAE and AlgorithmConfig against
the JAX package's.

All of these are numpy or plain Python on both sides, so they are held to
equality: the envs step bit for bit alike for the same seed and actions,
the connectors give the same arrays and states on the same streams, GAE
the same advantages, and the configs the same fields after the same
builder calls (refusals included).
"""

import dataclasses

import numpy as np
import pytest

from ray_tpu.rl import config as jconfig
from ray_tpu.rl import connectors as jconn
from ray_tpu.rl import env as jenv
from ray_tpu.rl.algorithms.a2c import A2CConfig as JA2CConfig
from ray_tpu.rl.algorithms.appo import APPOConfig as JAPPOConfig
from ray_tpu.rl.algorithms.impala import IMPALAConfig as JIMPALAConfig
from ray_tpu.rl.algorithms.pg import PGConfig as JPGConfig
from ray_tpu.rl.algorithms.ppo import PPOConfig as JPPOConfig
from ray_tpu.rl.env_runner import compute_gae as jcompute_gae
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import config as tconfig
from ray_tpu_torch.rl import connectors as tconn
from ray_tpu_torch.rl import env as tenv
from ray_tpu_torch.rl.env_runner import compute_gae as tcompute_gae


def _assert_same(a, b):
    """Equal nested states: dicts, lists, arrays, floats, None."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,n,steps", [("CartPole-v1", 16, 700),
                                          ("Pendulum-v1", 8, 450)])
def test_env_steps_bit_for_bit(name, n, steps):
    """700 CartPole steps pass the 500-step limit and many falls; 450
    Pendulum steps pass its 200-step episodes twice."""
    rng = np.random.default_rng(3)
    j, t = jenv.make_env(name, n, seed=7), tenv.make_env(name, n, seed=7)
    assert dataclasses.asdict(j.spec) == dataclasses.asdict(t.spec)
    np.testing.assert_array_equal(j.reset(), t.reset())
    dones_seen = 0
    for _ in range(steps):
        if name == "CartPole-v1":
            acts = rng.integers(0, 2, n)
        else:
            acts = rng.uniform(-3.0, 3.0, (n, 1)).astype(np.float32)
        jo, jr, jd = j.step(acts)
        to, tr, td = t.step(acts)
        np.testing.assert_array_equal(jo, to)
        np.testing.assert_array_equal(jr, tr)
        np.testing.assert_array_equal(jd, td)
        assert jo.dtype == to.dtype and jr.dtype == tr.dtype
        dones_seen += int(td.sum())
    assert dones_seen > n


def test_make_env_unknown_and_registered():
    for mod in (jenv, tenv):
        with pytest.raises(KeyError, match="register it"):
            mod.make_env("NoSuchEnv-v0", 2)

    class Trivial(tenv.VectorEnv):
        def __init__(self, cfg):
            self.num_envs = cfg["num_envs"]
            self.seed = cfg["seed"]
            self.extra = cfg["extra"]
            self.spec = tenv.EnvSpec(obs_dim=2, num_actions=2)

    tenv.register_env("TrivialTorch-v0", Trivial)
    env = trl.make_env("TrivialTorch-v0", 3, {"extra": 5}, seed=9)
    assert (env.num_envs, env.seed, env.extra) == (3, 9, 5)


def _obs_stream(seed, n=5, steps=7, dim=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(2.0, 3.0, (n, dim)).astype(np.float32)
            for _ in range(steps)]


def test_connectors_equal_on_same_streams():
    """Two runners' pipelines (obs filter, obs clip, reward clip) on their
    own streams, the deltas merged by a third pipeline and broadcast, as
    the algorithm syncs them; every output and state equal to JAX's."""
    specs = ["mean_std_filter", {"type": "clip_obs", "limit": 1.5},
             {"type": "clip_reward", "limit": 0.5}]
    pipes = {}
    for name, mod in (("jax", jconn), ("torch", tconn)):
        pipes[name] = ([mod.build_connectors(specs, 3) for _ in range(2)],
                       mod.build_connectors(specs, 3))
    state = {"jax": None, "torch": None}
    rng = np.random.default_rng(1)
    for it in range(3):
        streams = [_obs_stream(10 * it + r) for r in range(2)]
        rewards = rng.normal(0, 2, (7, 5)).astype(np.float32)
        outs = {}
        for name, (runners, merger) in pipes.items():
            got = []
            for r, stream in zip(runners, streams):
                for k, obs in enumerate(stream):
                    got.append(r.on_obs(obs))
                    got.append(r.on_obs(obs * 2, update=False))
                    got.append(r.on_reward(rewards[k]))
            deltas = [r.pop_deltas() for r in runners]
            state[name] = merger.merge_deltas(state[name], deltas)
            for r in runners:
                r.set_globals(state[name])
            got.append(runners[0].get_globals())
            outs[name] = got
        _assert_same(outs["jax"], outs["torch"])
        _assert_same(state["jax"], state["torch"])
    for name, mod in (("jax", jconn), ("torch", tconn)):
        sign = mod.build_connectors([{"type": "clip_reward", "sign": True}],
                                    3)
        outs[name] = sign.on_reward(np.array([-2.0, 0.0, 0.3], np.float32))
        with pytest.raises(ValueError, match="unknown connector"):
            mod.build_connectors(["no_such_connector"], 3)
        assert mod.build_connectors(None, 3) is None
        # a reset to pristine statistics
        p = mod.build_connectors(["mean_std_filter"], 3)
        p.set_globals(None)
        outs[name + "_pristine"] = p.get_globals()
    _assert_same(outs["jax"], outs["torch"])
    _assert_same(outs["jax_pristine"], outs["torch_pristine"])


@pytest.mark.parametrize("pattern", ["none", "random", "all", "last_row"])
def test_compute_gae_equal_on_done_patterns(pattern):
    rng = np.random.default_rng(5)
    T, N = 12, 6
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    last = rng.normal(size=N).astype(np.float32)
    dones = {"none": np.zeros((T, N), bool),
             "random": rng.random((T, N)) < 0.3,
             "all": np.ones((T, N), bool),
             "last_row": np.eye(T, N, k=0, dtype=bool)[::-1]}[pattern]
    want = jcompute_gae(rewards, values, dones, last, 0.97, 0.9)
    got = tcompute_gae(rewards, values, dones, last, 0.97, 0.9)
    for k in ("advantages", "value_targets"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "algo_class"}


def test_algorithm_config_builders_equal():
    """The same builder chain and dict on both sides gives the same
    fields; ``lambda`` maps to ``lambda_``; an unknown key and a config
    without an algorithm are refused alike."""
    assert [f.name for f in dataclasses.fields(jconfig.AlgorithmConfig)] \
        == [f.name for f in dataclasses.fields(tconfig.AlgorithmConfig)]
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = (mod.AlgorithmConfig()
               .environment("Pendulum-v1", {"k": 1})
               .env_runners(num_env_runners=3, num_envs_per_runner=5,
                            rollout_fragment_length=20,
                            num_cpus_per_runner=0.4,
                            connectors=["mean_std_filter"],
                            runner_runtime_env={"env_vars": {}})
               .training(lr=1e-3, **{"lambda": 0.9}, clip_param=0.3)
               .resources(num_tpus_per_learner=1, num_learners=0)
               .debugging(seed=11)
               .multi_agent(policy_mapping_fn=None))
        cfg.update_from_dict({"num_epochs": 7, "hidden": (8,)})
        assert cfg.effective_train_batch_size == 3 * 5 * 20
        cfg2 = cfg.copy()
        cfg2.train_batch_size = 77
        assert cfg2.effective_train_batch_size == 77
        assert cfg.train_batch_size == 0
        with pytest.raises(ValueError, match="unknown config key"):
            cfg.update_from_dict({"no_such_key": 1})
        with pytest.raises(ValueError, match="no algo_class"):
            mod.AlgorithmConfig().build()
        cfgs.append(_fields(cfg))
    assert cfgs[0] == cfgs[1]
    assert cfgs[1]["lambda_"] == 0.9
    assert tconfig.AlgorithmConfig(num_env_runners=0) \
        .effective_train_batch_size == 8 * 64


@pytest.mark.parametrize("pair", [
    (JPPOConfig, trl.PPOConfig), (JPGConfig, trl.PGConfig),
    (JA2CConfig, trl.A2CConfig), (JIMPALAConfig, trl.IMPALAConfig),
    (JAPPOConfig, trl.APPOConfig)], ids=lambda p: p[1].__name__)
def test_algorithm_config_defaults_equal(pair):
    jcls, tcls = pair
    assert _fields(jcls()) == _fields(tcls())
    assert tcls().algo_class.__name__ == jcls().algo_class.__name__
    assert _fields(jcls().algo_class.get_default_config()) \
        == _fields(tcls().algo_class.get_default_config())
