"""ray_tpu_torch's pixel envs and contextual bandits against the JAX
package's, in one process.

Conventions in ``tests/_torch_rl_offpolicy.py``. The pixel envs, the
wrapper and the frame stack are numpy in both packages and are held bit
for bit over episodes with resets; one PPO iteration on ``CatchPixels-v0``
through the conv encoder is held to JAX's with sampling made
deterministic (argmax in both packages, as
``tests/test_torch_rl_algorithm.py`` does). The bandits are numpy on the
host in both packages: arms, ``A_inv``, ``b`` and regret bit for bit.
"""

import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rl_offpolicy import (ATOL, assert_tree_close, jax_algo, jspec,
                                 np_tree, one_thread)  # noqa: F401
from ray_tpu import rl as jrl
from ray_tpu.rl import models as jmodels
from ray_tpu.rl import pixel_env as jpix
from ray_tpu.rl.algorithms import bandits as jbandits
from ray_tpu.rl.algorithms.ppo import make_ppo_loss as jmake_ppo_loss
from ray_tpu.rl.config import AlgorithmConfig as JAlgorithmConfig
from ray_tpu.rl.env import EnvSpec as JEnvSpec
from ray_tpu.rl.env import make_env as jmake_env
from ray_tpu.rl.env_runner import EnvRunner as JEnvRunnerActor
from ray_tpu.rl.learner import Learner as JLearner
from ray_tpu_torch import rl as trl
from ray_tpu_torch.models.convert import policy_params_from_jax
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl import pixel_env as tpix
from ray_tpu_torch.rl import train as ttrain
from ray_tpu_torch.rl.algorithms import bandits as tbandits
from ray_tpu_torch.rl.env import EnvSpec
from ray_tpu_torch.rl.env import make_env as tmake_env

pytestmark = pytest.mark.usefixtures("one_thread")


def _step_both(jenv, tenv, actions):
    jo, jr, jd = jenv.step(actions)
    to, tr, td = tenv.step(actions)
    for got, want in ((to, jo), (tr, jr), (td, jd)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    return jd


# ---------------------------------------------------------------- pixels --

class _RGB:
    """A 3-channel uint8 pixel env from a seeded generator: every
    ``done_every`` steps all rows end (auto-reset to a fresh frame)."""

    def __init__(self, spec_cls, num_envs=3, hw=(8, 6), seed=0,
                 done_every=3):
        self.num_envs = num_envs
        self.spec = spec_cls(num_actions=2, obs_shape=(*hw, 3))
        self._rng = np.random.default_rng(seed)
        self._t, self._every = 0, done_every

    def _frame(self):
        shape = (self.num_envs, *self.spec.obs_shape)
        return self._rng.integers(0, 256, shape, dtype=np.uint8)

    def reset(self):
        return self._frame()

    def step(self, actions):
        self._t += 1
        dones = np.full(self.num_envs, self._t % self._every == 0)
        dones[0] = self._t % 2 == 0        # one row on its own clock
        return (self._frame(), self._rng.normal(size=self.num_envs)
                .astype(np.float32), dones)


@pytest.mark.parametrize("size", [5, 12])
def test_catch_pixels_bit_equal_over_episodes(size):
    jenv, tenv = jpix.CatchPixels(6, seed=3, size=size), \
        tpix.CatchPixels(6, seed=3, size=size)
    assert tenv.spec == EnvSpec(**vars(jenv.spec))
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    rng = np.random.default_rng(0)
    resets = 0
    for _ in range(3 * size):
        resets += int(_step_both(jenv, tenv, rng.integers(0, 3, 6)).sum())
    assert resets >= 12        # several episodes ended on every row


@pytest.mark.parametrize("skip,factor", [(1, 1), (2, 2), (3, 2)])
def test_pixel_wrapper_bit_equal(skip, factor):
    """Frame-skip with the flicker max-pool (never across an auto-reset),
    grayscale of uint8 RGB scaled by dtype, area resize."""
    jenv = jpix.PixelWrapper(_RGB(JEnvSpec), frame_skip=skip,
                             resize_factor=factor)
    tenv = tpix.PixelWrapper(_RGB(EnvSpec), frame_skip=skip,
                             resize_factor=factor)
    assert tenv.spec.obs_shape == jenv.spec.obs_shape == (
        8 // factor, 6 // factor, 1)
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    for _ in range(8):
        _step_both(jenv, tenv, np.zeros(3, np.int64))
    # catch through the wrapper: 1-channel frames, the max-pool across
    # frames of one episode and never into the next
    jenv = jpix.PixelWrapper(jpix.CatchPixels(4, seed=1, size=10),
                             frame_skip=skip)
    tenv = tpix.PixelWrapper(tpix.CatchPixels(4, seed=1, size=10),
                             frame_skip=skip)
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    rng = np.random.default_rng(1)
    for _ in range(20):
        _step_both(jenv, tenv, rng.integers(0, 3, 4))


def test_pixel_wrapper_rejections():
    with pytest.raises(ValueError, match="must divide"):
        tpix.PixelWrapper(tpix.CatchPixels(2, size=9), resize_factor=2)
    with pytest.raises(ValueError, match="grayscale"):
        tpix.PixelWrapper(tpix.FrameStack(tpix.CatchPixels(2, size=8), 4))
    with pytest.raises(AssertionError, match="pixel env"):
        tpix.PixelWrapper(tmake_env("CartPole-v1", 2))


@pytest.mark.parametrize("inner", ["catch", "rgb"])
def test_frame_stack_bit_equal_with_resets(inner):
    """Frame-major stacking (concatenate, not repeat: for C = 3 a repeat
    would interleave channels), reset rows restarted from the post-reset
    frame."""
    if inner == "catch":
        jenv = jpix.FrameStack(jpix.CatchPixels(3, seed=2, size=6), 3)
        tenv = tpix.FrameStack(tpix.CatchPixels(3, seed=2, size=6), 3)
    else:
        jenv = jpix.FrameStack(_RGB(JEnvSpec), 4)
        tenv = tpix.FrameStack(_RGB(EnvSpec), 4)
    assert tenv.spec.obs_shape == jenv.spec.obs_shape
    first = tenv.reset()
    np.testing.assert_array_equal(first, jenv.reset())
    c = first.shape[-1] // (3 if inner == "catch" else 4)
    np.testing.assert_array_equal(first[..., :c], first[..., -c:])
    rng = np.random.default_rng(4)
    for _ in range(14):
        _step_both(jenv, tenv, rng.integers(0, 2, 3))


def test_registered_env_and_gym_adapter(monkeypatch):
    for cfg in ({}, {"size": 10, "frame_stack": 2}):
        jenv = jmake_env("CatchPixels-v0", 4, cfg, seed=7)
        tenv = tmake_env("CatchPixels-v0", 4, cfg, seed=7)
        assert type(tenv).__name__ == type(jenv).__name__
        np.testing.assert_array_equal(tenv.reset(), jenv.reset())
        for _ in range(12):
            _step_both(jenv, tenv, np.ones(4, np.int64))
    # without gymnasium the adapter says what it needs, as JAX's does
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    for pkg in (jrl, trl):
        with pytest.raises(ImportError, match="requires gymnasium"):
            pkg.gym_vector_env("ALE/Pong-v5", 2)


@pytest.fixture
def greedy(monkeypatch):
    """Deterministic sampling in both packages."""
    monkeypatch.setattr(jmodels, "categorical_sample",
                        lambda key, logits: jnp.argmax(logits, axis=-1))
    monkeypatch.setattr(tmodels, "categorical_sample",
                        lambda gen, logits: torch.argmax(logits, dim=-1))


def test_ppo_iteration_on_catch_pixels_matches_jax(greedy):
    """One PPO iteration through the conv encoder: JAX's runner and
    Learner driven by hand from the port's config, params carried. Each
    of the 4 Adam steps takes the whole 40-row batch: on a 20-row
    minibatch the policy bias's gradient nearly cancels (the advantages
    are normalised over it), and Adam's step on a near-zero gradient
    turns fp32 rounding of the two convolutions into up to 3.6e-4 of the
    bias's max, in either package against the other."""
    kw = dict(env="CatchPixels-v0", env_config={"size": 9},
              num_env_runners=1, num_envs_per_runner=4,
              rollout_fragment_length=10, minibatch_size=40, num_epochs=4,
              seed=5)
    algo = trl.PPOConfig(**kw).build(device="cpu")
    assert algo.spec.is_pixel and "enc" in algo.get_params()
    jp = jmodels.init_policy(jax.random.key(1), jspec(algo.spec),
                             algo.config.hidden)
    algo.set_params(policy_params_from_jax(np_tree(jp), algo.spec,
                                           algo.config.hidden,
                                           device="cpu"))
    jcfg = JAlgorithmConfig(**kw)
    runner = JEnvRunnerActor._cls("CatchPixels-v0", 4, 10, jcfg.gamma,
                                  jcfg.lambda_, seed=jcfg.seed,
                                  env_config=jcfg.env_config)
    jl = JLearner(jp, jmake_ppo_loss(jspec(algo.spec), jcfg.clip_param,
                                     jcfg.vf_coeff, jcfg.entropy_coeff),
                  jcfg.lr, grad_clip=jcfg.grad_clip, seed=jcfg.seed)
    batch = runner.sample(jl.get_params())
    batch = {k: v for k, v in batch.items() if k != "last_values"}
    jm = jl.update(batch, num_epochs=4, minibatch_size=40, seed=jcfg.seed)
    result = algo.train()
    assert result["env_steps_total"] == 40
    assert abs(result["loss"] - jm["loss"]) < ATOL * max(1.0,
                                                        abs(jm["loss"]))
    assert_tree_close(algo.get_params(), jl.get_params())


def test_gate_spread_tool_repeats_on_the_cpu(capsys):
    """The gate-spread tool (run on the card to measure how the pixel
    gate's first crossing spreads) on the CPU for two iterations: one
    line per run, and two runs of one seed repeat."""
    import json

    from ray_tpu_torch.tools import rl_gate_spread

    assert rl_gate_spread.main(["--device", "cpu", "--iterations", "2",
                                "--runs", "3:0", "3:0"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"device": "cpu"} and len(lines) == 4
    assert [r["seed"] for r in lines[1:3]] == [3, 3]
    assert len(lines[1]["returns"]) == 2
    assert lines[-1] == {"repeated": {"3:0": True}}


# --------------------------------------------------------------- bandits --

def test_linear_bandit_env_bit_equal():
    jenv = jmake_env("LinearBandit-v0", 5, {"context_dim": 3,
                                            "num_arms": 4}, seed=2)
    tenv = tmake_env("LinearBandit-v0", 5, {"context_dim": 3,
                                            "num_arms": 4}, seed=2)
    assert isinstance(tenv, trl.algorithms.LinearBanditEnv)
    np.testing.assert_array_equal(tenv.theta, jenv.theta)
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    rng = np.random.default_rng(0)
    for _ in range(4):
        ctx = tenv._ctx
        np.testing.assert_array_equal(tenv.best_mean_reward(ctx),
                                      jenv.best_mean_reward(ctx))
        _step_both(jenv, tenv, rng.integers(0, 4, 5))


BANDIT_KW = {"num_envs_per_runner": 6, "steps_per_iter": 3,
             "env_config": {"context_dim": 4, "num_arms": 3}, "seed": 4}


@pytest.mark.parametrize("run", ["BANDITLINUCB", "BANDITLINTS"])
def test_bandit_iterations_bit_equal(run, tmp_path):
    from ray_tpu.rl import train as jtrain

    cfg = ttrain.get_algorithm_config(run).training(**BANDIT_KW)
    jcfg = jtrain.get_algorithm_config(run).training(**BANDIT_KW)
    assert cfg.algo_class.__name__ == jcfg.algo_class.__name__ == {
        "BANDITLINUCB": "BanditLinUCB", "BANDITLINTS": "BanditLinTS"}[run]
    algo = cfg.build(device="cpu")
    jalgo = jax_algo(jcfg.algo_class, jcfg, algo.spec)
    for _ in range(3):
        got, want = algo.train(), jalgo.training_step()
        for k, v in want.items():
            assert got[k] == v, k
    np.testing.assert_array_equal(algo._A_inv, jalgo._A_inv)
    np.testing.assert_array_equal(algo._b, jalgo._b)
    np.testing.assert_array_equal(algo._theta_hat(), jalgo._theta_hat())
    assert algo.evaluate(2) == jalgo.evaluate(2)
    # checkpoint: the float64 statistics as they are
    path = algo.save(str(tmp_path / run))
    again = cfg.build(device="cpu")
    again.restore(path)
    assert again._A_inv.dtype == np.float64
    np.testing.assert_array_equal(again._A_inv, algo._A_inv)
    np.testing.assert_array_equal(again._b, algo._b)
    assert again._env_steps_total == algo._env_steps_total


def test_bandit_rejections_and_defaults():
    with pytest.raises(ValueError, match="discrete arms over flat"):
        ttrain.get_algorithm_config("BANDITLINUCB").training(
            env="Pendulum-v1").build(device="cpu")
    cfg = tbandits.BanditLinTS.get_default_config()
    assert cfg.algo_class is tbandits.BanditLinTS
    assert vars(cfg).keys() == vars(
        jbandits.BanditLinTS.get_default_config()).keys()
    assert jrl.BanditConfig().env == trl.BanditConfig().env \
        == "LinearBandit-v0"


def test_run_train_builds_each_bandit():
    out = io.StringIO()
    res = ttrain.run_train("bandit_lin_ts", config_json='{"steps_per_iter":'
                           ' 2}', stop_iters=2, out=out, device="cpu")
    assert res["training_iteration"] == 2 and "regret_per_step" in res
