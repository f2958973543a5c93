"""ray_tpu_torch's ES and ARS against the JAX package's, in one process.

Conventions in ``tests/_torch_rl_offpolicy.py``. JAX's workers are
actors: they are built here in this process (``local_actors``), and
``ray_tpu.get`` in JAX's modules returns the values as they are, so no
cluster starts. Both packages start from JAX's flat center, draw the same
seeds and noise, and step CartPole with the same discrete actions, so an
iteration's returns, center and filter sums are held to equality.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_rl_offpolicy import (jax_algo, jspec, local_actors,
                                 one_thread)  # noqa: F401
from ray_tpu.rl import models as jmodels
from ray_tpu.rl.algorithms import ars as jars
from ray_tpu.rl.algorithms import es as jes
from ray_tpu_torch import rl as trl
from ray_tpu_torch.models.convert import policy_params_from_jax
from ray_tpu_torch.parallel.train_step import _leaves
from ray_tpu_torch.rl.algorithms import es as tes
from ray_tpu_torch.rl.env import EnvSpec

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def jax_workers(monkeypatch):
    local_actors(monkeypatch, jes, "_ESWorker")
    monkeypatch.setattr(jars, "ray_tpu", jes.ray_tpu)


SPECS = {"cartpole": EnvSpec(obs_dim=4, num_actions=2),
         "pendulum": EnvSpec(obs_dim=3, action_dim=1, action_low=-2.0,
                             action_high=2.0),
         "pixels": EnvSpec(num_actions=3, obs_shape=(9, 9, 2))}


@pytest.mark.parametrize("spec", list(SPECS), ids=list(SPECS))
def test_flatten_in_jax_leaf_order(spec):
    """The port's tree (``log_std`` last, ``enc`` first by insertion)
    flattens into JAX's ``tree_flatten`` order; unflatten rebuilds it."""
    spec = SPECS[spec]
    hidden = (8,) if spec.is_pixel else (8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 5)
    jp = jmodels.init_policy(jax.random.key(0), jspec(spec), hidden)
    tp = policy_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                spec, hidden, device="cpu")
    if not spec.discrete:
        assert list(tp)[-1] == "log_std"
    want, _ = jes._flatten(jp)
    got, meta = tes._flatten(tp)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # past ten layers a path sort would put layers/10 before layers/2
    paths = [p for p, _ in meta]
    assert paths == [p for p, _ in tes._sorted_leaves(tp)]
    back = tes._unflatten(got, meta, "cpu")
    lt, lb = _leaves(tp), _leaves(back)
    assert lt.keys() == lb.keys()
    for k in lt:
        assert lb[k].dtype == torch.float32 and torch.equal(lb[k], lt[k]), k


def test_noise_and_centered_ranks_equal():
    for seed, dim in ((0, 5), (2 ** 31 - 2, 97)):
        np.testing.assert_array_equal(tes._noise(seed, dim, 0.05),
                                      jes._noise(seed, dim, 0.05))
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=9), np.array([3.0]), np.array([1.0, 1.0])):
        np.testing.assert_array_equal(tes._centered_ranks(x),
                                      jes._centered_ranks(x))


ES_KW = {"num_env_runners": 2, "num_perturbations": 3,
         "episodes_per_perturbation": 1, "max_episode_len": 40,
         "hidden": (8,), "seed": 3}


def _pair(tcls, jcls, cfg_cls, jcfg_cls, **kw):
    cfg = cfg_cls().training(**{**ES_KW, **kw})
    algo = cfg.build(device="cpu")
    jcfg = jcfg_cls().training(**{**ES_KW, **kw})
    jalgo = jax_algo(jcls, jcfg, algo.spec)
    # both start from JAX's center (the port's init draws are its own)
    algo.set_params(jalgo.get_params())
    np.testing.assert_array_equal(algo._center, jalgo._center)
    return algo, jalgo


def test_es_iterations_match_jax(jax_workers, tmp_path):
    algo, jalgo = _pair(tes.ES, jes.ES, trl.ESConfig, jes.ESConfig)
    assert len(algo._workers) == 2
    for _ in range(2):
        got, want = algo.train(), jalgo.training_step()
        for k in ("mean_return", "best_return", "grad_norm"):
            assert got[k] == want[k], k
        np.testing.assert_array_equal(algo._center, jalgo._center)
        assert got["env_steps_total"] == jalgo._env_steps_total
    assert algo.evaluate(3) == jalgo.evaluate(3)
    path = algo.save(str(tmp_path / "es"))
    again = trl.ESConfig().training(**ES_KW).build(device="cpu")
    again.restore(path)
    # through float32 params, as JAX's checkpoint goes
    np.testing.assert_array_equal(
        again._center, algo._center.astype(np.float32).astype(np.float64))


def test_ars_iterations_and_filter_match_jax(jax_workers, tmp_path):
    from ray_tpu.rl.algorithms.ars import ARS as JARS, ARSConfig as JARSCfg

    kw = {"top_directions": 2}
    algo, jalgo = _pair(trl.ARS, JARS, trl.ARSConfig, JARSCfg, **kw)
    for _ in range(2):
        got, want = algo.train(), jalgo.training_step()
        for k in ("mean_return", "best_return", "selected_return_std"):
            assert got[k] == want[k], k
        np.testing.assert_array_equal(algo._center, jalgo._center)
        assert algo._f_count == jalgo._f_count
        np.testing.assert_array_equal(algo._f_sum, jalgo._f_sum)
        np.testing.assert_array_equal(algo._f_sumsq, jalgo._f_sumsq)
        for w, jw in zip(algo._workers, jalgo._workers):
            np.testing.assert_array_equal(w._mean, jw._obj._mean)
            np.testing.assert_array_equal(w._var, jw._obj._var)
    assert algo._f_count > 10
    # evaluation leaves the fleet's filter as it was
    state = algo.get_extra_state()
    assert algo.evaluate(2) == jalgo.evaluate(2)
    assert algo.get_extra_state()["count"] == state["count"]
    assert all(not w._delta.any() for w in algo._workers)
    # the filter's checkpoint round trip reaches every worker
    path = algo.save(str(tmp_path / "ars"))
    again = trl.ARSConfig().training(**{**ES_KW, **kw}).build(device="cpu")
    again.restore(path)
    assert again._f_count == algo._f_count
    np.testing.assert_array_equal(again._f_sum, algo._f_sum)
    for w, w0 in zip(again._workers, algo._workers):
        np.testing.assert_array_equal(w._mean, w0._mean)
        np.testing.assert_array_equal(w._var, w0._var)


def test_es_on_continuous_actions_clips_and_runs():
    cfg = trl.ESConfig().training(**{**ES_KW, "env": "Pendulum-v1",
                                     "max_episode_len": 5})
    algo = cfg.build(device="cpu")
    assert "log_std" in algo.get_params()
    m = algo.train()
    assert m["env_steps_total"] == 3 * 2 * 5 and np.isfinite(m["grad_norm"])
