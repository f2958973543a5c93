"""The port's ``LearnerGroup`` (``ray_tpu_torch/rl/learner.py``) against
JAX's, on the same weights and batch.

CPU, float32. JAX's group of two learner actors runs on its own cluster
(``tests/test_rl.py:215``); the port's runs on the port's cluster (a
gloo group of two learner processes) and on its local backend (the
in-process plane). Both update a PPO loss over two epochs of minibatches
of equal shards (``batch[i:n_even:world]``); the gradients are averaged
across the group every minibatch, so the members' params stay equal to
each other, and each side's params are held to the other's within 1e-4
of the reference's max |value| per leaf (tests/test_long_context.py:57),
with the averaged metrics within 1e-5.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu.rl import learner as jlearner
from ray_tpu.rl import models as jmodels
from ray_tpu.rl.algorithms.ppo import make_ppo_loss as jmake_ppo_loss
from ray_tpu.rl.env import EnvSpec as JEnvSpec
from ray_tpu_torch.models.convert import (params_to_numpy,
                                          policy_params_from_jax)
from ray_tpu_torch.parallel.train_step import _leaves
from ray_tpu_torch.rl import learner as tlearner
from ray_tpu_torch.rl.algorithms.ppo import make_ppo_loss
from ray_tpu_torch.rl.env import EnvSpec

HIDDEN = (16, 16)
SPEC = dict(obs_dim=4, num_actions=2)
N, EPOCHS, MB, SEED = 66, 2, 8, 5   # 66 rows: 2 dropped by the shards
REL, ATOL = 1e-4, 1e-5


def _batch():
    rng = np.random.default_rng(0)
    return {"obs": rng.standard_normal((N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, N).astype(np.int32),
            "logp": (-0.7 + 0.1 * rng.standard_normal(N)).astype(np.float32),
            "advantages": rng.standard_normal(N).astype(np.float32),
            "value_targets": rng.standard_normal(N).astype(np.float32)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's group of two on its cluster: (initial params, metrics, the
    group's params after the update)."""
    spec = JEnvSpec(**SPEC)
    jp = jmodels.init_policy(jax.random.key(1), spec, HIDDEN)
    loss = jmake_ppo_loss(spec, 0.2, 0.5, 0.01)
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=4)
    try:
        group = jlearner.LearnerGroup(
            lambda: jlearner.Learner(jp, loss, 1e-3, grad_clip=0.5, seed=SEED),
            2)
        metrics = group.update(_batch(), num_epochs=EPOCHS,
                               minibatch_size=MB, seed=SEED)
        after = jax.tree_util.tree_map(np.asarray, group.get_params())
    finally:
        ray_tpu.shutdown()
    return jax.tree_util.tree_map(np.asarray, jp), metrics, after


def _port_group(npp):
    spec = EnvSpec(**SPEC)
    tp = policy_params_from_jax(npp, spec, HIDDEN, device="cpu")
    ctor = functools.partial(tlearner.Learner, tp,
                             make_ppo_loss(spec, 0.2, 0.5, 0.01), 1e-3,
                             grad_clip=0.5, seed=SEED)
    return tlearner.LearnerGroup(ctor, 2, device="cpu")


def _check(group, jax_run):
    npp, jmetrics, jafter = jax_run
    metrics = group.update(_batch(), num_epochs=EPOCHS, minibatch_size=MB,
                           seed=SEED)
    assert metrics.keys() == jmetrics.keys()
    for k in jmetrics:
        assert metrics[k] == pytest.approx(jmetrics[k], abs=ATOL), k
    members = [rt.get(a.get_params.remote()) for a in group.actors]
    for a, b in zip(_leaves(members[0]).values(),
                    _leaves(members[1]).values()):
        assert torch.equal(a, b)      # the group's members agree exactly
    got = {k: np.asarray(v) for k, v in
           _leaves(params_to_numpy(group.get_params())).items()}
    want = {k: np.asarray(v) for k, v in _leaves(jafter).items()}
    assert got.keys() == want.keys()
    for name in want:
        assert _rel(got[name], want[name]) < REL, name
    before = {k: np.asarray(v) for k, v in _leaves(npp).items()}
    assert any(_rel(got[k], before[k]) > 1e-3 for k in before)
    # set_params reaches every member
    group.set_params(npp)
    for a in group.actors:
        np.testing.assert_array_equal(
            params_to_numpy(rt.get(a.get_params.remote()))["pi"]["layers"]
            [0]["w"], npp["pi"]["layers"][0]["w"])
    group.stop()


@pytest.mark.parametrize("backend", ["cluster", "local"])
def test_learner_group_matches_jax(jax_run, backend):
    if rt.is_initialized():
        rt.shutdown()
    if backend == "cluster":
        rt.init(num_cpus=4, num_gpus=0)
    else:
        rt.init(local_mode=True, num_cpus=4)
    try:
        _check(_port_group(jax_run[0]), jax_run)
    finally:
        rt.shutdown()


def test_learner_group_needs_the_runtime():
    """Without a runtime the group raises the runtime's error, as JAX's
    does; its members default to cuda, as the shipment tool does."""
    if rt.is_initialized():
        rt.shutdown()
    with pytest.raises(RuntimeError, match="not been initialized"):
        tlearner.LearnerGroup(lambda device: None, 2, device="cpu")
    if not torch.cuda.is_available():
        from ray_tpu_torch.tools import ship_stages

        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlearner.LearnerGroup(lambda device: None, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ship_stages.main(["--preset", "debug"])
