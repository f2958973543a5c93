"""ray_tpu_torch's optimizer, on-policy losses, V-trace and Learner against
the JAX package's.

CPU, float32 on both sides, JAX's params carried over through numpy.
Losses and metrics within 1e-5 absolute (tests/test_long_context.py:34),
gradients and params within 1e-4 of the reference's max |value| per leaf
(:57). The JAX losses come from ``make_ppo_loss``/``make_a2c_loss`` and,
for PG, IMPALA and APPO, from their ``build_learner`` closures (run on an
algorithm object that never starts its runners).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import learner as jlearner
from ray_tpu.rl import models as jmodels
from ray_tpu.rl.algorithms.a2c import make_a2c_loss as jmake_a2c_loss
from ray_tpu.rl.algorithms.appo import APPO as JAPPO
from ray_tpu.rl.algorithms.impala import IMPALA as JIMPALA
from ray_tpu.rl.algorithms.impala import vtrace as jvtrace
from ray_tpu.rl.algorithms.pg import PG as JPG
from ray_tpu.rl.algorithms.pg import PGConfig as JPGConfig
from ray_tpu.rl.algorithms.ppo import make_ppo_loss as jmake_ppo_loss
from ray_tpu.rl.config import AlgorithmConfig as JAlgorithmConfig
from ray_tpu.rl.env import EnvSpec as JEnvSpec
from ray_tpu_torch.models.convert import (params_to_numpy,
                                          policy_params_from_jax)
from ray_tpu_torch.parallel.train_step import _leaves, value_and_grad
from ray_tpu_torch.rl import learner as tlearner
from ray_tpu_torch.rl.algorithms.a2c import make_a2c_loss
from ray_tpu_torch.rl.algorithms.appo import make_appo_loss
from ray_tpu_torch.rl.algorithms.impala import make_impala_loss, vtrace
from ray_tpu_torch.rl.algorithms.pg import make_pg_loss
from ray_tpu_torch.rl.algorithms.ppo import make_ppo_loss
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.env import EnvSpec

ATOL, REL = 1e-5, 1e-4
HIDDEN = (16, 16)
DISC = EnvSpec(obs_dim=4, num_actions=2)
CONT = EnvSpec(obs_dim=3, action_dim=1, action_low=-2.0, action_high=2.0)
T, N = 6, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _assert_tree_close(got, want, rel=REL):
    got = {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
           for k, v in _leaves(got).items()}
    want = {k: np.asarray(v) for k, v in _leaves(_np(want)).items()}
    assert got.keys() == want.keys()
    for name in want:
        assert _rel(got[name], want[name]) < rel, name


def _policy(spec, seed=0):
    jp = jmodels.init_policy(jax.random.key(seed),
                             JEnvSpec(**dataclasses.asdict(spec)), HIDDEN)
    return jp, policy_params_from_jax(_np(jp), spec, HIDDEN, device="cpu")


def _batch(spec, seed=0):
    """A flat [T*N] fragment (t-major) with the [N] bootstrap values."""
    rng = np.random.default_rng(seed)
    n = T * N
    acts = (rng.integers(0, spec.num_actions, n).astype(np.int32)
            if spec.discrete else
            rng.normal(size=(n, spec.action_dim)).astype(np.float32))
    return {"obs": rng.normal(size=(n, spec.obs_dim)).astype(np.float32),
            "actions": acts,
            "logp": rng.normal(-0.7, 0.2, n).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "value_targets": rng.normal(size=n).astype(np.float32),
            "rewards": rng.normal(1.0, 0.5, n).astype(np.float32),
            "dones": rng.random(n) < 0.15,
            "last_values": rng.normal(size=N).astype(np.float32)}


def _jax_closure_loss(jcls, jcfg, spec, jparams):
    """The loss a JAX algorithm's ``build_learner`` makes, without starting
    its runners (setup is never called)."""
    algo = jcls.__new__(jcls)
    algo.config = jcfg
    algo.spec = JEnvSpec(**dataclasses.asdict(spec))
    algo.init_policy_params = lambda: jparams
    algo.build_learner()
    return algo.learner._loss_fn


def _cfg_pair(**kw):
    return JAlgorithmConfig(**kw), AlgorithmConfig(**kw)


def _loss_pair(name, spec, jparams):
    jcfg, tcfg = _cfg_pair(rollout_fragment_length=T, gamma=0.97,
                           vf_coeff=0.4, entropy_coeff=0.02, clip_param=0.25,
                           vtrace_clip_rho=0.9, vtrace_clip_pg_rho=1.1)
    if name == "ppo":
        return (jmake_ppo_loss(JEnvSpec(**dataclasses.asdict(spec)), 0.25,
                               0.4, 0.02),
                make_ppo_loss(spec, 0.25, 0.4, 0.02))
    if name == "a2c":
        return (jmake_a2c_loss(JEnvSpec(**dataclasses.asdict(spec)), 0.4,
                               0.02),
                make_a2c_loss(spec, 0.4, 0.02))
    if name == "pg":
        jcfg = JPGConfig(entropy_coeff=0.02)
        return (_jax_closure_loss(JPG, jcfg, spec, jparams),
                make_pg_loss(spec, 0.02))
    if name == "impala":
        return (_jax_closure_loss(JIMPALA, jcfg, spec, jparams),
                make_impala_loss(spec, tcfg))
    return (_jax_closure_loss(JAPPO, jcfg, spec, jparams),
            make_appo_loss(spec, tcfg))


@pytest.mark.parametrize("name,spec", [
    ("ppo", DISC), ("ppo", CONT), ("pg", DISC), ("pg", CONT), ("a2c", DISC),
    ("a2c", CONT), ("impala", DISC), ("impala", CONT), ("appo", DISC),
    ("appo", CONT)],
    ids=lambda v: v if isinstance(v, str) else
    ("discrete" if v.discrete else "continuous"))
def test_loss_and_grads_match_jax(name, spec):
    jp, tp = _policy(spec, seed=1)
    jloss, tloss = _loss_pair(name, spec, jp)
    batch = _batch(spec, seed=2)
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0))
    (tl, taux), tg = value_and_grad(
        lambda p: tloss(p, {k: torch.as_tensor(v) for k, v in batch.items()},
                        None), tp, has_aux=True)
    assert abs(float(tl) - float(jl)) < ATOL
    assert taux.keys() == jaux.keys()
    for k in jaux:
        assert abs(float(taux[k]) - float(jaux[k])) < ATOL, k
    _assert_tree_close(tg, jg)


def test_vtrace_matches_jax_and_reduces_to_returns():
    rng = np.random.default_rng(0)
    args = [rng.normal(-0.7, 0.3, (T, N)), rng.normal(-0.7, 0.3, (T, N)),
            rng.normal(size=(T, N)), rng.normal(size=(T, N)),
            rng.normal(size=N), rng.random((T, N)) < 0.2]
    args = [a.astype(np.float32) if a.dtype != bool else a for a in args]
    jvs, jpg = jvtrace(*[jnp.asarray(a) for a in args], 0.95, 0.8, 1.2)
    tvs, tpg = vtrace(*[torch.as_tensor(a) for a in args], 0.95, 0.8, 1.2)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=ATOL)
    np.testing.assert_allclose(tpg.numpy(), np.asarray(jpg), atol=ATOL)
    # tests/test_rl.py:69: on-policy with v = 0, vs_t is the remaining
    # undiscounted return
    zeros = torch.zeros((4, 2))
    vs, _ = vtrace(zeros, zeros, torch.ones((4, 2)), zeros, torch.zeros(2),
                   torch.zeros((4, 2), dtype=torch.bool), gamma=1.0)
    np.testing.assert_allclose(vs[:, 0].numpy(), [4, 3, 2, 1], atol=ATOL)
    # the targets carry no gradient (JAX's stop_gradient)
    v = torch.zeros((4, 2), requires_grad=True)
    vs, pg = vtrace(zeros, zeros, torch.ones((4, 2)), v, torch.zeros(2),
                    torch.zeros((4, 2), dtype=torch.bool), gamma=1.0)
    assert not vs.requires_grad and not pg.requires_grad


def test_adam_and_clip_match_jax():
    """Three steps of JAX's hand-written Adam behind the global-norm clip,
    with a zero stride-marker leaf that must stay zero."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.normal(size=5).astype(np.float32),
                    np.zeros(2, np.float32)]}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(torch.tensor, params)
    jstate, tstate = jlearner.adam_init(jp), tlearner.adam_init(tp)
    for step in range(3):
        grads = {"a": rng.normal(size=(3, 4)).astype(np.float32) * 3,
                 "b": [rng.normal(size=5).astype(np.float32),
                       np.zeros(2, np.float32)]}
        jg, jnorm = jlearner.clip_global_norm(
            jax.tree_util.tree_map(jnp.asarray, grads), 1.5)
        tg, tnorm = tlearner.clip_global_norm(
            jax.tree_util.tree_map(torch.tensor, grads), 1.5)
        assert abs(float(tnorm) - float(jnorm)) < ATOL * float(jnorm)
        _assert_tree_close(tg, jg)
        jp, jstate = jlearner.adam_update(jp, jg, jstate, 1e-2)
        tp, tstate = tlearner.adam_update(tp, tg, tstate, 1e-2)
        assert tstate["t"] == jstate["t"] == step + 1
        _assert_tree_close(tp, jp)
        _assert_tree_close(tstate["nu"], jstate["nu"])
    assert not tp["b"][1].any()


@pytest.mark.parametrize("spec", [DISC, CONT], ids=["discrete",
                                                    "continuous"])
def test_learner_update_matches_jax(spec):
    """2 epochs of minibatches of 10 over 24 rows (two a epoch, 4 rows
    dropped) behind a 0.5 clip: params and averaged metrics equal JAX's
    Learner on the same batch and seed."""
    jp, tp = _policy(spec, seed=3)
    jloss, tloss = _loss_pair("ppo", spec, jp)
    batch = {k: v for k, v in _batch(spec, seed=4).items()
             if k != "last_values"}
    jl = jlearner.Learner(jp, jloss, 3e-3, grad_clip=0.5, seed=0)
    tl = tlearner.Learner(tp, tloss, 3e-3, grad_clip=0.5, seed=0,
                          device="cpu")
    for seed in (5, 6):
        jm = jl.update(batch, num_epochs=2, minibatch_size=10, seed=seed)
        tm = tl.update(batch, num_epochs=2, minibatch_size=10, seed=seed)
        assert tm.keys() == jm.keys()
        for k in jm:
            assert abs(tm[k] - jm[k]) < ATOL * max(1.0, abs(jm[k])), k
        _assert_tree_close(tl.get_params(), jl.get_params())
    assert tl.opt_state["t"] == jl.opt_state["t"] == 8
    # a full-batch update (minibatch_size 0) and set_params round trip
    jm = jl.update(batch, minibatch_size=0, shuffle=False)
    tm = tl.update(batch, minibatch_size=0, shuffle=False)
    assert abs(tm["loss"] - jm["loss"]) < ATOL
    tl.set_params(_np(jl.get_params()))
    _assert_tree_close(tl.get_params(), jl.get_params(), rel=1e-7)
    assert params_to_numpy(tl.get_params()).keys() == _np(jp).keys()


def test_learner_grad_sync_and_refusals():
    jp, tp = _policy(DISC)
    seen = []

    def sync(grads):
        seen.append(sorted(_leaves(grads)))
        return jax.tree_util.tree_map(lambda g: g * 0, grads)

    tl = tlearner.Learner(tp, make_ppo_loss(DISC, 0.2, 0.5, 0.01), 1e-2,
                          grad_sync=sync, device="cpu")
    before = params_to_numpy(tl.get_params())
    m = tl.update_minibatch(_batch(DISC))
    assert seen and "grad_norm" not in m and "loss" in m
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_numpy(tl.get_params()), before)
    tl.set_grad_sync(None)
    tl.update_minibatch(_batch(DISC))
    assert _rel(tl.get_params()["pi"]["layers"][0]["w"],
                before["pi"]["layers"][0]["w"]) > 0
    # a mesh decides the learner's device (tests/test_torch_rl_learner_mesh
    # holds the mesh update against JAX's)
    with pytest.raises(ValueError, match="a mesh or a device"):
        tlearner.Learner(tp, None, 1e-3, mesh=object(), device="cpu")
    # a LearnerGroup of learner actors needs the port's runtime: without
    # one it raises the runtime's error (tests/test_torch_learner_group.py
    # holds the group against JAX's)
    import ray_tpu_torch as rt

    if rt.is_initialized():
        rt.shutdown()
    with pytest.raises(RuntimeError, match="not been initialized"):
        tlearner.LearnerGroup(lambda device: None, 2, device="cpu")
