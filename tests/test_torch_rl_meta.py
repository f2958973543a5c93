"""ray_tpu_torch's MAML and MBMPO against the JAX package's, in one
process: the inner adaptation step, the second-order meta-gradient
(``train_step.grad`` with ``create_graph`` inside ``value_and_grad``;
JAX: ``jax.grad`` inside ``jax.value_and_grad``), MBMPO's [K]-stacked
dynamics ensemble and its imagined rollouts.

Conventions in ``tests/_torch_rl_offpolicy.py``. The policies' Gaussian
noise is JAX's: the port draws it through ``models.normal``, which these
tests replace with a replay of JAX's keys in the port's draw order
(``JaxDraws``): MAML splits its key before each action; MBMPO does too
while collecting, and for each meta-step splits one key per member, that
into a pre- and a post-adaptation key and each of those into H step keys.
The port loops over the members in order where JAX ``vmap``s them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rl_offpolicy import (ATOL, REL, JaxDraws, assert_metrics_close,
                                 assert_tree_close, carry, closure, np_tree,
                                 one_thread,  # noqa: F401
                                 rel, tree_equal)
from ray_tpu import rl as jrl
from ray_tpu.rl.algorithms.maml import PointGoal as JPointGoal
from ray_tpu_torch import rl as trl
from ray_tpu_torch.parallel.train_step import (_leaves, _unflatten_like,
                                               grad, value_and_grad)
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl.algorithms import maml as tmaml
from ray_tpu_torch.rl.algorithms import mbmpo as tmbmpo

pytestmark = pytest.mark.usefixtures("one_thread")

MAML_KW = {"meta_batch_size": 2, "num_envs_per_runner": 4, "horizon": 4,
           "hidden": (8, 8), "seed": 5}
MBMPO_KW = {"num_envs_per_runner": 4, "real_steps_per_iter": 16,
            "ensemble_size": 2, "model_hidden": (16, 16), "model_epochs": 2,
            "model_batch": 8, "val_frac": 0.25, "imag_horizon": 3,
            "imag_envs": 4, "meta_steps_per_iter": 2, "hidden": (8, 8),
            "seed": 2}


def _maml(pkg, **kw):
    return pkg.MAMLConfig().training(**{**MAML_KW, **kw})


def _mbmpo(pkg, **kw):
    return pkg.MBMPOConfig().training(**{**MBMPO_KW, **kw})


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                  tree)


def _assert_grads_close(got: dict, jgrads):
    want = {k: np.asarray(v) for k, v in _leaves(np_tree(jgrads)).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert rel(got[k], want[k]) < REL, (k, rel(got[k], want[k]))


def test_grad_is_differentiable_and_leaves_params_alone():
    """``grad`` with ``create_graph``: a loss of the gradient
    differentiates through it (against JAX's grad of grad); the caller's
    leaves are not marked."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(3, 2)).astype(np.float32)
    x = rng.normal(size=(5, 3)).astype(np.float32)

    def jf(w):
        return jnp.sum(jnp.tanh(x @ w) ** 2)

    def jouter(w):
        return jnp.sum(jax.grad(jf)(w) ** 2)

    tx = torch.tensor(x)

    def tf(p):
        return torch.sum(torch.tanh(tx @ p["w"]) ** 2)

    params = {"w": torch.tensor(w0)}
    first = grad(tf, params)
    assert not params["w"].requires_grad
    np.testing.assert_allclose(first["w"].numpy(),
                               np.asarray(jax.grad(jf)(w0)), atol=ATOL)
    val, second = value_and_grad(
        lambda p: torch.sum(grad(tf, p, create_graph=True)["w"] ** 2),
        params)
    assert abs(float(val) - float(jouter(w0))) < ATOL
    assert rel(second["w"], np.asarray(jax.grad(jouter)(w0))) < REL
    assert not params["w"].requires_grad


@pytest.mark.parametrize("goal", [(1.0, 0.0), (-0.6, 0.8)])
def test_point_goal_bit_equal(goal):
    jenv = JPointGoal(goal, num_envs=5, horizon=6, seed=4)
    tenv = trl.PointGoal(goal, num_envs=5, horizon=6, seed=4)
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    rng = np.random.default_rng(1)
    for _ in range(20):
        acts = rng.normal(size=(5, 2)).astype(np.float32)
        for got, want in zip(tenv.step(acts), jenv.step(acts)):
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ MAML --

def _maml_pair():
    jalgo = _maml(jrl).build()
    talgo = _maml(trl).build(device="cpu")
    talgo.params = carry(jalgo.params, talgo.params)
    return jalgo, talgo


def _task_batches(jalgo, n_tasks=2):
    """JAX's pre- and post-adaptation batches of ``n_tasks`` tasks."""
    pre, post = [], []
    for _ in range(n_tasks):
        env = JPointGoal(jalgo._sample_task(), 4, 4,
                         seed=int(jalgo._rng.integers(1 << 31)))
        b, _ = jalgo._rollout(env, jalgo.params)
        pre.append(b)
        b, _ = jalgo._rollout(env, jalgo._adapt(jalgo.params, b))
        post.append(b)
    return pre, post


def test_maml_pg_loss_and_adapt_match_jax():
    jalgo, talgo = _maml_pair()
    (pre,), _ = _task_batches(jalgo, 1)
    tpre = _to_torch(pre)
    jloss = closure(jalgo._adapt, "pg_loss")
    assert abs(float(tmaml.pg_loss(talgo.params, tpre))
               - float(jloss(jalgo.params, pre))) < ATOL
    got = tmaml.adapt(talgo.params, tpre, 0.5, 2)
    assert_tree_close(got, jalgo._adapt(jalgo.params, pre))


def test_maml_meta_gradient_is_jax_second_order():
    """The meta-loss and its gradient through two inner SGD steps per
    task against JAX's ``_meta_grad``; a first-order gradient (the inner
    gradients detached) is far from it."""
    jalgo, talgo = _maml_pair()
    pre, post = _task_batches(jalgo)
    jl, jg = jalgo._meta_grad(jalgo.params, pre, post)
    tl, tg = talgo._meta_grad(talgo.params, _to_torch(pre), _to_torch(post))
    assert abs(float(tl) - float(jl)) < ATOL
    _assert_grads_close(tg, jg)

    def first_order(p):
        total = 0.0
        for b0, b1 in zip(_to_torch(pre), _to_torch(post)):
            q = p
            for _ in range(2):
                g = grad(lambda r: tmaml.pg_loss(r, b0), q)
                q = _unflatten_like(q, {k: w - 0.5 * g[k].detach()
                                        for k, w in _leaves(q).items()})
            total = total + tmaml.pg_loss(q, b1)
        return total / 2

    _, fo = value_and_grad(first_order, talgo.params)
    want = {k: np.asarray(v) for k, v in _leaves(np_tree(jg)).items()}
    assert max(rel(fo[k], want[k]) for k in want) > 100 * REL


def test_maml_iteration_matches_jax(monkeypatch):
    """One meta-iteration from JAX's params with JAX's action noise:
    tasks, both rollouts of each, adaptation, the meta-update."""
    jalgo, talgo = _maml_pair()
    JaxDraws(MAML_KW["seed"] + 1, 0).install(monkeypatch, tmodels)
    assert_metrics_close(talgo.train(), jalgo.train())
    assert_tree_close(talgo.params, jalgo.params)


def test_maml_evaluate_leaves_training_state_alone():
    a, b = (_maml(trl).build(device="cpu") for _ in range(2))
    ev = a.evaluate(num_tasks=2)
    assert set(ev) == {"pre_adapt_reward", "post_adapt_reward",
                       "adaptation_gain"}
    ma, mb = a.train(), b.train()
    for k in ("meta_loss", "pre_adapt_reward", "post_adapt_reward"):
        assert ma[k] == mb[k], k
    assert tree_equal(a.params, b.params)
    assert a._env_steps_total == b._env_steps_total


def test_maml_checkpoint_roundtrip(tmp_path):
    algo = _maml(trl).build(device="cpu")
    algo.train()
    algo.save(str(tmp_path))
    fresh = _maml(trl).build(device="cpu")
    fresh.restore(str(tmp_path))
    assert tree_equal(fresh.params, algo.params)
    assert fresh._env_steps_total == algo._env_steps_total == 64


# ----------------------------------------------------------------- MBMPO --

def _mbmpo_pair():
    jalgo = _mbmpo(jrl).build()
    talgo = _mbmpo(trl).build(device="cpu")
    talgo.params = carry(jalgo.params, talgo.params)
    talgo.model_params = carry(jalgo.model_params, talgo.model_params)
    return jalgo, talgo


def _norm(seed=0, D=3, A=1):
    rng = np.random.default_rng(seed)
    return {"x_mean": rng.normal(size=D + A).astype(np.float32),
            "x_std": rng.uniform(0.5, 2, D + A).astype(np.float32),
            "y_mean": 0.1 * rng.normal(size=D + 1).astype(np.float32),
            "y_std": rng.uniform(0.5, 2, D + 1).astype(np.float32)}


def test_mbmpo_ensemble_update_and_val_loss_match_jax():
    jalgo, talgo = _mbmpo_pair()
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(2, 8, 4)).astype(np.float32)
    ys = rng.normal(size=(2, 8, 4)).astype(np.float32)
    jmp, jopt = jalgo.model_params, jalgo._model_opt_state
    tmp, topt = talgo.model_params, talgo._model_opt_state
    for _ in range(3):   # three Adam steps
        jmp, jopt, jl = jalgo._model_update(jmp, jopt, jnp.asarray(xs),
                                            jnp.asarray(ys))
        tmp, topt, tl = tmbmpo.model_update(tmp, topt, torch.tensor(xs),
                                            torch.tensor(ys), 1e-3)
        assert abs(float(tl) - float(jl)) < ATOL
    assert_tree_close(tmp, jmp)
    x, y = xs[0], ys[1]
    want = np.asarray(jalgo._model_val_loss(jmp, jnp.asarray(x),
                                            jnp.asarray(y)))
    got = tmbmpo.member_losses(tmp, torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=ATOL)


def test_mbmpo_imagine_matches_jax(monkeypatch):
    jalgo, talgo = _mbmpo_pair()
    jimagine = closure(closure(jalgo._meta_grad, "task_loss"), "imagine")
    norm = _norm()
    start = np.random.default_rng(3).normal(size=(4, 3)).astype(np.float32)
    key = jax.random.key(9)
    jmember = jax.tree_util.tree_map(lambda t: t[1], jalgo.model_params)
    want, want_rew = jimagine(jalgo.params, jmember,
                              {k: jnp.asarray(v) for k, v in norm.items()},
                              jnp.asarray(start), key)
    draws = JaxDraws.of_keys(jax.random.split(key, 3))
    draws.install(monkeypatch, tmodels)
    got, got_rew = talgo._imagine(
        talgo.params, tmbmpo.member(talgo.model_params, 1),
        {k: torch.tensor(v) for k, v in norm.items()}, torch.tensor(start))
    assert draws.calls == 3
    assert abs(float(got_rew) - float(want_rew)) < ATOL
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


def _meta_step_keys(sub, K, H):
    """The port's draw order of one meta-step from JAX's ``sub``."""
    out = []
    for kk in jax.random.split(sub, K):
        k1, k2 = jax.random.split(kk)
        out += list(jax.random.split(k1, H)) + list(jax.random.split(k2, H))
    return out


def test_mbmpo_meta_gradient_matches_jax(monkeypatch):
    """The mean over the members of each one's post-adaptation loss and
    its second-order gradient, against JAX's vmapped ``_meta_grad``."""
    jalgo, talgo = _mbmpo_pair()
    norm = _norm(1)
    start = np.random.default_rng(4).normal(size=(4, 3)).astype(np.float32)
    sub = jax.random.key(17)
    (jl, (jpre, jpost)), jg = jalgo._meta_grad(
        jalgo.params, jalgo.model_params,
        {k: jnp.asarray(v) for k, v in norm.items()}, jnp.asarray(start),
        jax.random.split(sub, 2))
    draws = JaxDraws.of_keys(_meta_step_keys(sub, 2, 3))
    draws.install(monkeypatch, tmodels)
    (tl, aux), tg = value_and_grad(
        lambda p: talgo.meta_loss(p, talgo.model_params,
                                  {k: torch.tensor(v)
                                   for k, v in norm.items()},
                                  torch.tensor(start)),
        talgo.params, has_aux=True)
    assert draws.calls == 12
    for got, want in ((tl, jl), (aux["pre"], jpre), (aux["post"], jpost)):
        assert abs(float(got) - float(want)) < ATOL
    _assert_grads_close(tg, jg)


def _mbmpo_iteration_keys(seed, collect_steps, meta_steps, K, H):
    key = jax.random.key(seed + 1)
    out = []
    for _ in range(collect_steps):
        key, sub = jax.random.split(key)
        out.append(sub)
    for _ in range(meta_steps):
        key, sub = jax.random.split(key)
        out += _meta_step_keys(sub, K, H)
    return out


def test_mbmpo_iteration_matches_jax(monkeypatch):
    """One iteration from JAX's params with JAX's noise: real collection
    (done rows dropped), the ensemble fit on bootstrap minibatches with
    JAX's normalisers, two meta-steps."""
    jalgo, talgo = _mbmpo_pair()
    draws = JaxDraws.of_keys(_mbmpo_iteration_keys(2, 4, 2, 2, 3))
    draws.install(monkeypatch, tmodels)
    assert_metrics_close(talgo.train(), jalgo.train())
    assert not draws.pending
    for k in ("obs", "act", "delta", "rew"):
        np.testing.assert_allclose(np.concatenate(talgo._buf[k]),
                                   np.concatenate(jalgo._buf[k]), rtol=0,
                                   atol=ATOL)
    for k, v in jalgo._norm.items():
        np.testing.assert_allclose(talgo._norm[k], v, rtol=1e-6, atol=ATOL)
    assert_tree_close(talgo.params, jalgo.params)
    assert_tree_close(talgo.model_params, jalgo.model_params)


def test_mbmpo_collect_drops_done_rows():
    cfg = _mbmpo(trl, real_steps_per_iter=4 * 201)
    algo = cfg.build(device="cpu")
    algo._collect_real(cfg.real_steps_per_iter)
    # Pendulum's episodes end at 200 steps: that step's 4 rows are dropped
    assert sum(len(a) for a in algo._buf["obs"]) == 4 * 200
    assert algo._env_steps_total == 4 * 201


def test_mbmpo_rejects_discrete_and_checkpoints(tmp_path):
    for pkg, kw in ((jrl, {}), (trl, {"device": "cpu"})):
        with pytest.raises(ValueError, match="continuous"):
            _mbmpo(pkg, env="CartPole-v1").build(**kw)
    algo = _mbmpo(trl).build(device="cpu")
    algo.train()
    algo.save(str(tmp_path))
    fresh = _mbmpo(trl).build(device="cpu")
    fresh.restore(str(tmp_path))
    assert tree_equal(fresh.get_params(), algo.get_params())
    for k, v in algo._norm.items():
        np.testing.assert_array_equal(fresh._norm[k], v)
    ev = fresh.evaluate()
    assert np.isfinite(ev["episode_return_mean"]) and ev["episodes"] == 4
