"""ray_tpu_torch's QMIX and MADDPG against the JAX package's, in one
process.

Conventions in ``tests/_torch_rl_offpolicy.py``. Both algorithms explore
on the host with numpy (QMIX's epsilon-greedy, MADDPG's Gaussian action
noise) and replay from numpy generators, so with JAX's params carried
across a whole iteration (collection, minibatches, updates, target syncs
or polyak steps) is compared against JAX's, not just one loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rl_offpolicy import (ATOL, assert_loss_parity,
                                 assert_metrics_close, assert_tree_close,
                                 carry, grads_of, np_tree,
                                 one_thread,  # noqa: F401
                                 shares_storage, to_torch, tree_equal)
from ray_tpu import rl as jrl
from ray_tpu.rl.algorithms import qmix as jqmix
from ray_tpu_torch import rl as trl
from ray_tpu_torch.models.convert import rl_params_from_jax
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl.algorithms import maddpg as tmaddpg
from ray_tpu_torch.rl.algorithms import qmix as tqmix
from ray_tpu_torch.rl.env import EnvSpec

pytestmark = pytest.mark.usefixtures("one_thread")

QMIX_KW = {"num_envs_per_runner": 4, "rollout_fragment_length": 8,
           "learning_starts": 16, "updates_per_iter": 3, "minibatch_size": 8,
           "target_update_freq": 2, "hidden": (16,), "mixing_embed_dim": 8,
           "seed": 3}
MADDPG_KW = {"num_envs_per_runner": 4, "rollout_fragment_length": 6,
             "learning_starts": 16, "updates_per_iter": 3,
             "minibatch_size": 8, "hidden": (16, 16), "tau": 0.2, "seed": 1}


def _qmix(pkg, **kw):
    return pkg.QMIXConfig().training(**{**QMIX_KW, **kw})


def _maddpg(pkg, **kw):
    return pkg.MADDPGConfig().training(**{**MADDPG_KW, **kw})


def _pair(make, **kw):
    """JAX's algorithm and the port's on the CPU from JAX's params."""
    jalgo = make(jrl, **kw).build()
    talgo = make(trl, **kw).build(device="cpu")
    talgo.learner.set_params(carry(jalgo.learner.get_params(), talgo))
    return jalgo, talgo


def _perturbed_targets(jparams):
    """Targets away from the online nets, so the losses see them."""
    p = dict(jparams)
    for k in [k for k in p if k.startswith("target_") or k.endswith("_t")]:
        p[k] = jax.tree_util.tree_map(lambda x: x * 0.9 + 0.01, p[k])
    return p


# ------------------------------------------------------------------ QMIX --

def _mixer_pair(n=3, state_dim=5, embed=4):
    jmixer = jqmix._init_mixer(jax.random.key(0), n, state_dim, embed)
    like = tqmix._init_mixer(torch.Generator(), n, state_dim, embed)
    return jmixer, rl_params_from_jax(np_tree(jmixer), like, device="cpu")


def test_mixer_matches_jax_and_is_monotonic():
    jmixer, tmixer = _mixer_pair()
    rng = np.random.default_rng(0)
    qs = rng.normal(size=(6, 3)).astype(np.float32)
    state = rng.normal(size=(6, 5)).astype(np.float32)
    want = np.asarray(jqmix._mix(jmixer, qs, state))
    got = tqmix._mix(tmixer, torch.tensor(qs), torch.tensor(state))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # dQ_tot/dQ_a >= 0 everywhere (JAX's test_qmix_mixer_is_monotonic),
    # and the port's Jacobian is JAX's
    jjac = np.asarray(jax.jacobian(
        lambda q: jqmix._mix(jmixer, q, state).sum())(qs))
    tq = torch.tensor(qs, requires_grad=True)
    tjac, = torch.autograd.grad(
        tqmix._mix(tmixer, tq, torch.tensor(state)).sum(), tq)
    assert (tjac >= 0).all()
    np.testing.assert_allclose(tjac.numpy(), jjac, rtol=0, atol=ATOL)


def test_qmix_loss_matches_jax():
    jalgo, talgo = _pair(_qmix)
    jparams = _perturbed_targets(jalgo.learner.get_params())
    talgo.train()   # fills the replay past learning_starts
    arrays = {k: np.concatenate(v) for k, v in talgo._buf.items()}
    batch = talgo._sample_batch(arrays, 12)
    tl, tm = assert_loss_parity(
        talgo.learner._loss_fn, carry(jparams, talgo),
        jalgo.learner._loss_fn, jparams, batch, jax.random.key(0))
    assert set(tm) == {"td_abs_mean", "q_tot_mean"}


def test_qmix_iteration_matches_jax():
    """Three iterations: epsilon-greedy collection from the same numpy
    generator, replay minibatches, three updates each and a target sync
    every second update."""
    jalgo, talgo = _pair(_qmix)
    for _ in range(3):
        assert_metrics_close(talgo.train(), jalgo.train())
    assert talgo._grad_updates == jalgo._grad_updates == 9
    assert_tree_close(talgo.learner.get_params(), jalgo.learner.get_params())
    p = talgo.learner.get_params()
    assert not shares_storage(p["agent"], p["target_agent"])
    assert not shares_storage(p["mixer"], p["target_mixer"])


def test_qmix_target_nets_get_zero_gradients():
    _, talgo = _pair(_qmix)
    talgo.train()
    arrays = {k: np.concatenate(v) for k, v in talgo._buf.items()}
    batch = to_torch(talgo._sample_batch(arrays, 8))
    _, _, grads = grads_of(
        talgo.learner._loss_fn, talgo.learner.get_params(), batch)
    for k, g in grads.items():
        assert torch.any(g != 0) != k.startswith("target_"), k


class _Hetero(trl.MultiAgentEnv):
    """JAX's heterogeneous test env (tests/test_rl_new_algos.py): agent
    ``small`` has 2 actions, ``big`` 4; the env asserts no invalid slot is
    ever chosen."""

    def __init__(self, num_envs: int = 4, seed: int = 0):
        self.agents = ["small", "big"]
        self.num_envs = num_envs
        self.spec = {"small": EnvSpec(obs_dim=3, num_actions=2),
                     "big": EnvSpec(obs_dim=5, num_actions=4)}
        self._t = np.zeros(num_envs, np.int64)

    def reset(self):
        self._t[:] = 0
        return {"small": np.zeros((self.num_envs, 3), np.float32),
                "big": np.zeros((self.num_envs, 5), np.float32)}

    def step(self, actions):
        assert actions["small"].max() < 2, actions["small"]
        assert actions["big"].max() < 4, actions["big"]
        self._t += 1
        dones = self._t >= 8
        self._t[dones] = 0
        r = {a: np.ones(self.num_envs, np.float32) for a in self.agents}
        return self.reset() if dones.all() else {
            "small": np.zeros((self.num_envs, 3), np.float32),
            "big": np.zeros((self.num_envs, 5), np.float32)}, r, dones


@pytest.mark.parametrize("epsilon", [1.0, 0.0])
def test_qmix_heterogeneous_actions_never_pick_invalid_slots(epsilon):
    """Exploring (epsilon 1) and greedy (epsilon 0) collection, the
    updates' TD targets and greedy evaluation."""
    cfg = _qmix(trl, epsilon_initial=epsilon, epsilon_final=epsilon)
    cfg.env = _Hetero
    algo = cfg.build(device="cpu")
    assert algo._action_mask[0].tolist() == [0, 0, -np.inf, -np.inf]
    for _ in range(3):
        m = algo.train()
    assert np.isfinite(m["td_abs_mean"]) and np.isfinite(m["loss"])
    leaves = torch.cat([t.reshape(-1) for t in
                        tmodels._leaves(algo.get_params()).values()])
    assert torch.isfinite(leaves).all()
    ev = algo.evaluate(num_episodes=4)    # greedy: the env asserts too
    assert ev["episode_return_mean"] == 8.0


def test_qmix_evaluate_and_checkpoint_roundtrip(tmp_path):
    jalgo, talgo = _pair(_qmix)
    for _ in range(2):
        jalgo.train()
        talgo.train()
    assert talgo.evaluate(4) == pytest.approx(jalgo.evaluate(4), abs=ATOL)
    talgo.save(str(tmp_path))
    fresh = _qmix(trl).build(device="cpu")
    fresh.restore(str(tmp_path))
    assert tree_equal(fresh.get_params(), talgo.get_params())
    assert fresh._env_steps_total == talgo._env_steps_total == 64


@pytest.mark.parametrize("make,env,match", [
    (_qmix, "spread", "discrete"),
    (_maddpg, "coordination", "continuous")])
def test_rejects_wrong_action_spaces(make, env, match):
    for pkg, kw in ((jrl, {}), (trl, {"device": "cpu"})):
        cfg = make(pkg)
        cfg.env = env
        with pytest.raises(ValueError, match=match):
            cfg.build(**kw)


def test_maddpg_rejects_heterogeneous_agents():
    class Mixed(_Hetero):
        def __init__(self, num_envs=4, seed=0):
            super().__init__(num_envs, seed)
            self.spec = {"small": EnvSpec(obs_dim=3, action_dim=2),
                         "big": EnvSpec(obs_dim=5, action_dim=2)}

    cfg = _maddpg(trl)
    cfg.env = Mixed
    with pytest.raises(ValueError, match="homogeneous"):
        cfg.build(device="cpu")


# ---------------------------------------------------------------- MADDPG --

def test_maddpg_loss_matches_jax():
    """Every agent's critic and actor term in one scalar: the actor terms
    reach the actors through the action input only."""
    jalgo, talgo = _pair(_maddpg)
    jparams = _perturbed_targets(jalgo.learner.get_params())
    talgo.train()
    batch = talgo.buffer.sample(12)
    _, tm = assert_loss_parity(
        talgo.learner._loss_fn, carry(jparams, talgo),
        jalgo.learner._loss_fn, jparams, batch, jax.random.key(0))
    assert set(tm) == {"critic_loss_0", "actor_loss_0", "critic_loss_1",
                       "actor_loss_1", "q_mean"}


def test_maddpg_actor_term_leaves_critics_alone():
    """With the critic terms' targets equal to their predictions, the
    critics' gradients are zero: the actor terms add nothing to them."""
    _, talgo = _pair(_maddpg)
    talgo.train()
    p = talgo.learner.get_params()
    batch = to_torch(talgo.buffer.sample(8))
    _, loss_fn = tmaddpg.make_maddpg_fns(2, -1.0, 1.0, 0.0)
    # gamma 0 and rewards = the critics' own predictions: TD error 0
    with torch.no_grad():
        B = batch["obs"].shape[0]
        x = torch.cat([batch["obs"].reshape(B, -1),
                       batch["actions"].reshape(B, -1)], -1)
        batch["rewards"] = torch.stack(
            [tmodels.mlp_forward(p["critics"][i], x)[..., 0]
             for i in range(2)], dim=1)
    _, _, grads = grads_of(
        loss_fn, p, batch)
    for k, g in grads.items():
        if k.startswith(("critics/", "actors_t", "critics_t")):
            assert not torch.any(g != 0), k
        elif k.startswith("actors/") and k.endswith("w"):
            assert torch.any(g != 0), k


def test_maddpg_iteration_matches_jax():
    """Collection with the same host noise, replay, and three updates
    each followed by a polyak step, over three iterations."""
    jalgo, talgo = _pair(_maddpg)
    for _ in range(3):
        assert_metrics_close(talgo.train(), jalgo.train())
    assert_tree_close(talgo.learner.get_params(), jalgo.learner.get_params())


def test_maddpg_polyak_matches_jax_and_never_aliases():
    jalgo, talgo = _pair(_maddpg)
    jp = dict(jalgo.learner.get_params())
    for k in ("actors", "critics"):
        jp[k] = jax.tree_util.tree_map(lambda x: x + 0.5, jp[k])
    tp = carry(jp, talgo)
    got = tmaddpg.polyak(tp, 0.2)
    assert_tree_close(got, jalgo._polyak(jp), tol=1e-6)
    for src, dst in (("actors", "actors_t"), ("critics", "critics_t")):
        assert not shares_storage(got[src], got[dst])
        assert not shares_storage(tp[dst], got[dst])


def test_maddpg_evaluate_and_checkpoint_roundtrip(tmp_path):
    jalgo, talgo = _pair(_maddpg)
    for _ in range(2):
        jalgo.train()
        talgo.train()
    ev_t, ev_j = talgo.evaluate(4), jalgo.evaluate(4)
    assert ev_t["episodes"] == ev_j["episodes"]
    assert abs(ev_t["episode_return_mean"]
               - ev_j["episode_return_mean"]) < 1e-4
    talgo.save(str(tmp_path))
    fresh = _maddpg(trl).build(device="cpu")
    fresh.restore(str(tmp_path))
    assert tree_equal(fresh.get_params(), talgo.get_params())


def test_act_all_matches_jax():
    jalgo, talgo = _pair(_maddpg)
    obs = np.random.default_rng(0).uniform(-1, 1, (4, 2, 8)).astype(
        np.float32)
    want = np.asarray(jalgo._act_all(jalgo.learner.get_params()["actors"],
                                     jnp.asarray(obs)))
    got = talgo._act_all(talgo.learner.get_params()["actors"], obs)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
