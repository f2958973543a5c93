"""``Learner(mesh=...)`` against JAX's on a ``dp`` mesh of 8.

JAX jits one PPO update over the global minibatch sharded on ``dp``
(8 virtual CPU devices, params replicated); the port's learner is a gloo
gang of 8 ranks (``tests/_torch_gang.py``) on ``MeshConfig(dp=8)``, each
rank handed the same global batch. The batch's advantages grow 10x from
one shard to the next, so a per-shard normalisation (each rank's own
``adv.mean()`` and ``adv.std()``) would give another update. The whole
batch's gradients (64 rows, 8 a rank) within 1e-4 of each leaf's max
|value| of JAX's (``tests/test_long_context.py:57``); then two minibatch
updates (minibatches of 32, 4 rows a rank) and the params and metrics
within 1e-5 absolute (``:34``); every rank's params and generator state
equal rank 0's. The gang holds itself to ``LIMIT_S``.

The losses that draw noise in the batch's shape from the learner's
generator (SAC, CQL, CRR, TD3) run through the same mesh: each draw is
the global noise, replicated on every rank, so the gradients of a
32-row batch equal those of the plain ``Learner`` seeded alike (within
1e-4 of each leaf's max |value|), and the generator stays rank-identical.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_gang as gang
import _torch_gang_cases as cases
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu.rl import learner as jlearner
from ray_tpu.rl import models as jmodels
from ray_tpu.rl.algorithms.ppo import make_ppo_loss as jmake_ppo_loss
from ray_tpu.rl.env import EnvSpec as JEnvSpec
from ray_tpu_torch.models.convert import policy_params_from_jax
from ray_tpu_torch.parallel.train_step import _leaves, value_and_grad
from ray_tpu_torch.rl.env import EnvSpec

LIMIT_S = 120
WORLD = 8
ROWS, MINIBATCH = 64, 32
HIDDEN = (16, 16)
SPEC = EnvSpec(obs_dim=4, num_actions=2)
PPO = (0.2, 0.5, 0.01)        # clip_param, vf_coeff, entropy_coeff
LR, CLIP, SEED = 1e-2, 0.5, 0


def _batch(seed=0):
    """64 CartPole-shaped rows whose advantages' scale grows 10x per
    4-row shard (and shuffles keep the mix uneven per minibatch)."""
    rng = np.random.default_rng(seed)
    scale = np.repeat(10.0 ** (np.arange(ROWS // 4) % 4), 4)
    return {"obs": rng.standard_normal((ROWS, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, ROWS).astype(np.int32),
            "logp": (-0.69 + 0.1 * rng.standard_normal(ROWS)).astype(
                np.float32),
            "advantages": (scale * rng.standard_normal(ROWS) + scale).astype(
                np.float32),
            "value_targets": rng.standard_normal(ROWS).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if len(jax.devices()) < WORLD:
        pytest.skip("needs the 8-device CPU mesh")
    tmp = tmp_path_factory.mktemp("rl_learner_mesh")
    jp = jmodels.init_policy(jax.random.key(0),
                             JEnvSpec(**dataclasses.asdict(SPEC)), HIDDEN)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    torch.save(policy_params_from_jax(np_params, SPEC, HIDDEN, device="cpu"),
               tmp / "params.pt")
    batch = _batch()
    np.savez(tmp / "batch.npz", **batch)
    g = gang.start("rl_learner", WORLD, tmp, LIMIT_S,
                   mesh=dict(dp=WORLD), spec=dataclasses.asdict(SPEC),
                   ppo=list(PPO), lr=LR, grad_clip=CLIP, seed=SEED,
                   minibatch_size=MINIBATCH, params=str(tmp / "params.pt"),
                   batch=str(tmp / "batch.npz"))
    jl = jlearner.Learner(
        jp, jmake_ppo_loss(JEnvSpec(**dataclasses.asdict(SPEC)), *PPO), LR,
        grad_clip=CLIP, seed=SEED,
        mesh=jmake_mesh(JMeshConfig(dp=WORLD), jax.devices()[:WORLD]))
    jm = jl.update(batch, num_epochs=1, minibatch_size=MINIBATCH, seed=SEED)
    want = {k: np.asarray(v) for k, v in _leaves(
        jax.tree_util.tree_map(np.asarray, jl.get_params())).items()}
    loss = jmake_ppo_loss(JEnvSpec(**dataclasses.asdict(SPEC)), *PPO)
    jgrads = jax.grad(lambda p: loss(p, batch, None)[0])(jp)
    jgrads = {k: np.asarray(v) for k, v in _leaves(
        jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    return want, jm, jgrads, g.result()


def test_mesh_gradients_match_jax(runs):
    _, _, jgrads, got = runs
    grads = got[0]["grads"]
    assert grads.keys() == jgrads.keys()
    for name, want in jgrads.items():
        err = np.abs(grads[name] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def test_mesh_update_matches_jax(runs):
    want, jm, _, got = runs
    params = got[0]["params"]
    assert params.keys() == want.keys()
    for name in want:
        diff = np.abs(params[name] - want[name]).max()
        assert diff < 1e-5, (name, diff)
    for key, value in jm.items():
        assert abs(got[0]["metrics"][key] - value) < 1e-5, key


def test_mesh_ranks_stay_identical(runs):
    _, _, _, got = runs
    for r in range(1, WORLD):
        assert got[r]["gen"] == got[0]["gen"]
        for name, v in got[0]["params"].items():
            np.testing.assert_array_equal(got[r]["params"][name], v)


@pytest.mark.parametrize("name", ["SAC", "CQL", "CRR", "TD3"])
def test_mesh_noise_losses_match_the_plain_learner(runs, name):
    """A loss that draws noise (``models.normal``/``uniform``) gives the
    plain learner's gradients and metrics on the mesh, every rank alike."""
    _, _, _, got = runs
    params, loss = cases.noise_losses()[name]
    batch = {k: torch.as_tensor(v)
             for k, v in cases.noise_batch(name).items()}
    gen = torch.Generator().manual_seed(0)
    (want_loss, want_metrics), want = value_and_grad(
        lambda p: loss(p, batch, gen), params, has_aux=True)
    mesh = got[0]["noise"][name]
    assert mesh["grads"].keys() == want.keys()
    for leaf, g in want.items():
        err = np.abs(mesh["grads"][leaf] - g.numpy()).max()
        assert err <= 1e-4 * float(g.abs().max()), (leaf, err)
    for key, value in dict(want_metrics, loss=want_loss).items():
        assert np.abs(mesh["metrics"][key] - value.numpy()).max() < 1e-5, key
    assert mesh["gen"] == int(gen.get_state().sum())
    for r in range(1, WORLD):
        assert got[r]["noise"][name]["gen"] == mesh["gen"]
        for leaf, g in mesh["grads"].items():
            np.testing.assert_array_equal(got[r]["noise"][name]["grads"][
                leaf], g)
