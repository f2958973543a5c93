"""Helpers of the off-policy, multi-agent and model-based parity tests
(``test_torch_rl_value.py``, ``test_torch_rl_continuous.py``,
``test_torch_rl_offline.py``, ``test_torch_rl_multi_agent.py``,
``test_torch_rl_qmix_maddpg.py``, ``test_torch_rl_meta.py``,
``test_torch_rl_dreamer.py``, ``test_torch_rl_pixel_bandits.py``,
``test_torch_rl_es.py``, ``test_torch_rl_alphazero.py``,
``test_torch_rl_dt_slateq.py``): tree comparison, JAX algorithms built
without their actors (or with their actors in this process,
``local_actors``), JAX's closures, and the replay of JAX's noise and
categorical draws through the port's noise helpers.

Conventions of those tests: CPU, float32 on both sides, torch on one
thread, JAX's params carried across with ``rl_params_from_jax`` (init is
never compared). Values and losses within 1e-5 absolute
(tests/test_long_context.py:34); params after updates and gradients
within 1e-4 of the reference's max |value| per leaf (:57).
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl.env import EnvSpec as JEnvSpec
from ray_tpu.rl.env_runner import EnvRunner as JEnvRunnerActor
from ray_tpu_torch.models.convert import rl_params_from_jax
from ray_tpu_torch.parallel.train_step import _leaves, value_and_grad

JEnvRunner = JEnvRunnerActor._cls
ATOL, REL = 1e-5, 1e-4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def assert_tree_close(got, want, tol=REL):
    """Every leaf of the port's tree within ``tol`` of JAX's max |value|."""
    got = {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
           for k, v in _leaves(got).items()}
    want = {k: np.asarray(v) for k, v in _leaves(np_tree(want)).items()}
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert rel(got[name], want[name]) < tol, (name,
                                                  rel(got[name], want[name]))


def tree_equal(a, b) -> bool:
    """Two port trees of one structure equal leaf for leaf, bit for bit."""
    la, lb = _leaves(a), _leaves(b)
    return la.keys() == lb.keys() and all(
        torch.equal(la[k].cpu(), lb[k].cpu()) for k in la)


def assert_metrics_close(got: dict, want: dict):
    """A trainable's result against JAX's: the same keys, every float
    (the wall clock aside) within 1e-5 of JAX's, relative above 1."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float) and k != "time_total_s":
            assert abs(got[k] - v) < ATOL * max(1.0, abs(v)), (k, got[k], v)


def jspec(spec):
    return JEnvSpec(**dataclasses.asdict(spec))


def jax_algo(cls, cfg, spec, **attrs):
    """A JAX algorithm with config and spec set and ``build_learner`` run,
    without ``setup`` (no runner actors, no cluster)."""
    algo = cls.__new__(cls)
    algo.config, algo.spec = cfg, jspec(spec)
    algo._env_steps_total = 0
    algo.runners = []
    for k, v in attrs.items():
        setattr(algo, k, v)
    algo.build_learner()
    return algo


def drive_jax_sampling(jalgo, runners):
    """JAX's ``synchronous_sample`` and ``collect_episode_stats`` over
    plain-class runners in this process (no connectors)."""
    def sample(params):
        frags = [r.sample(params) for r in runners]
        batch = {k: np.concatenate([f[k] for f in frags]) for k in frags[0]}
        n = len(batch["rewards"])
        jalgo._env_steps_total += n
        return {k: v for k, v in batch.items() if len(v) == n}

    jalgo.synchronous_sample = sample
    jalgo.collect_episode_stats = lambda: {}


def carry(jparams, algo_or_tree, device="cpu"):
    """JAX's numpy tree as the port's, checked against the port's init."""
    like = (algo_or_tree.get_params() if hasattr(algo_or_tree, "get_params")
            else algo_or_tree)
    return rl_params_from_jax(np_tree(jparams), like, device=device)


def to_torch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def grads_of(loss_fn, params, batch, gen=None):
    """(loss, metrics, grads by leaf path) of the port's loss."""
    (loss, metrics), grads = value_and_grad(
        lambda p: loss_fn(p, batch, gen), params, has_aux=True)
    return loss, metrics, grads


def jax_grads_of(loss_fn, params, batch, key):
    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, batch, key)
    return loss, metrics, {k: np.asarray(v)
                           for k, v in _leaves(np_tree(grads)).items()}


def assert_loss_parity(tloss_fn, tparams, jloss_fn, jparams, batch, key,
                       gen=None):
    """Loss and every metric within 1e-5 absolute, every gradient within
    1e-4 of JAX's max |value| per leaf."""
    jl, jm, jg = jax_grads_of(jloss_fn, jparams,
                              {k: jax.numpy.asarray(v)
                               for k, v in batch.items()}, key)
    tl, tm, tg = grads_of(tloss_fn, tparams, to_torch(batch), gen)
    assert abs(float(tl) - float(jl)) < ATOL * max(1.0, abs(float(jl)))
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm[k]),
                                   rtol=0, atol=ATOL * max(
                                       1.0, float(np.abs(jm[k]).max())),
                                   err_msg=k)
    assert tg.keys() == jg.keys()
    for k in jg:
        if not np.any(jg[k]):
            assert not torch.any(tg[k]), k     # a leaf the loss stops
        else:
            assert rel(tg[k], jg[k]) < REL, (k, rel(tg[k], jg[k]))
    return tl, tm


class JaxDraws:
    """Stands in for ``models.normal`` / ``models.uniform`` of the port:
    each call returns the draw JAX's loss makes at the same point, by
    replaying JAX's key chain (``Learner`` splits its key before each
    update, the loss splits the sub-key into ``n_keys``, or uses it
    whole when ``n_keys`` is 0, and draws from each in turn)."""

    def __init__(self, seed: int, n_keys: int):
        self.key = jax.random.key(seed)
        self.n_keys = n_keys
        self.pending = []
        self.calls = 0

    @classmethod
    def of_key(cls, key, n_keys: int) -> "JaxDraws":
        """The draws of one loss call that JAX makes with ``key``."""
        draws = cls(0, n_keys)
        draws.pending = (list(jax.random.split(key, n_keys)) if n_keys
                         else [key])
        return draws

    @classmethod
    def of_keys(cls, keys) -> "JaxDraws":
        """One draw from each of ``keys`` in turn, and no more."""
        draws = cls(0, 0)
        draws.key = None
        draws.pending = list(keys)
        return draws

    def _next_key(self):
        if not self.pending:
            assert self.key is not None, "more draws than JAX's keys"
            self.key, sub = jax.random.split(self.key)
            self.pending = (list(jax.random.split(sub, self.n_keys))
                            if self.n_keys else [sub])
        return self.pending.pop(0)

    def normal(self, gen, shape):
        self.calls += 1
        draw = jax.random.normal(self._next_key(), tuple(shape))
        return torch.tensor(np.asarray(draw), device=gen.device)

    def uniform(self, gen, shape, low, high):
        self.calls += 1
        draw = jax.random.uniform(self._next_key(), tuple(shape),
                                  minval=low, maxval=high)
        return torch.tensor(np.asarray(draw), device=gen.device)

    def gumbel(self, gen, shape, dtype=torch.float32):
        """``jax.random.categorical(key, logits)`` is the argmax of
        ``logits + jax.random.gumbel(key, logits.shape)``, so the port's
        ``categorical_sample`` through this draw picks JAX's category."""
        self.calls += 1
        draw = jax.random.gumbel(self._next_key(), tuple(shape))
        return torch.tensor(np.asarray(draw), device=gen.device)

    def install(self, monkeypatch, tmodels, gumbel: bool = False):
        monkeypatch.setattr(tmodels, "normal", self.normal)
        monkeypatch.setattr(tmodels, "uniform", self.uniform)
        if gumbel:
            monkeypatch.setattr(tmodels, "gumbel", self.gumbel)


def closure(fn, name: str):
    """The function ``name`` that ``fn`` (a jitted or wrapped closure of a
    JAX algorithm's ``setup``) closes over."""
    while hasattr(fn, "__wrapped__"):
        fn = fn.__wrapped__
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells[name].cell_contents


@pytest.fixture(scope="module")
def one_thread():
    """Torch on one thread for a test module (a tiny step on a contended
    CPU's thread pool is many times slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def shares_storage(a, b) -> list:
    """Leaf paths where two trees of one structure share storage."""
    la, lb = _leaves(a), _leaves(b)
    return [k for k in la
            if la[k].untyped_storage().data_ptr()
            == lb[k].untyped_storage().data_ptr()]


class _LocalHandle:
    """An actor handle whose ``.method.remote(...)`` runs the method on
    an in-process instance and returns its value (the "ref")."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        return SimpleNamespace(remote=getattr(self._obj, name))


class _LocalActorClass:
    """Stands in for an ``ActorClass``: ``.options(...)`` is ignored and
    ``.remote(*args)`` builds the actor's own class (``ActorClass._cls``)
    in this process."""

    def __init__(self, actor_class):
        self._cls = actor_class._cls

    def options(self, **_):
        return self

    def remote(self, *args, **kwargs):
        return _LocalHandle(self._cls(*args, **kwargs))


def local_actors(monkeypatch, module, *names):
    """JAX's actors ``names`` of ``module`` built in this process, and
    ``ray_tpu.get`` / ``ray_tpu.kill`` in the module's namespace the
    identity and a no-op: no cluster starts."""
    for name in names:
        monkeypatch.setattr(module, name,
                            _LocalActorClass(getattr(module, name)))
    monkeypatch.setattr(module, "ray_tpu", SimpleNamespace(
        get=lambda refs: refs, kill=lambda handle: None))
