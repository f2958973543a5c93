"""Learner: gradient updates of a policy tree on one device (port of
``ray_tpu/rl/learner.py``).

``adam_update`` and ``clip_global_norm`` are written out as JAX writes
them (bias correction as a scale, ``eps`` outside the square root, an
integer step count, the norm reported before clipping), not as optax's or
as ``parallel/train_step.py``'s ``Adam``. An ``update`` moves its batch to
the device once and indexes the minibatches there.

``Learner(mesh=...)`` is JAX's multi-device update: JAX jits one loss
over the global minibatch sharded on the mesh's ``dp`` axis with params
replicated, so every reduction inside the loss (PPO's, A2C's and APPO's
advantage normalisation, the losses' means) runs over the whole
minibatch. The port gives the same update with DTensors: each minibatch
(the same global rows on every rank, as JAX's ``device_put`` takes them)
becomes a ``Shard(0)`` DTensor on ``dp`` and the params ``Replicate()``
DTensors (``parallel/sharding.py``'s placements), so DTensor's
propagation turns each reduction over rows into a global one and the
gradients come back as partial sums, which are all-reduced into the
global minibatch's gradient. Clipping and Adam then run on every rank on
the same replicated values, so params, moments and the generator stay
rank-identical. A per-rank loss followed by a gradient all-reduce would
normalise each shard by its own moments instead. A loss that draws noise
from the learner's generator (SAC, CQL, CRR, TD3) draws it through
``models.noise_on_mesh``: each draw is the global noise as a replicated
DTensor, the same on every rank, as JAX's replicated key draws it.

``LearnerGroup`` is JAX's group of learner actors on the port's runtime:
N ``_LearnerActor`` members of a collective group declared on the
runtime (``collective.create_collective_group``; the host plane: gloo on
the cluster backend, the in-process plane on the local one). Rank 0's
initial params are broadcast, and each member's ``Learner`` gets a
gradient sync that allreduces every minibatch's gradients as one flat
host copy and divides by the world size before clipping and Adam (DDP:
params and Adam moments stay identical across members). Each member
runs its learner on ``cuda`` with its GPU share, or on the CPU where the
caller asked for it.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.train_step import _unflatten_like, value_and_grad
from ray_tpu_torch.rl import models


def adam_init(params) -> Dict:
    return {"mu": models.tree_map(torch.zeros_like, params),
            "nu": models.tree_map(torch.zeros_like, params), "t": 0}


@torch.no_grad()
def adam_update(params, grads, state: Dict, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    t = state["t"] + 1
    mu = models.tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                         state["mu"], grads)
    nu = models.tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                         state["nu"], grads)
    mhat_scale = 1.0 / (1 - b1 ** t)
    vhat_scale = 1.0 / (1 - b2 ** t)
    new_params = models.tree_map(
        lambda p, m, v: p - lr * (m * mhat_scale)
        / (torch.sqrt(v * vhat_scale) + eps),
        params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "t": t}


@torch.no_grad()
def clip_global_norm(grads, max_norm: float):
    leaves = list(models._leaves(grads).values())
    norm = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
    scale = torch.clamp(max_norm / (norm + 1e-8), max=1.0)
    return models.tree_map(lambda g: g * scale, grads), norm


def _writable(x):
    """``x``, copied where it is a read-only numpy array (one read from
    the object store maps its bytes read-only; a tensor must not alias
    them)."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        return x.copy()
    return x


def mean_metrics(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Each key's mean over the list as a float (JAX: ``np.mean`` of the
    floats), read from the device once."""
    keys = list(metrics[0])
    table = torch.stack([torch.stack([m[k].float() for k in keys])
                         for m in metrics])
    return dict(zip(keys, table.double().mean(dim=0).tolist()))


class Learner:
    """Holds params and Adam state on one device (``cuda`` unless given)
    and applies minibatch updates.

    ``loss_fn(params, batch, key) -> (loss, metrics_dict)`` is supplied by
    the algorithm; ``key`` is the learner's ``torch.Generator`` (seeded
    with ``seed``), which the on-policy losses do not use.

    With ``mesh`` (a ``parallel/mesh.py`` mesh; every rank of it builds
    the learner with the same arguments and passes the same batches) each
    minibatch is sharded over the mesh's ``dp`` axis and the update is
    the global minibatch's (module docstring); the device is the mesh's,
    so ``device`` may not be given too."""

    def __init__(self, init_params, loss_fn: Callable, lr: float,
                 grad_clip: float = 0.0, mesh=None, seed: int = 0,
                 grad_sync: Optional[Callable] = None,
                 device: DeviceLike = None):
        self._mesh = None
        if mesh is not None:
            if device is not None:
                raise ValueError("pass a mesh or a device, not both: a "
                                 "mesh decides its own device")
            from ray_tpu_torch.parallel import sharding

            self._mesh = sharding.compute_mesh(mesh)
            self._batch_places = sharding.named_sharding(mesh, "dp")
            self._replicated = sharding.named_sharding(mesh)
            device = sharding._mesh_device(self._mesh)
        self.device = resolve_device(device)
        self.params = models.params_to_device(init_params, self.device)
        self.opt_state = adam_init(self.params)
        self._loss_fn = loss_fn
        self._lr = lr
        self._grad_clip = grad_clip
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._grad_sync = grad_sync

    def set_grad_sync(self, grad_sync: Optional[Callable]) -> None:
        """Install a gradient sync (grads tree -> grads tree), applied per
        minibatch BEFORE clipping and the optimizer update."""
        self._grad_sync = grad_sync

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(_writable(v), device=self.device)
                for k, v in batch.items()}

    def update_minibatch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One gradient step on ``batch`` (numpy arrays or tensors); the
        metrics are 0-d tensors on the device (``grad_norm`` where the
        learner clips, and ``loss``)."""
        batch = self._to_device(batch)
        if self._mesh is None:
            (loss, metrics), flat = value_and_grad(
                lambda p: self._loss_fn(p, batch, self._gen), self.params,
                has_aux=True)
        else:
            loss, metrics, flat = self._mesh_loss_and_grads(batch)
        grads = _unflatten_like(self.params, flat)
        if self._grad_sync is not None:
            grads = self._grad_sync(grads)
        if self._grad_clip:
            grads, gnorm = clip_global_norm(grads, self._grad_clip)
            metrics = dict(metrics, grad_norm=gnorm)
        self.params, self.opt_state = adam_update(
            self.params, grads, self.opt_state, self._lr)
        return dict(metrics, loss=loss)

    def _mesh_loss_and_grads(self, batch: Dict[str, torch.Tensor]):
        """(loss, metrics, grads by leaf name) of the global minibatch
        ``batch``: its rows sharded over ``dp`` as DTensors, the params
        replicated, each result's global value as a plain tensor (the
        gradients' partial sums all-reduced)."""
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch.parallel import sharding

        dbatch = {k: sharding.distribute(v, self._mesh, self._batch_places)
                  for k, v in batch.items()}
        dparams = models.tree_map(
            lambda t: DTensor.from_local(t, self._mesh, self._replicated,
                                         run_check=False), self.params)
        with models.noise_on_mesh(self._mesh):
            (loss, metrics), flat = value_and_grad(
                lambda p: self._loss_fn(p, dbatch, self._gen), dparams,
                has_aux=True)

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        return (full(loss), {k: full(v) for k, v in metrics.items()},
                {k: full(g) for k, g in flat.items()})

    def update(self, batch: Dict, *, num_epochs: int = 1,
               minibatch_size: Optional[int] = None,
               shuffle: bool = True, seed: int = 0) -> Dict[str, float]:
        """Epoch/minibatch loop (PPO-style): each epoch a numpy permutation
        from ``default_rng(seed)``, minibatches of ``minibatch_size`` (all
        rows when 0 or None) with the remainder dropped; returns the
        metrics averaged as floats, read from the device once."""
        n = len(next(iter(batch.values())))
        mb = min(minibatch_size or n, n)
        rng = np.random.default_rng(seed)
        batch = self._to_device(batch)
        all_metrics: List[Dict] = []
        for _ in range(num_epochs):
            idx = rng.permutation(n) if shuffle else np.arange(n)
            idx = torch.as_tensor(idx, device=self.device)
            for start in range(0, n - mb + 1, mb):
                sel = idx[start:start + mb]
                all_metrics.append(self.update_minibatch(
                    {k: v[sel] for k, v in batch.items()}))
        return mean_metrics(all_metrics)

    def get_params(self):
        return self.params

    def set_params(self, params) -> None:
        self.params = models.params_to_device(params, self.device)


class _LearnerActor:
    """One member of a LearnerGroup: a local ``Learner`` whose gradients
    are allreduced across the group every minibatch (data parallel)."""

    def __init__(self, rank: int, world: int, group: str,
                 learner_ctor: Callable[..., Learner], device: str):
        from ray_tpu_torch import collective as col

        self._rank, self._world, self._group = rank, world, group
        col.init_collective_group(world, rank, group)
        self._learner: Learner = learner_ctor(device=device)
        self._sync_params()
        self._learner.set_grad_sync(self._allreduce_grads)

    def _allreduce_grads(self, grads):
        """The group's mean gradient: one allreduce of every leaf's host
        copy, flattened and concatenated, then divided by the world."""
        from ray_tpu_torch import collective as col

        leaves = models._leaves(grads)
        flat = torch.cat([g.detach().reshape(-1).cpu()
                          for g in leaves.values()])
        flat = col.allreduce(flat, self._group) / self._world
        out, start = {}, 0
        for name, g in leaves.items():
            out[name] = flat[start:start + g.numel()].reshape(g.shape).to(
                g.device)
            start += g.numel()
        return _unflatten_like(grads, out)

    def _sync_params(self) -> None:
        """Rank 0's params on every member, so all start identical."""
        from ray_tpu_torch import collective as col

        params = self._learner.params
        host = {name: col.broadcast(t.detach().cpu(), 0, self._group)
                for name, t in models._leaves(params).items()}
        self._learner.set_params(_unflatten_like(params, host))

    def ping(self) -> int:
        return self._rank

    def update(self, shard, num_epochs: int, minibatch_size: int,
               seed: int) -> Dict[str, float]:
        # the gradients are allreduced per minibatch, so params and Adam
        # moments stay identical across members: no param averaging
        return self._learner.update(
            shard, num_epochs=num_epochs, minibatch_size=minibatch_size,
            seed=seed)

    def get_params(self):
        """The params as host tensors (the caller may have no GPU)."""
        return models.params_to_device(self._learner.params, "cpu")

    def set_params(self, params) -> None:
        # a copy: on the local backend every member gets the same tree,
        # and an update marks its leaves as requiring grad in place
        self._learner.set_params(models.clone_tree(params))


def _get_in_completion_order(refs: List[Any]) -> List[Any]:
    """The refs' values in their order, read as they complete: the first
    member to fail raises its own error, not a peer's collective timeout
    while it waits for the failed member."""
    import ray_tpu_torch as rt

    values, pending = {}, list(refs)
    while pending:
        ready, pending = rt.wait(pending, num_returns=1)
        values[ready[0]] = rt.get(ready[0])
    return [values[r] for r in refs]


class LearnerGroup:
    """N learner actors doing data-parallel updates with host collectives
    (JAX's). ``learner_ctor(device=...)`` builds one member's ``Learner``
    on ``device`` (``cuda`` unless given); on ``cuda`` each member
    reserves ``num_gpus_per_learner`` GPUs (a fraction shares a card), on
    the CPU none. Needs the port's runtime: without one it raises the
    runtime's "not initialized" error, as JAX's does."""

    _counter = 0

    def __init__(self, learner_ctor: Callable[..., Learner],
                 num_learners: int, num_gpus_per_learner: float = 0,
                 device: DeviceLike = None):
        import ray_tpu_torch as rt
        from ray_tpu_torch import collective as col

        dev = resolve_device(device)
        LearnerGroup._counter += 1
        group = f"learner_group_{os.getpid()}_{LearnerGroup._counter}"
        col.create_collective_group(num_learners, group)
        opts: Dict[str, Any] = {}
        if dev.type == "cuda":
            if not num_gpus_per_learner:
                raise ValueError(
                    "a LearnerGroup on cuda needs num_gpus_per_learner > 0 "
                    "(a fraction shares a card); pass device='cpu' for "
                    "learners on the CPU")
            opts["num_gpus"] = num_gpus_per_learner
        cls = rt.remote(_LearnerActor)
        cls = cls.options(**opts) if opts else cls
        self._actors = [cls.remote(i, num_learners, group, learner_ctor,
                                   dev.type)
                        for i in range(num_learners)]

    @property
    def actors(self) -> List[Any]:
        return list(self._actors)

    def update(self, batch, *, num_epochs: int = 1,
               minibatch_size: Optional[int] = None,
               seed: int = 0) -> Dict[str, float]:
        import ray_tpu_torch as rt

        n = len(next(iter(batch.values())))
        world = len(self._actors)
        # equal shards (the remainder dropped): the per-minibatch
        # allreduce is rank-synchronous, so every learner must run the
        # same number of minibatches or the group deadlocks
        n_even = n - (n % world)
        mb = minibatch_size or n_even // world
        results = _get_in_completion_order([
            a.update.remote(
                {k: v[i:n_even:world] for k, v in batch.items()},
                num_epochs, mb, seed)
            for i, a in enumerate(self._actors)])
        return {k: float(np.mean([r[k] for r in results]))
                for k in results[0]}

    def get_params(self):
        import ray_tpu_torch as rt

        return rt.get(self._actors[0].get_params.remote())

    def set_params(self, params) -> None:
        import ray_tpu_torch as rt

        params = models.params_to_device(params, "cpu")
        rt.get([a.set_params.remote(params) for a in self._actors])

    def stop(self) -> None:
        """Kill the learner actors (no restart)."""
        import ray_tpu_torch as rt

        for a in self._actors:
            try:
                rt.kill(a, no_restart=True)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self._actors = []
