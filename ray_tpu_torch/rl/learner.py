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
``LearnerGroup`` (learner actors syncing gradients through the cluster's
collectives) waits for RL on the port's actors (ROADMAP item R2).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

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
        return {k: torch.as_tensor(v, device=self.device)
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


class LearnerGroup:
    """JAX's data-parallel group of learner actors: not ported yet
    (ROADMAP item R2, RL on the port's actors)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "LearnerGroup (num_learners > 0) needs learner actors on the "
            "port's runtime, which are not ported yet (ROADMAP item R2)")
