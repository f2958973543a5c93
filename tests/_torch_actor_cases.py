"""Classes and programs the RL-on-actors tests ship to the port's worker
processes by value (``cloudpickle.register_pickle_by_value``): they
import ``ray_tpu_torch``, numpy and torch, never jax, so a port worker
never imports it."""

import os

import numpy as np
import torch

from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl.env_runner import EnvRunner
from ray_tpu_torch.rl.rlhf import pipeline as tpipe


def greedy_sampling() -> None:
    """Deterministic draws in this process: the argmax and the mean (the
    tests' ``greedy`` fixture, for a worker's own module)."""
    tmodels.categorical_sample = \
        lambda gen, logits: torch.argmax(logits, dim=-1)
    tmodels.gaussian_sample = lambda gen, mean, log_std: mean


class ConnRunner(EnvRunner):
    """An EnvRunner that reports its connectors' global state."""

    def connector_globals(self):
        return self._connectors.get_globals()


class GreedyRunner(ConnRunner):
    """A ConnRunner whose process samples greedily (for worker processes
    only: in the tests' own process the ``greedy`` fixture patches, and
    unpatches, the same functions)."""

    def __init__(self, *args, **kwargs):
        greedy_sampling()
        super().__init__(*args, **kwargs)


class FlakyRunner(GreedyRunner):
    """An EnvRunner whose process exits in the ``sample`` after
    ``arm_crash`` (its restarted instance is not armed)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._crash = False

    def arm_crash(self) -> None:
        self._crash = True

    def sample(self, params):
        if self._crash:
            os._exit(1)
        return super().sample(params)


def collective_member(rank: int, world: int, group: str, run) -> dict:
    """Join ``group`` declared on the port's runtime and run ``run(col,
    rank, as_numpy)`` (``_collective_ops.run``) on it."""
    from ray_tpu_torch import collective as col

    col.init_collective_group(world, rank, group)
    try:
        out = run(col, rank, lambda t: np.asarray(t))
        out["stats"] = col.group_stats(group)
        return out
    finally:
        col.destroy_collective_group(group)


class Shipper:
    """An actor that ships a tree and one that fetches it."""

    def ship(self, tree):
        from ray_tpu_torch import collective as col

        return col.ship_params(tree)

    def receipt(self, sid):
        from ray_tpu_torch import collective as col

        return col.shipment_receipt(sid)

    def fetch(self, ticket, drop: bool = False):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.util import chaos

        if drop:
            chaos.arm('{"seed": 1, "faults": [{"site": "rpc.drop", '
                      '"target": "stream_push", "at": 1, "max_fires": 1}]}')
        used0, maps0 = store_used_bytes(), plasma_maps()
        try:
            got, info = col.fetch_params(ticket)
        finally:
            if drop:
                chaos.disarm()
        # what the fetch left in the node's store and mapped here
        info["store_delta"] = store_used_bytes() - used0
        info["maps_delta"] = plasma_maps() - maps0
        return got, info

    def pid(self) -> int:
        return os.getpid()

    def maps(self) -> int:
        return plasma_maps()


def store_used_bytes() -> int:
    """The bytes in this node's object store, as its raylet counts them."""
    from ray_tpu_torch.core.worker import global_worker

    backend = global_worker()._require_backend()
    return backend.io.run(backend._raylet.call(
        "node_stats", {}))["object_store_bytes"]


def plasma_maps() -> int:
    """How many store objects this process holds mapped."""
    from ray_tpu_torch.core.worker import global_worker

    return len(global_worker()._require_backend().plasma._maps)


def spying(cls, methods):
    """``cls`` with each of ``methods`` keeping its last result, read
    back (and cleared) by ``last()``, and ``visible()`` reporting the
    role's ``CUDA_VISIBLE_DEVICES`` and pid."""

    def wrap(name):
        def method(self, *args):
            out = getattr(cls, name)(self, *args)
            self._spied[name] = out
            return out
        return method

    body = {name: wrap(name) for name in methods}

    def last(self):
        out, self._spied = self._spied, {}
        return out

    def visible(self):
        return {"cuda_visible_devices":
                os.environ.get("CUDA_VISIBLE_DEVICES"), "pid": os.getpid()}

    def __init__(self, *args, **kwargs):
        self._spied = {}
        cls.__init__(self, *args, **kwargs)

    body.update(__init__=__init__, last=last, visible=visible)
    return type(cls.__name__, (cls,), body)


SPY_ROLES = {"RLHFGenerator": ("generate",), "RLHFReward": ("score",),
             "RLHFReference": ("logprobs",), "RLHFLearner": ("update",)}


def spy_roles(monkeypatch) -> None:
    """Swap the pipeline's role classes for spying subclasses."""
    for name, methods in SPY_ROLES.items():
        monkeypatch.setattr(tpipe, name,
                            spying(getattr(tpipe, name), methods))
