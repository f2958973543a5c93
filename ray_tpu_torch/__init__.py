"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper
(sm_90a).

Mirrors ``ray_tpu``'s module layout so each counterpart is easy to find:
the runtime (``core/``, ``cluster/``, ``scheduler/``, ``_private/``, tasks,
actors, the object plane and the cluster scheduler, with GPUs as the
per-instance accelerator) and the libraries on it (``train/``), the model
path (``ops/``, ``models/``, ``parallel/``) and RL (``rl/``). Imports torch
and numpy only, never jax and never ``ray_tpu``; the runtime modules import
torch only where a value is a tensor. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on a CUDA tensor every ported kernel
launches the hand-written kernel under ``csrc/`` or raises.

This file exports JAX's top-level runtime API (``ray_tpu/__init__.py``).
"""

from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID  # noqa: F401
from ray_tpu_torch.core.actor import ActorClass, ActorHandle, method  # noqa: F401
from ray_tpu_torch.core.api import RemoteFunction, remote  # noqa: F401
from ray_tpu_torch.core.object_ref import ObjectRef  # noqa: F401
from ray_tpu_torch.cluster.worker_core import ObjectRefGenerator  # noqa: F401
from ray_tpu_torch.core.worker import (  # noqa: F401
    global_worker,
    init,
    is_initialized,
    shutdown,
)
from ray_tpu_torch.runtime_context import get_runtime_context  # noqa: F401
from ray_tpu_torch import exceptions  # noqa: F401


def timeline(filename=None):
    """JAX's ``timeline()`` reads the cluster's task-event store; its
    cluster lanes are a later slice of the port. The step lanes are
    ``ray_tpu_torch.util.timeline.step_timeline``."""
    raise NotImplementedError(
        "timeline()'s cluster lanes are not ported yet (ROADMAP item R5); "
        "ray_tpu_torch.util.timeline.step_timeline draws the step lanes")


def memory_summary(**kwargs):
    """JAX's cluster memory report (``rt memory``'s twin), a later slice
    of the port."""
    raise NotImplementedError(
        "memory_summary() is not ported yet (ROADMAP item R5, with the CLI)")

__version__ = "0.1.0"


def put(value):
    """Store ``value`` in the object plane; returns an ObjectRef."""
    return global_worker().put(value)


def get(refs, *, timeout=None):
    """Fetch the value(s) of ObjectRef(s), blocking until available."""
    return global_worker().get(refs, timeout)


def wait(refs, *, num_returns=1, timeout=None, fetch_local=True):
    """Block until ``num_returns`` of ``refs`` are ready."""
    return global_worker().wait(refs, num_returns, timeout)


def kill(actor, *, no_restart=True):
    """Forcibly terminate an actor."""
    from ray_tpu_torch.core.actor import ActorHandle as _AH

    if not isinstance(actor, _AH):
        raise TypeError("kill() expects an ActorHandle")
    global_worker()._require_backend().kill_actor(actor._actor_id, no_restart)


def cancel(ref, *, force=False):
    """Request cancellation of the task that produces ``ref``."""
    global_worker()._require_backend().cancel(ref, force)


def internal_free(refs):
    """Eagerly delete objects from the object plane (reference:
    ``ray._private.internal_api.free``)."""
    if not isinstance(refs, (list, tuple)):
        refs = [refs]
    global_worker()._require_backend().free_objects(list(refs))


def get_actor(name, namespace=None):
    """Look up a named actor."""
    return global_worker()._require_backend().get_actor_handle(name, namespace)


def cluster_resources():
    return global_worker()._require_backend().cluster_resources()


def available_resources():
    return global_worker()._require_backend().available_resources()


def nodes():
    return global_worker()._require_backend().nodes()


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "method", "put", "get",
    "wait", "kill", "cancel", "get_actor", "internal_free",
    "memory_summary",
    "cluster_resources",
    "available_resources", "nodes", "get_runtime_context", "ObjectRef",
    "ActorClass", "ActorHandle", "RemoteFunction", "exceptions",
]
