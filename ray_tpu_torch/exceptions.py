"""Public exception types.

Mirrors the capability surface of the reference's ``python/ray/exceptions.py``:
task errors wrap the remote traceback, actor death and object loss are
distinguishable, and ``get`` timeouts are their own type.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at ``get`` with the remote trace.

    Equivalent of the reference's ``RayTaskError``.
    """

    def __init__(self, function_name: str, cause: BaseException, remote_tb: Optional[str] = None):
        self.function_name = function_name
        self.cause = cause
        self.remote_traceback = remote_tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        super().__init__(
            f"task {function_name} failed: {type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{self.remote_traceback}"
        )

    def __reduce__(self):
        return (
            _rebuild_task_error,
            (self.function_name, type(self.cause).__name__, str(self.cause), self.remote_traceback),
        )


class _RemoteCause(Exception):
    """Stand-in for a remote exception type that may not import locally."""

    def __init__(self, type_name: str, msg: str):
        self.type_name = type_name
        super().__init__(f"{type_name}: {msg}")


def _rebuild_task_error(fn, cause_type, cause_msg, tb):
    return TaskError(fn, _RemoteCause(cause_type, cause_msg), tb)


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """The actor is dead (crashed, killed, or out of restarts).

    ``cause`` carries the structured death cause (``core/failure.py`` wire
    dict: category, message, restart count, last node) when the GCS knows
    it — so the caller-side error says exactly what ``rt list actors`` and
    ``rt errors`` know, and ``rt trace`` and the exception agree on why.
    """

    def __init__(self, actor_id=None, reason: str = "", cause=None):
        self.actor_id = actor_id
        self.reason = reason
        self.cause_info = dict(cause) if cause else None
        msg = f"actor {actor_id} died: {reason}"
        if self.cause_info:
            extras = [f"category={self.cause_info.get('category')}"]
            if self.cause_info.get("num_restarts") is not None:
                extras.append(
                    f"restarts={self.cause_info['num_restarts']}")
            if self.cause_info.get("node_id"):
                extras.append(
                    f"last_node={str(self.cause_info['node_id'])[:8]}")
            msg += f" ({', '.join(extras)})"
        super().__init__(msg)

    def __reduce__(self):
        # default Exception pickling would reconstruct with the formatted
        # message as actor_id, double-wrapping the text on every serde hop
        return (ActorDiedError, (self.actor_id, self.reason,
                                 self.cause_info))


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ActorUnschedulableError(ActorError):
    """The actor stayed PENDING_CREATION/RESTARTING past a caller-supplied
    deadline (e.g. an infeasible resource request on a cluster that will
    never grow). Only raised when a deadline is requested — by default
    callers block like the reference does."""

    def __init__(self, actor_id=None, state: str = "", waited_s: float = 0.0):
        self.actor_id = actor_id
        self.state = state
        self.waited_s = waited_s
        super().__init__(
            f"actor {actor_id} still {state} after {waited_s:.0f}s deadline — "
            f"likely an infeasible resource request (check num_cpus/num_gpus "
            f"against the cluster)")

    def __reduce__(self):
        return (ActorUnschedulableError,
                (self.actor_id, self.state, self.waited_s))


class ObjectLostError(RayTpuError):
    """All copies of an object were lost and it could not be reconstructed."""

    def __init__(self, object_id=None, cause=None):
        self.object_id = object_id
        self.cause_info = dict(cause) if cause else None
        msg = f"object {object_id} lost"
        if self.cause_info and self.cause_info.get("message"):
            msg += f": {self.cause_info['message']}"
        super().__init__(msg)

    def __reduce__(self):
        return (type(self), (self.object_id, self.cause_info))


class OwnerDiedError(ObjectLostError):
    """The object's owner process died — its memory-store copy and lineage
    are gone with it (reference: ``OWNER_DIED`` in common.proto)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` exceeded its timeout."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"task {task_id} cancelled")


class OutOfMemoryError(RayTpuError):
    """The raylet's memory monitor killed this task's worker to keep the
    node alive (reference: ``worker_killing_policy.cc``; the task is
    retried if it has retries left)."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class BackpressureError(RayTpuError):
    """The raylet bounced this submission: the task's scheduling class is
    at its admission bound (``RT_MAX_QUEUED_PER_CLASS``) and the task
    opted into fail-fast via ``.options(on_overload="fail")``. Default
    submissions never see this — they block with backoff until the queue
    drains."""

    def __init__(self, message: str = "", queue_depth=None, limit=None):
        self.queue_depth = queue_depth
        self.limit = limit
        super().__init__(message or "task rejected under overload "
                                    "(scheduling-class queue at bound)")

    def __reduce__(self):
        return (BackpressureError,
                (self.args[0] if self.args else "",
                 self.queue_depth, self.limit))


class SchedulingTimeoutError(RayTpuError):
    """The task's ``deadline_s`` budget expired while it was still queued
    in the raylet — the work was shed instead of executed late.
    ``cause_info`` carries the structured ``scheduling_timeout`` cause
    (core/failure.py wire dict) so the raised error and ``rt errors``
    agree on why."""

    def __init__(self, message: str = "", cause=None):
        self.cause_info = dict(cause) if cause else None
        super().__init__(message or "scheduling deadline exceeded in the "
                                    "raylet queue")

    def __reduce__(self):
        return (SchedulingTimeoutError,
                (self.args[0] if self.args else "", self.cause_info))


class RuntimeEnvSetupError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    """A node (its raylet) died; tasks/actors/objects there are gone."""

    def __init__(self, node_id=None, cause=None):
        self.node_id = node_id
        self.cause_info = dict(cause) if cause else None
        msg = f"node {node_id} died"
        if self.cause_info and self.cause_info.get("message"):
            msg += f": {self.cause_info['message']}"
        super().__init__(msg)

    def __reduce__(self):
        return (NodeDiedError, (self.node_id, self.cause_info))
