"""Death-cause taxonomy: every failure in the system gets a typed cause.

Reference analog: ``src/ray/protobuf/common.proto`` — ``RayErrorInfo`` /
``ActorDeathCause`` / ``ErrorType``. The runtime used to speak in plain
strings (``death_reason = ""``); this module gives each kill/except site a
structured :class:`FailureCause` that

  - carries a **category** from a closed enum (mapped onto the public
    ``exceptions.py`` classes),
  - still renders as a human string (``str(cause)``) so existing
    death-reason plumbing keeps printing sensibly,
  - serializes to a plain dict for the RPC wire and the GCS
    ``failure_events`` store (``rt errors`` / ``/api/errors`` / the
    timeline's ``errors`` lane read it back).

Counting happens in exactly ONE place: the GCS increments
``rt_failures_total{category=}`` per stored report in
``GcsServer._record_failure`` (its registry is shipped by the co-resident
pusher — the driver's, or the head raylet's for standalone daemons).
Emitters must NOT call :func:`observe_failure` themselves — a local count
plus the GCS count would double every failure and skew the
``scripts/alert_rules.yml`` thresholds.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, Optional, Type

# ---- the category enum ------------------------------------------------------
# Categories map 1:1 onto exceptions.py classes (see EXCEPTION_FOR); keep
# the values kebab-free snake_case — they are Prometheus label values.
TASK_ERROR = "task_error"                        # TaskError
WORKER_CRASH = "worker_crash"                    # WorkerCrashedError
OOM_KILL = "oom_kill"                            # OutOfMemoryError
NODE_DEATH = "node_death"                        # NodeDiedError
ACTOR_RESTART_EXHAUSTED = "actor_restart_exhausted"  # ActorDiedError
SCHEDULING_TIMEOUT = "scheduling_timeout"        # ActorUnschedulableError
PG_REMOVED = "pg_removed"                        # ActorDiedError (bundle gone)
RUNTIME_ENV_SETUP = "runtime_env_setup"          # RuntimeEnvSetupError
OBJECT_LOST = "object_lost"                      # ObjectLostError
OWNER_DIED = "owner_died"                        # OwnerDiedError
GET_TIMEOUT = "get_timeout"                      # GetTimeoutError
CANCELLED = "cancelled"                          # TaskCancelledError / kill()
UNKNOWN = "unknown"                              # free-text legacy reasons

CATEGORIES = (
    TASK_ERROR, WORKER_CRASH, OOM_KILL, NODE_DEATH,
    ACTOR_RESTART_EXHAUSTED, SCHEDULING_TIMEOUT, PG_REMOVED,
    RUNTIME_ENV_SETUP, OBJECT_LOST, OWNER_DIED, GET_TIMEOUT, CANCELLED,
    UNKNOWN,
)


def _exception_map() -> Dict[str, Type[BaseException]]:
    # lazy: exceptions.py is import-light, but keep the module cycle-free
    from ray_tpu_torch import exceptions as E

    return {
        TASK_ERROR: E.TaskError,
        WORKER_CRASH: E.WorkerCrashedError,
        OOM_KILL: E.OutOfMemoryError,
        NODE_DEATH: E.NodeDiedError,
        ACTOR_RESTART_EXHAUSTED: E.ActorDiedError,
        SCHEDULING_TIMEOUT: E.ActorUnschedulableError,
        PG_REMOVED: E.ActorDiedError,
        RUNTIME_ENV_SETUP: E.RuntimeEnvSetupError,
        OBJECT_LOST: E.ObjectLostError,
        OWNER_DIED: E.OwnerDiedError,
        GET_TIMEOUT: E.GetTimeoutError,
        CANCELLED: E.TaskCancelledError,
        UNKNOWN: E.RayTpuError,
    }


def exception_class_for(category: str) -> Type[BaseException]:
    """The public exception class a category surfaces as at ``get`` time."""
    return _exception_map().get(category, _exception_map()[UNKNOWN])


class FailureCause:
    """A categorized death cause. Renders as a string (so every site that
    used to store/print a free-text ``death_reason`` keeps working) and
    round-trips through :meth:`to_dict` / :meth:`from_value` for the wire."""

    __slots__ = ("category", "message", "context")

    def __init__(self, category: str, message: str = "",
                 **context: Any):
        self.category = category if category in CATEGORIES else UNKNOWN
        self.message = message
        # node_id / actor_id / task_id / worker_id / num_restarts / ...
        self.context = {k: v for k, v in context.items() if v is not None}

    def __str__(self) -> str:
        return self.message or self.category

    def __repr__(self) -> str:
        return f"FailureCause({self.category!r}, {self.message!r})"

    def to_dict(self) -> Dict[str, Any]:
        d = {"category": self.category, "message": self.message}
        d.update(self.context)
        return d

    @classmethod
    def from_value(cls, value: Any) -> "FailureCause":
        """Coerce wire dicts, plain strings (legacy reasons) and causes."""
        if isinstance(value, FailureCause):
            return value
        if isinstance(value, dict):
            d = dict(value)
            return cls(d.pop("category", UNKNOWN), d.pop("message", ""), **d)
        return cls(UNKNOWN, str(value or ""))


def cause_dict(category: str, message: str = "", **context: Any
               ) -> Dict[str, Any]:
    """Shorthand for the wire form (what rides RPC payloads + the store)."""
    return FailureCause(category, message, **context).to_dict()


def categorize_exception(exc: BaseException) -> str:
    """Best-effort category for an arbitrary exception (used where a raw
    exception crosses a kill/except site without a structured cause)."""
    from ray_tpu_torch import exceptions as E

    if isinstance(exc, E.OutOfMemoryError):
        return OOM_KILL
    if isinstance(exc, E.WorkerCrashedError):
        return WORKER_CRASH
    if isinstance(exc, E.NodeDiedError):
        return NODE_DEATH
    if isinstance(exc, E.ActorUnschedulableError):
        return SCHEDULING_TIMEOUT
    if isinstance(exc, E.OwnerDiedError):
        return OWNER_DIED
    if isinstance(exc, E.ObjectLostError):
        return OBJECT_LOST
    if isinstance(exc, E.GetTimeoutError):
        return GET_TIMEOUT
    if isinstance(exc, E.TaskCancelledError):
        return CANCELLED
    if isinstance(exc, E.RuntimeEnvSetupError):
        return RUNTIME_ENV_SETUP
    if isinstance(exc, E.ActorDiedError):
        return ACTOR_RESTART_EXHAUSTED
    if isinstance(exc, E.TaskError):
        return TASK_ERROR
    return UNKNOWN


# ---- recovery pacing --------------------------------------------------------

def backoff_with_jitter(attempt: int, base_s: float, cap_s: float,
                        rng: Optional[random.Random] = None) -> float:
    """Capped exponential backoff with +-25% jitter — the one pacing
    function for every recovery loop (RPC reconnect re-dials, GCS
    restart-storm damping). ``attempt`` is 1-based; the uncapped delay
    doubles per attempt and the jitter keeps a fleet of reconnecting
    clients (or a gang of crash-looping actors) from re-dialing in
    lockstep."""
    delay = min(cap_s, base_s * (2 ** max(0, attempt - 1)))
    r = (rng.random() if rng is not None else random.random())
    return delay * (0.75 + 0.5 * r)


# ---- the one fire-and-forget emitter ---------------------------------------

class EmitLimiter:
    """Client-side rate limit for failure emission: at most one event per
    key per window. The GCS dedups *rows*; this caps the *RPCs* — a
    polling get() loop, a hot failing map, or a PG burst must not stream
    one GCS call per occurrence. Shared by every emitter so the window and
    prune logic have exactly one author."""

    def __init__(self, window_s: float = 30.0, cap: int = 512):
        self.window_s = window_s
        self.cap = cap
        self._last: Dict[Any, float] = {}

    def allow(self, key: Any) -> bool:
        now = time.monotonic()
        last = self._last.get(key)
        if last is not None and now - last < self.window_s:
            return False
        self._last[key] = now
        if len(self._last) > self.cap:
            cutoff = now - self.window_s
            kept = {k: t for k, t in self._last.items() if t > cutoff}
            if len(kept) > self.cap:
                # everything is inside the window (unique-key burst):
                # hard-cap to the newest half so the prune actually
                # shrinks — never O(n) rebuild per insert
                kept = dict(sorted(kept.items(),
                                   key=lambda kv: kv[1])[-self.cap // 2:])
            self._last = kept
        return True

def emit_raw(spawn: Callable, gcs, payload: Dict[str, Any],
             timeout: float = 10.0) -> None:
    """Ship one PRE-BUILT FailureEvent dict (chaos injections, recovery
    notices, drained buffers) without ever blocking or failing the caller
    — the raw-payload twin of :func:`emit`, so the wire send still has
    exactly one author."""
    async def _send():
        try:
            await gcs.call("failure_event", payload, timeout=timeout)
        except Exception:  # noqa: BLE001 — observability only
            pass

    try:
        spawn(_send())
    except Exception:  # noqa: BLE001 — teardown race
        pass


def emit(spawn: Callable, gcs, category: str, message: str,
         node_id: Optional[str] = None, timeout: float = 10.0,
         **fields: Any) -> None:
    """Ship one FailureEvent to the GCS ``failure_events`` store without
    ever blocking or failing the caller. Shared by every emitter (raylet,
    owner process, executing worker) so the wire shape has exactly one
    author. ``spawn`` is the site's coroutine launcher (``spawn_task`` on
    the raylet loop, ``io.spawn`` elsewhere); ``gcs`` anything with an
    async ``call``."""
    async def _send():
        try:
            msg: Dict[str, Any] = {"category": category, "message": message,
                                   "t": time.time()}
            if node_id is not None:
                msg["node_id"] = node_id
            msg.update({k: v for k, v in fields.items() if v is not None})
            await gcs.call("failure_event", msg, timeout=timeout)
        except Exception:  # noqa: BLE001 — observability only
            pass

    try:
        spawn(_send())
    except Exception:  # noqa: BLE001 — teardown race
        pass


# ---- Prometheus twin --------------------------------------------------------

_failures_counter = None


def observe_failure(category: str) -> None:
    """``rt_failures_total{category=}``: one increment per emitted failure
    event, in the emitting process's registry. Never raises — failure
    telemetry must not compound the failure it is recording."""
    global _failures_counter
    try:
        from ray_tpu_torch.util import metrics as M

        if _failures_counter is None:
            _failures_counter = M.get_or_create(
                M.Counter, "rt_failures_total",
                "Failure events by death-cause category",
                tag_keys=("category",))
        _failures_counter.inc(1.0, {"category": category
                                    if category in CATEGORIES else UNKNOWN})
    except Exception:  # noqa: BLE001
        pass
