"""Env-overridable configuration flags.

Equivalent of the reference's ``RayConfig`` flag system
(``src/ray/common/ray_config_def.h`` — 207 ``RAY_CONFIG(type, name, default)``
entries, each overridable via a ``RAY_<name>`` env var). Here every flag is a
typed attribute on :class:`Config`, overridable via ``RT_<NAME>`` env vars, and
a single immutable snapshot is taken at import so all processes of a session
see consistent values (the snapshot is also serialized to spawned workers).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any

_ENV_PREFIX = "RT_"


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


def session_root_default(name: str) -> str:
    """``<the temporary directory>/<name>``, following ``TMPDIR``."""
    return os.path.join(tempfile.gettempdir(), name)


@dataclasses.dataclass
class Config:
    """All runtime flags. Override any field with ``RT_<UPPERCASE_NAME>``."""

    # ---- session / process tree -------------------------------------------
    # Under the process's temporary directory (``TMPDIR``), beside and
    # apart from JAX's ``/tmp/ray_tpu``: two checkouts run with their own
    # ``TMPDIR`` never share logs, caches or ``session_latest.json``.
    session_dir_root: str = dataclasses.field(
        default_factory=lambda: session_root_default("ray_tpu_torch"))
    # Interface every RPC server binds ("" = loopback). Multi-host clusters
    # set 0.0.0.0 (rt start --host); servers then advertise the machine's
    # outbound IP so cross-host peers dial a reachable address.
    bind_host: str = ""
    head_port: int = 0  # 0 = pick a free port
    node_manager_port: int = 0
    num_workers_soft_limit: int = 0  # 0 = num_cpus of the node
    # idle pooled workers beyond the soft limit are reaped after this long
    # (reference: idle worker killing in the raylet worker pool) — bounds
    # process growth when jobs cycle through many runtime envs
    idle_worker_ttl_s: float = 120.0
    worker_register_timeout_s: float = 30.0
    process_startup_timeout_s: float = 30.0
    # Extra startup budget for workers that must materialize a runtime env
    # before announcing ready (pip installs can dwarf plain process spawn).
    runtime_env_setup_timeout_s: float = 600.0
    graceful_shutdown_timeout_s: float = 5.0

    # ---- scheduling --------------------------------------------------------
    # Hybrid policy knobs (reference: raylet/scheduling/policy/
    # hybrid_scheduling_policy.h:29-48): prefer available nodes, rank by
    # critical-resource utilization, spill above this threshold.
    scheduler_spread_threshold: float = 0.5
    scheduler_top_k_fraction: float = 0.2
    lease_timeout_s: float = 10.0
    max_pending_lease_requests_per_key: int = 10
    # A queued-but-not-running task waits this long before the raylet asks
    # the GCS for another node with free capacity (load-based spillback,
    # reference: ScheduleAndDispatchTasks spillback). Bounded hops.
    spillback_delay_s: float = 0.1
    spillback_max_hops: int = 2
    # ---- overload robustness (fair dispatch / admission / deadlines) -------
    # Admission control (reference: the raylet rejecting leases under
    # backlog pressure): each scheduling class's raylet queue is bounded;
    # a submit beyond the bound is bounced with a ``backpressure`` reply
    # that the owner blocks-with-backoff on by default (fail-fast is a
    # per-task opt-in via ``.options(on_overload="fail")``). 0 = unbounded.
    max_queued_per_class: int = 20000
    # Owner-side pacing between backpressured resubmits (capped
    # exponential + jitter via failure.backoff_with_jitter).
    backpressure_retry_base_s: float = 0.05
    backpressure_retry_max_s: float = 2.0
    # Warm worker pool (reference: ``worker_pool.h`` prestart): keep this
    # many plain (no-GPU, no-runtime-env) workers idle so cold task
    # dispatch and actor creation stop paying interpreter boot. 0 = off.
    worker_prestart_floor: int = 0
    # Actor creation adopts an idle pooled worker instead of forking a
    # fresh interpreter when the actor needs no GPUs and no runtime
    # env (a cold spawn's cost is pure process boot).
    worker_adopt_for_actors: bool = True
    # Raylet->GCS task-event chatter coalesces into one batched flush per
    # interval instead of one RPC per state change on the submit hot path.
    task_event_flush_s: float = 0.1

    # ---- object store ------------------------------------------------------
    # Objects <= this many bytes are stored in the owner's in-process memory
    # store and travel inline in RPCs (reference: core_worker memory store).
    max_direct_call_object_size: int = 100 * 1024
    object_store_memory_bytes: int = 0  # 0 = 30% of system memory, capped
    object_store_default_cap_bytes: int = 2 * 1024**3
    object_transfer_chunk_bytes: int = 8 * 1024**2
    object_spilling_dir: str = ""  # "" = <session_dir>/spill
    object_spill_threshold: float = 0.8
    # ---- memory observability ----------------------------------------------
    # Ownership/reference ledger (reference: the core worker's
    # ReferenceCounter behind `ray memory`): per-process table of owned
    # objects with owner, size, state and ref kinds, aggregated by
    # memory_summary() / `rt memory`. Off = zero bookkeeping per ObjectRef.
    object_ledger: bool = True
    # Capture the Python call site that created each ref (Ray parity:
    # RAY_record_ref_creation_sites). Costs a stack walk per ref — opt-in.
    record_ref_creation_sites: bool = False
    # An owned object older than this whose only references are local refs
    # in the driver is flagged as a leak suspect by memory_summary().
    memory_leak_age_s: float = 300.0

    # ---- health / fault tolerance -----------------------------------------
    heartbeat_interval_s: float = 1.0
    node_death_timeout_s: float = 10.0
    # Overall bound on waiting for a PENDING_CREATION/RESTARTING actor to
    # come alive before an actor call fails with ActorUnschedulableError.
    # 0 = wait forever (reference semantics). Callers needing bounded
    # resolution (health checks, CI) set RT_ACTOR_RESOLVE_DEADLINE_S.
    actor_resolve_deadline_s: float = 0.0
    actor_restart_backoff_s: float = 0.5
    # Restart-storm damping (reference: exponential actor restart delays in
    # gcs_actor_manager): the GCS backs off min(cap, base * 2**(n-1)) +-25%
    # jitter per consecutive restart, so a crash-looping actor can't hammer
    # the scheduler at a fixed cadence.
    actor_restart_backoff_max_s: float = 30.0
    # RpcClient auto-reconnect pacing: capped exponential backoff + jitter
    # across up to rpc_reconnect_attempts re-dials per call (a head restart
    # takes a moment to rebind — an immediate single re-dial just loses).
    rpc_reconnect_base_s: float = 0.05
    rpc_reconnect_max_s: float = 2.0
    rpc_reconnect_attempts: int = 5
    task_max_retries_default: int = 3
    # OOM prevention (reference: common/memory_monitor.h +
    # raylet/worker_killing_policy.cc): when node memory use crosses the
    # threshold, the raylet kills a worker (retriable task workers first,
    # largest RSS) instead of letting the kernel OOM-killer nuke the raylet.
    # >= 1.0 disables the monitor.
    memory_usage_threshold: float = 0.95
    memory_monitor_interval_s: float = 1.0

    # ---- gcs ---------------------------------------------------------------
    gcs_rpc_timeout_s: float = 30.0
    pubsub_poll_timeout_s: float = 30.0
    # fsync the KV WAL before acking each kv_put. Default off: appends are
    # flushed (process-crash durable) but only fsynced at migration and
    # shutdown, so a host crash can lose acked puts. Turn on for host-crash
    # durability at the cost of per-put fsync latency.
    wal_fsync: bool = False

    # ---- accelerator -------------------------------------------------------
    # (GPUs are counted by _private/accelerator.py and pinned through
    # CUDA_VISIBLE_DEVICES)
    coordinator_port: int = 0

    # ---- logging / metrics -------------------------------------------------
    log_to_driver: bool = True
    event_buffer_size: int = 10000
    metrics_report_interval_s: float = 5.0

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        for f in dataclasses.fields(cls):
            env_key = _ENV_PREFIX + f.name.upper()
            if env_key in os.environ:
                setattr(cfg, f.name, _coerce(os.environ[env_key], f.type if isinstance(f.type, type) else type(getattr(cfg, f.name))))
        return cfg

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, data: str) -> "Config":
        cfg = cls()
        for k, v in json.loads(data).items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg


_config: Config | None = None


def get_config() -> Config:
    """The process-wide config snapshot (lazy; env read once)."""
    global _config
    if _config is None:
        env_blob = os.environ.get("RT_CONFIG_JSON")
        _config = Config.from_json(env_blob) if env_blob else Config.from_env()
    return _config


def set_config(cfg: Config) -> None:
    global _config
    _config = cfg


def reset_config_for_tests() -> None:
    """Drop the cached snapshot so the next get_config() re-reads the env."""
    global _config
    _config = None
