"""Raylet: the per-node control plane (worker pool + local scheduler + object
plane endpoints).

Reference analog: ``src/ray/raylet/`` — ``NodeManager`` (lease/dispatch RPCs),
``WorkerPool`` (process spawning + idle reuse keyed by environment),
``LocalTaskManager`` (resource-gated FIFO dispatch), ``ObjectManager``
(node-to-node transfer by directory lookup). Redesigns:
  - Tasks are pushed raylet→worker and the submitter's RPC is held open until
    completion, so small results ride the reply chain back to the OWNER's
    memory store (the reference gets the same effect with worker→worker
    ``PushNormalTask`` after a lease; fewer moving parts here, same ownership
    semantics).
  - GPUs are per-instance resources: a task/actor holding GPUs gets a
    dedicated worker process pinned via CUDA_VISIBLE_DEVICES at spawn, cached
    keyed by its GPU set (reference: worker cache keyed by runtime-env hash).
    The raylet never initialises CUDA itself.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch import _native
from ray_tpu_torch._private import accelerator
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.core import failure as F
from ray_tpu_torch.core.resources import CPU, GPU, NodeResources, ResourceSet
from ray_tpu_torch.cluster.object_store import PlasmaStore
from ray_tpu_torch.cluster.rpc import (
    ConnectionLost,
    ConnectionPool,
    RpcClient,
    RpcServer,
    cancel_and_wait,
    spawn_task,
)
from ray_tpu_torch.exceptions import WorkerCrashedError
from ray_tpu_torch.scheduler.policy import strategy_allows_local
from ray_tpu_torch.util import chaos as C
from ray_tpu_torch.util import metrics as M
from ray_tpu_torch.util.profiling import format_current_stacks


class _WorkerEntry:
    def __init__(self, worker_id: str, proc: subprocess.Popen, key: Tuple,
                 loop: asyncio.AbstractEventLoop):
        self.worker_id = worker_id
        self.proc = proc
        self.key = key                      # (gpu_tuple, runtime_env_hash)
        self.address: Optional[str] = None
        self.client: Optional[RpcClient] = None
        self.ready = loop.create_future()
        self.busy = False
        self.is_actor_worker = False
        self.actor_id: Optional[str] = None
        self.assignment: Dict[str, List[int]] = {}
        self.oom_killed = False
        self.job_id: Optional[str] = None  # current job, for log routing
        self.idle_since: Optional[float] = None  # monotonic; None = busy
        self.current_task: Optional[str] = None  # fn_name while executing


class _BundleState:
    """A committed PG bundle: a carved-out resource pool on this node.

    The bundle holds ``req`` (+ specific gpus) against the node; tasks and
    actors placed into the bundle allocate from this pool, not the node's.
    """

    def __init__(self, req: ResourceSet, node_assignment: Dict[str, List[int]]):
        self.node_req = req
        self.node_assignment = node_assignment
        self.pool = NodeResources(req.to_dict())
        if GPU in node_assignment:
            self.pool._free_gpus = list(node_assignment[GPU])
        self.committed = False


# the worker-pool key of a plain worker: no pinned gpus, no runtime env —
# the only kind the prestart floor maintains and actor creation may adopt
_WARM_KEY: Tuple = ((), None)


class _SchedQueues:
    """Per-scheduling-class FIFO queues dispatched round-robin (reference:
    the LocalTaskManager's per-``SchedulingClass`` queues,
    ``local_task_manager.h`` — the structure that keeps a 1-task probe from
    waiting out a 5k-deep bulk flood).

    A scheduling class is ``(owner, fn_name, resource shape)`` — the
    granularity at which the reference keys dispatch. FIFO order is
    preserved WITHIN a class; classes take turns claiming resources, and a
    class that just dispatched rotates to the back of the order.
    """

    def __init__(self):
        self._classes = collections.OrderedDict()  # key -> deque of items
        self._deque = collections.deque
        self._len = 0
        self._expiring = 0  # queued items carrying a deadline stamp

    @staticmethod
    def _strategy_token(strategy) -> Tuple:
        # Canonical hashable form of a SchedulingStrategy. The strategy is
        # part of the class (reference: SchedulingClassDescriptor): a head
        # that MUST route elsewhere (hard NODE_AFFINITY/NODE_LABEL) and
        # can't — peers full — would otherwise head-of-line-block locally
        # runnable tasks of the same shape forever.
        kind = getattr(strategy, "kind", "DEFAULT")
        if kind == "NODE_AFFINITY":
            return (kind, strategy.node_id_hex, bool(strategy.soft))
        if kind == "NODE_LABEL":
            def canon(d):
                return tuple(sorted(
                    (k, tuple(v) if isinstance(v, list) else v)
                    for k, v in (d or {}).items()))
            return (kind, canon(strategy.hard), canon(strategy.soft))
        return (kind,)

    @staticmethod
    def class_key(payload: Dict) -> Tuple:
        # PG identity is part of the class: bundles are independent pools,
        # so a head blocked on a saturated bundle must not queue-block
        # same-shaped tasks bound for an idle bundle (PG tasks never
        # spill — without this split they could starve behind it forever)
        pg = payload.get("pg") or None
        return (payload.get("owner") or "",
                payload.get("fn_name") or "",
                tuple(sorted((payload.get("resources") or {}).items())),
                (pg["pg_id"], pg.get("bundle_index")) if pg else None,
                _SchedQueues._strategy_token(payload.get("strategy")))

    @staticmethod
    def class_label(key: Tuple) -> str:
        return key[1] or "anonymous"

    def push(self, item: Dict) -> None:
        q = self._classes.get(item["skey"])
        if q is None:
            q = self._classes[item["skey"]] = self._deque()
        q.append(item)
        self._len += 1
        if item.get("expires") is not None:
            self._expiring += 1

    @property
    def expiring(self) -> int:
        """Queued items with a deadline — lets the heartbeat sweep skip
        its O(total queued) scan when nothing can expire."""
        return self._expiring

    def __len__(self) -> int:
        return self._len

    def depth(self, key: Tuple) -> int:
        q = self._classes.get(key)
        return len(q) if q else 0

    def head(self, key: Tuple) -> Optional[Dict]:
        q = self._classes.get(key)
        return q[0] if q else None

    def pop_head(self, key: Tuple) -> Optional[Dict]:
        q = self._classes.get(key)
        if not q:
            return None
        item = q.popleft()
        self._len -= 1
        if item.get("expires") is not None:
            self._expiring -= 1
        if not q:
            self._classes.pop(key, None)
        return item

    def remove(self, item: Dict) -> bool:
        """O(class depth) removal — only the spillback path (rare) and the
        deadline sweep use it."""
        q = self._classes.get(item["skey"])
        if not q:
            return False
        try:
            q.remove(item)
        except ValueError:
            return False
        self._len -= 1
        if item.get("expires") is not None:
            self._expiring -= 1
        if not q:
            self._classes.pop(item["skey"], None)
        return True

    def rotate(self, key: Tuple) -> None:
        if key in self._classes:
            self._classes.move_to_end(key)

    def window(self, key: Tuple, n: int) -> List[Dict]:
        """The first ``n`` items of a class (the spillback scan window)."""
        q = self._classes.get(key)
        return list(itertools.islice(q, n)) if q else []

    def keys(self) -> List[Tuple]:
        return list(self._classes)

    def items(self):
        """Every queued item, class by class (deadline sweep)."""
        for q in list(self._classes.values()):
            yield from list(q)

    def first_n(self, n: int):
        """Up to ``n`` queued items WITHOUT copying class deques — the
        heartbeat demand scan must stay O(n), not O(total queued)."""
        for q in list(self._classes.values()):
            if n <= 0:
                return
            for item in itertools.islice(q, n):
                n -= 1
                yield item

    def by_class(self) -> List[Tuple[str, int, float]]:
        """(label, depth, oldest enqueue monotonic) per class, deepest
        first. Labels collide across owners on purpose — telemetry
        cardinality stays bounded by distinct function names."""
        agg: Dict[str, Tuple[int, float]] = {}
        for key, q in list(self._classes.items()):
            if not q:
                continue
            label = self.class_label(key)
            depth, oldest = agg.get(label, (0, float("inf")))
            agg[label] = (depth + len(q),
                          min(oldest, q[0].get("t_enq", q[0]["t"])))
        return sorted(((lb, d, t) for lb, (d, t) in agg.items()),
                      key=lambda r: -r[1])


class Raylet:
    def __init__(self, node_id: str, session_name: str, gcs_address: str,
                 resources: Dict[str, float], labels: Dict[str, str],
                 loop: asyncio.AbstractEventLoop):
        self.node_id = node_id
        self.session_name = session_name
        self.gcs_address = gcs_address
        self.node = NodeResources(resources, labels)
        self.loop = loop
        self.store = PlasmaStore(session_name)
        self.server = RpcServer(loop)
        self.server.register_object(self)
        self.server.set_disconnect_handler(self._on_peer_disconnect)
        self._gcs: Optional[RpcClient] = None
        self._pool = ConnectionPool(peer_id=f"raylet:{node_id}")
        self._workers: Dict[str, _WorkerEntry] = {}
        self._idle: Dict[Tuple, List[_WorkerEntry]] = {}
        # concurrent worker-process boots allowed (see _get_worker):
        # enough to hide boot latency, few enough that a task burst can't
        # fork-bomb a small host
        self._spawn_slots = max(4, 2 * (os.cpu_count() or 1))
        # Pending task payloads + futures, organized per scheduling class
        # and dispatched round-robin (the overload-robust replacement for
        # the old FIFO list — see _SchedQueues).
        self._squeue = _SchedQueues()
        self._inflight: Dict[str, Dict] = {}  # task_id -> resource state
        self._task_futures: Dict[str, "asyncio.Future"] = {}  # dedup joins
        self._replies: Dict[str, Dict] = {}  # task_id -> successful reply
        self._bundles: Dict[Tuple[str, int], _BundleState] = {}
        self._dispatch_event = asyncio.Event()
        # worker-log ring (filled by _log_pump_loop, drained by poll_logs)
        self._log_buf: "collections.deque" = collections.deque(maxlen=10000)
        self._log_seq = 0
        self._log_event = asyncio.Event()
        self._local_objects: set = set()
        self._tasks: List[asyncio.Task] = []
        self._stopped = False
        # --- object durability (reference: LocalObjectManager spilling,
        # plasma EvictionPolicy) ---
        cfg = get_config()
        self._store_capacity = (cfg.object_store_memory_bytes
                                or cfg.object_store_default_cap_bytes)
        self._spill_dir = (cfg.object_spilling_dir
                           or os.path.join(cfg.session_dir_root, session_name,
                                           "spill", node_id))
        # oid_hex -> {"size": int, "t": last-access, "spilled": bool}
        self._object_meta: Dict[str, Dict[str, Any]] = {}
        # Get-time pins (reference: ``PinObjectIDs``,
        # ``raylet/node_manager.h:515-555``): a getter pins its whole ref set
        # before resolution so concurrent restores can't mutually re-evict
        # each other's objects between fetch-ok and the shm read. Refcounted;
        # a stale pin (crashed getter) expires after _PIN_TTL_S.
        # oid_hex -> {"count": int, "t": monotonic-of-last-pin}
        self._pinned: Dict[str, Dict[str, float]] = {}
        # In-flight remote pulls: chunked transfer holds the .building file
        # across awaits, so concurrent fetches of one object must join the
        # first pull, not race its O_EXCL create (reference: PullManager
        # dedups by object id).
        self._pulls: Dict[str, asyncio.Future] = {}
        # in-flight client-mode uploads: oid -> (buffer, started_at);
        # stale entries (client died mid-upload) purged by the reap loop
        self._client_uploads: Dict[str, Tuple[Any, float]] = {}
        # Running sum of in-memory (non-spilled) object bytes, so the
        # per-unpin spill precheck is O(1) not O(#objects). Maintained by
        # _touch / _spill_blocking / rpc_free_objects; the spill thread
        # recomputes exactly under its lock before acting.
        self._in_mem_bytes = 0
        # spill/restore file IO runs here, never on the event loop — the
        # raylet must keep dispatching while bytes hit the disk (reference:
        # dedicated Python IO workers in LocalObjectManager)
        self._spill_exec = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="rt-spill")
        self._spill_lock = threading.Lock()
        # Scheduler queue telemetry (reference: the raylet's
        # scheduler_stats in GcsNodeManager reports): queue depth rides
        # every heartbeat; per-dispatch queue wait feeds a histogram. Both
        # series land on the Prometheus push — from THIS process's registry
        # when no driver shares it (standalone node daemon), or via the
        # driver's pusher in an in-process cluster. RT_QUEUE_TELEMETRY=0
        # reduces the dispatch path to one predicate check.
        self._telemetry = os.environ.get(
            "RT_QUEUE_TELEMETRY", "1") not in ("", "0", "false")
        self._tele_metrics: Optional[Dict[str, Any]] = None
        self._tele_pushed = 0.0
        # Memory-plane counters (cumulative; surfaced by rpc_memory_report
        # and `rt memory`, twinned as rt_object_* / rt_oom_kills_total on
        # the Prometheus push). Mutated from the loop AND the spill
        # executor thread — single increments only, drift-free enough for
        # telemetry.
        self._mem_stats: Dict[str, float] = {
            "spills": 0, "spill_bytes": 0, "spill_seconds": 0.0,
            "restores": 0, "restore_bytes": 0, "restore_seconds": 0.0,
            "pin_purges": 0, "oom_kills": 0}
        self._rss_reported: set = set()  # worker_ids with a live RSS gauge
        # client-side failure-emission rate limit (see _failure_event)
        self._failure_limiter = F.EmitLimiter()
        # --- GCS-outage degraded mode (reference: the raylet surviving a
        # GCS failover, gcs_client reconnection) --- while the GCS is
        # unreachable this raylet KEEPS executing local work; bookkeeping
        # updates (object locations, death reports) defer here and replay
        # in order on resync. Entered by the heartbeat loop or the first
        # failed publish; exited by the first successful heartbeat.
        self._degraded_since: Optional[float] = None
        self._deferred_gcs: "collections.deque" = collections.deque(
            maxlen=10000)
        self._deferred_dropped = 0  # overflow evictions during an outage
        self._flushing = False      # single-flight deferred-replay guard
        # last chaos-plan revision this raylet synced from the GCS
        self._chaos_seen_rev = 0
        self._hb_drops = 0  # consecutive chaos-dropped heartbeats
        # --- overload-robust control plane (fair dispatch / warm pool /
        # admission / deadlines) --- cumulative accounting surfaced by
        # node_stats, the heartbeat's sched summary, `rt status` and the
        # rt_sched_* / rt_worker_pool_* Prometheus series.
        self._sched_stats: Dict[str, int] = {
            "warm_hits": 0, "cold_spawns": 0, "actor_adoptions": 0,
            "prestarted": 0, "backpressure": 0, "deadline_evictions": 0}
        # per-class recent queue waits: label -> deque[(t_mono, wait_s)];
        # feeds the heartbeat's wait_p99_s (the `rt doctor` starvation
        # finding) without keeping one histogram per class
        self._class_waits: Dict[str, Any] = {}
        self._class_gauge_labels: set = set()  # live rt_sched_class gauges
        self._prestarting = 0  # warm-pool spawns currently booting
        # raylet->GCS task-event chatter batches here and ships as ONE
        # coalesced task_events RPC per flush window (the submit hot path
        # used to pay 3 GCS round-trips per task)
        self._task_event_buf: "collections.deque" = collections.deque(
            maxlen=10000)
        self._task_event_flushing = False
        self._task_event_kick = asyncio.Event()  # terminal-state fast path

    _QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 1.0, 5.0, 15.0,
                           60.0, 300.0, 900.0)
    _SPILL_BUCKETS = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                      5.0, 15.0, 60.0)

    def _telemetry_metrics(self) -> Dict[str, Any]:
        if self._tele_metrics is None:
            self._tele_metrics = {
                "queue_depth": M.get_or_create(
                    M.Gauge, "rt_raylet_queue_depth",
                    "Pending tasks in the raylet dispatch queue",
                    tag_keys=("node_id",)),
                "queue_wait": M.get_or_create(
                    M.Histogram, "rt_task_queue_wait_seconds",
                    "Raylet queue wait per dispatched task "
                    "(enqueue to dispatch claim)",
                    boundaries=self._QUEUE_WAIT_BUCKETS,
                    tag_keys=("node_id",)),
                "store_bytes": M.get_or_create(
                    M.Gauge, "rt_object_store_bytes",
                    "Per-node object store bytes by state "
                    "(in_memory / spilled / pinned)",
                    tag_keys=("node_id", "state")),
                "spill_hist": M.get_or_create(
                    M.Histogram, "rt_object_spill_seconds",
                    "Disk-spill IO time per spilled object",
                    boundaries=self._SPILL_BUCKETS, tag_keys=("node_id",)),
                "restore_hist": M.get_or_create(
                    M.Histogram, "rt_object_restore_seconds",
                    "Spill-restore IO time per restored object",
                    boundaries=self._SPILL_BUCKETS, tag_keys=("node_id",)),
                "worker_rss": M.get_or_create(
                    M.Gauge, "rt_worker_rss_bytes",
                    "Resident set size of each live worker process",
                    tag_keys=("node_id", "worker_id")),
                "oom_kills": M.get_or_create(
                    M.Counter, "rt_oom_kills_total",
                    "Workers killed by the raylet memory monitor",
                    tag_keys=("node_id",)),
                "pin_purges": M.get_or_create(
                    M.Counter, "rt_object_pin_purges_total",
                    "Leaked get-pins purged by the TTL timer "
                    "(crashed getters)",
                    tag_keys=("node_id",)),
                "class_depth": M.get_or_create(
                    M.Gauge, "rt_sched_class_queue_depth",
                    "Pending tasks per scheduling class in the raylet's "
                    "round-robin dispatch queues",
                    tag_keys=("node_id", "sched_class")),
                "warm_hits": M.get_or_create(
                    M.Counter, "rt_worker_pool_warm_hits_total",
                    "Dispatches served by a warm pooled worker instead "
                    "of a fresh process spawn",
                    tag_keys=("node_id", "kind")),
                "backpressure": M.get_or_create(
                    M.Counter, "rt_sched_backpressure_total",
                    "Task submissions bounced with a backpressure reply "
                    "(per-class admission bound)",
                    tag_keys=("node_id",)),
                "deadline_evictions": M.get_or_create(
                    M.Counter, "rt_sched_deadline_evictions_total",
                    "Queued tasks shed because their deadline_s budget "
                    "expired before dispatch",
                    tag_keys=("node_id",)),
            }
        return self._tele_metrics

    # ---- lifecycle ----------------------------------------------------------
    async def start(self, port: int = 0) -> str:
        await self.server.start(port)
        self._gcs = RpcClient(self.gcs_address,
                              peer_id=f"raylet:{self.node_id}",
                              auto_reconnect=True)
        await self._gcs.connect()
        await self._gcs.call("register_node", {
            "node_id": self.node_id, "address": self.server.address,
            "resources": self.node.total.to_dict(),
            "labels": dict(self.node.labels)})
        self._tasks.append(asyncio.ensure_future(self._heartbeat_loop()))
        self._tasks.append(asyncio.ensure_future(self._dispatch_loop()))
        self._tasks.append(asyncio.ensure_future(self._reap_loop()))
        self._tasks.append(asyncio.ensure_future(self._log_pump_loop()))
        if get_config().memory_usage_threshold < 1.0:
            self._tasks.append(
                asyncio.ensure_future(self._memory_monitor_loop()))
        return self.server.address

    async def stop(self, destroy_store: bool = False) -> None:
        self._stopped = True
        await cancel_and_wait(*self._tasks)
        self._tasks.clear()
        for w in list(self._workers.values()):
            try:
                w.proc.terminate()
            except ProcessLookupError:
                pass
        if self._gcs is not None:
            await self._gcs.close()
        await self._pool.close_all()
        await self.server.stop()
        # The shm session dir is SHARED by all nodes of the session (same
        # host); only the session owner destroys it (ClusterHandle.shutdown).
        if destroy_store:
            self.store.destroy()

    async def _heartbeat_loop(self) -> None:
        cfg = get_config()
        while True:
            await asyncio.sleep(cfg.heartbeat_interval_s)
            f = C.maybe_fire("raylet.heartbeat_drop")
            if f is not None:
                # simulated raylet<->GCS partition: ONLY the beat is not
                # sent (telemetry push + dispatch wake below still run —
                # local work must not stall); enough consecutive drops
                # cross node_death_timeout_s and the GCS declares this
                # node dead (then resurrects it when the beats resume)
                self._chaos_stamp("raylet.heartbeat_drop", f)
                self._hb_drops += 1
                if self._hb_drops % 5 == 0:
                    # an UNBOUNDED drop plan must still honor `rt chaos
                    # disarm`: probe the plan revision out-of-band every
                    # few drops (the heartbeat itself stays dropped, so
                    # the node-death semantics are untouched)
                    spawn_task(self._probe_chaos_rev())
            else:
                self._hb_drops = 0
                await self._heartbeat_once()
            if self._telemetry:
                await self._push_telemetry()
            if len(self._squeue):
                # deadline budgets are enforced on a sweep too, not just at
                # the dispatch head: stale work deep in a blocked class is
                # shed while it is still cheap to shed
                self._evict_expired()
                # periodic wake so waiting tasks re-evaluate spillback even
                # when no local resource event fires
                self._dispatch_event.set()

    async def _heartbeat_once(self) -> None:
        try:
            # queued-but-unplaced demand rides the heartbeat so the
            # autoscaler can bin-pack it onto prospective node types
            # (reference: resource_demand_scheduler's load report)
            demands: Dict[Tuple, int] = {}
            for item in self._squeue.first_n(100):
                key = tuple(sorted(
                    item["payload"].get("resources", {}).items()))
                demands[key] = demands.get(key, 0) + 1
            # bounded: a hung-but-connected GCS must trip the transient
            # path into degraded mode, not wedge the maintenance loop
            reply = await self._gcs.call("heartbeat", {
                "node_id": self.node_id,
                "available": self.node.available.to_dict(),
                "queue_depth": len(self._squeue),
                "sched": self._sched_summary(),
                "queued_demands": [
                    {"resources": dict(k), "count": c}
                    for k, c in list(demands.items())[:20]]},
                timeout=10.0)
            if reply.get("unknown"):
                # The GCS restarted and lost the node table (nodes are
                # deliberately not snapshotted): re-register under the
                # SAME node id, then re-publish actors + locations OFF
                # this loop (stalling heartbeats past the death timeout
                # would get the fresh registration killed again).
                await self._gcs.call("register_node", {
                    "node_id": self.node_id,
                    "address": self.server.address,
                    "resources": self.node.total.to_dict(),
                    "labels": dict(self.node.labels)}, timeout=10.0)
                spawn_task(self._reattach_after_gcs_restart())
            if reply.get("resurrected"):
                # off the heartbeat loop: a long republish here would
                # stall heartbeats past node_death_timeout_s and
                # re-enter the death/resurrect cycle
                spawn_task(self._reconcile_after_resurrection())
            rev = reply.get("chaos_rev")
            if rev is not None and rev != self._chaos_seen_rev:
                spawn_task(self._sync_chaos(
                    rev, reply.get("chaos_armed", True)))
            if self._degraded_since is not None and not self._flushing:
                # the GCS is reachable again: replay deferred updates and
                # leave degraded mode — OFF this loop (a 10k-entry replay
                # awaited here would stall beats past node_death_timeout_s
                # and re-enter the death/resurrect cycle); single-flight
                self._flushing = True
                spawn_task(self._flush_deferred_guarded())
            for ev in C.drain_events():
                # rpc.* chaos fires buffered in-process (the rpc layer
                # has no GCS handle) ship from here
                F.emit_raw(spawn_task, self._gcs, ev)
        except Exception as e:  # noqa: BLE001
            # GCS unreachable: enter degraded mode — local dispatch
            # keeps running, bookkeeping defers until resync. Only
            # TRANSPORT failures count (same discipline as _gcs_publish);
            # an application error from a healthy GCS is swallowed like
            # the pre-degraded-mode loop did.
            if self._is_transient(e) and self._degraded_since is None:
                self._degraded_since = time.monotonic()

    async def _push_telemetry(self) -> None:
        """Queue-depth gauge + registry push. A standalone node daemon has
        no driver metrics pusher, so the raylet ships its own registry
        snapshot to the @metrics/ KV; when a driver shares this process
        (in-process test cluster) its pusher covers the shared registry and
        this path skips the write (double-pushed histograms would double
        their counts in the merged Prometheus page)."""
        try:
            m = self._telemetry_metrics()
            m["queue_depth"].set(len(self._squeue),
                                 {"node_id": self.node_id})
            now = time.monotonic()
            if now - self._tele_pushed < 5.0:
                return
            # O(#objects) scan and /proc reads at the push cadence only —
            # samples set more often than they are shipped are wasted work
            self._set_store_gauges(m)
            self._set_class_gauges(m)
            self._update_worker_rss(m)
            if ray_tpu_torch.is_initialized():
                self._tele_pushed = now
                return  # the driver's pusher owns this registry
            await self._gcs.call("kv_put", {
                "key": f"{M._KV_PREFIX}raylet:{self.node_id}",
                "value": json.dumps({
                    "t": time.time(),
                    "metrics": M._registry.snapshot()}).encode()})
            self._tele_pushed = now
        except Exception:  # noqa: BLE001 — telemetry must never kill
            pass  # the heartbeat loop

    def _store_state_bytes(self) -> Dict[str, int]:
        """One pass over the object meta: bytes by state. ``pinned`` counts
        live-pinned in-memory bytes (a subset of in_memory, like the
        reference's pinned accounting)."""
        now = time.monotonic()
        in_mem = spilled = pinned = 0
        for oid_hex, meta in list(self._object_meta.items()):
            if meta.get("spilled"):
                spilled += meta["size"]
            else:
                in_mem += meta["size"]
                if self._is_pinned(oid_hex, now):
                    pinned += meta["size"]
        return {"in_memory": in_mem, "spilled": spilled, "pinned": pinned}

    def _set_store_gauges(self, m: Dict[str, Any]) -> None:
        for state, v in self._store_state_bytes().items():
            m["store_bytes"].set(v, {"node_id": self.node_id,
                                     "state": state})

    def _set_class_gauges(self, m: Dict[str, Any]) -> None:
        """rt_sched_class_queue_depth per live scheduling class; classes
        that drained remove their samples so the page doesn't accumulate
        one stale series per function name ever submitted."""
        live: set = set()
        for label, depth, _oldest in self._squeue.by_class():
            live.add(label)
            m["class_depth"].set(depth, {"node_id": self.node_id,
                                         "sched_class": label})
        for label in self._class_gauge_labels - live:
            m["class_depth"].remove({"node_id": self.node_id,
                                     "sched_class": label})
        self._class_gauge_labels = live

    def _class_wait_p99(self, label: str,
                        now: float, window_s: float = 60.0
                        ) -> Optional[float]:
        dq = self._class_waits.get(label)
        if not dq:
            return None
        waits = sorted(w for t, w in dq if now - t <= window_s)
        if not waits:
            self._class_waits.pop(label, None)  # stale class: stop reporting
            return None
        return waits[min(len(waits) - 1, int(0.99 * len(waits)))]

    def _sched_summary(self) -> Dict[str, Any]:
        """The scheduling plane's health snapshot: per-class depth +
        queue-wait p99 + oldest-waiter age (what `rt doctor` grades for
        starvation), and warm-pool occupancy / hit accounting. Rides every
        heartbeat into the GCS node table -> `rt status`, the dashboard
        Nodes tab and doctor findings."""
        now = time.monotonic()
        if len(self._class_waits) > 256:
            # bound the per-class wait rings: a job churning through many
            # distinct fn names must not grow this forever — drop labels
            # whose newest sample went stale
            for label, dq in list(self._class_waits.items()):
                if not dq or now - dq[-1][0] > 600.0:
                    self._class_waits.pop(label, None)
        classes = []
        rows = self._squeue.by_class()
        pick = rows[:10]
        if len(rows) > 10:
            # depth alone must not truncate away a starving shallow class
            # (the exact case doctor's per-class finding exists for) —
            # union in the oldest waiters
            seen = {r[0] for r in pick}
            pick += [r for r in sorted(rows, key=lambda r: r[2])
                     if r[0] not in seen][:5]
        for label, depth, oldest_t in pick:
            entry: Dict[str, Any] = {
                "class": label, "depth": depth,
                "oldest_wait_s": round(max(0.0, now - oldest_t), 3)}
            p99 = self._class_wait_p99(label, now)
            if p99 is not None:
                entry["wait_p99_s"] = round(p99, 3)
            classes.append(entry)
        s = self._sched_stats
        served = s["warm_hits"] + s["cold_spawns"]
        return {
            "classes": classes,
            "warm": {
                # warm-pool occupancy = adoptable/prestartable workers
                # ONLY (the _WARM_KEY list); env- or GPU-keyed idle
                # workers can't serve a cold plain dispatch — counting
                # them would claim a full pool while every hit misses
                "idle": len(self._idle.get(_WARM_KEY, ())),
                "idle_total": sum(len(v) for v in self._idle.values()),
                "floor": get_config().worker_prestart_floor,
                "warm_hits": s["warm_hits"],
                "cold_spawns": s["cold_spawns"],
                "actor_adoptions": s["actor_adoptions"],
                "prestarted": s["prestarted"],
                "hit_rate": round(s["warm_hits"] / served, 3) if served
                else None},
            "backpressure_total": s["backpressure"],
            "deadline_evictions_total": s["deadline_evictions"],
            # queued+running is the load number the GCS's cross-node
            # imbalance CoV (rt_sched_node_imbalance) is computed over
            "running": len(self._inflight),
        }

    def _update_worker_rss(self, m: Dict[str, Any]) -> None:
        """rt_worker_rss_bytes per live worker; dead workers' samples are
        removed so the page doesn't accumulate stale series."""
        by_pid = {e.proc.pid: e.worker_id
                  for e in self._workers.values() if e.proc.poll() is None}
        live: set = set()
        for pid, rss in _native.process_memory(list(by_pid)):
            wid = by_pid.get(pid)
            if wid is None:
                continue
            live.add(wid)
            m["worker_rss"].set(rss, {"node_id": self.node_id,
                                      "worker_id": wid})
        for wid in self._rss_reported - live:
            m["worker_rss"].remove({"node_id": self.node_id,
                                    "worker_id": wid})
        self._rss_reported = live

    def _mem_event(self, kind: str, **fields) -> None:
        """Fire-and-forget memory instant event to the GCS mem-event store
        (spill / restore / oom_kill): feeds ``ray_tpu_torch.timeline()`` instant
        markers and the `rt memory --oom` post-mortem replay."""
        async def _send():
            try:
                msg = {"kind": kind, "node_id": self.node_id,
                       "t": time.time()}
                msg.update(fields)
                await self._gcs.call("mem_event", msg)
            except Exception:  # noqa: BLE001 — observability only
                pass

        spawn_task(_send())

    def _failure_event(self, category: str, message: str, **fields) -> None:
        """Categorized FailureEvent to the GCS failure store
        (core/failure.py taxonomy): feeds `rt errors`, `/api/errors`, the
        timeline's errors lane and ``rt_failures_total{category=}``
        (counted GCS-side — emitters never double-count). Rate-limited
        per (category, subject-kind): a burst of 5000 tasks failing the
        same way (bundle gone, infeasible) must not stream one RPC per
        task or evict the feed with unique-task rows."""
        key = (category, fields.get("name") or fields.get("actor_id")
               or fields.get("worker_id") or message)
        if not self._failure_limiter.allow(key):
            return
        F.emit(spawn_task, self._gcs, category, message,
               node_id=self.node_id, **fields)

    # ---- chaos plane (util/chaos.py) ---------------------------------------
    def _chaos_stamp(self, site: str, fault: Dict, **fields) -> None:
        """Stamp one chaos-origin FailureEvent for a fault fired in this
        raylet. Thread-safe: callable from the spill executor as well as
        the event loop (the send is scheduled onto the loop)."""
        payload = C.event_payload(site, fault, node_id=self.node_id,
                                  **fields)
        self.loop.call_soon_threadsafe(
            F.emit_raw, spawn_task, self._gcs, payload)

    async def _probe_chaos_rev(self) -> None:
        """Out-of-band plan-revision check while heartbeats are being
        chaos-dropped — the escape hatch that keeps disarm reachable."""
        try:
            reply = await self._gcs.call("chaos_status", {}, timeout=10.0)
        except Exception:  # noqa: BLE001 — next probe retries
            return
        rev = reply.get("rev")
        if rev is not None and rev != self._chaos_seen_rev:
            await self._sync_chaos(rev, reply.get("armed", True))

    async def _sync_chaos(self, rev: int, armed: bool = True) -> None:
        """The GCS announced a new chaos-plan revision: fetch the plan via
        the chaos-exempt ``chaos_status`` RPC (a live rpc.drop plan must
        not block its own update), arm/disarm this process, and forward
        to live workers (new workers get the plan via RT_CHAOS_PLAN_JSON
        at spawn). ``armed=False`` (from the heartbeat reply) skips the
        fetch so a DISARM always lands."""
        plan = None
        if armed:
            try:
                reply = await self._gcs.call("chaos_status", {},
                                             timeout=10.0)
            except Exception:  # noqa: BLE001 — next heartbeat retries
                return
            plan = reply.get("plan")
            if plan is not None:
                try:
                    C.arm(plan, rev=rev)
                except Exception:  # noqa: BLE001 — malformed: stay safe
                    plan = None
        if plan is None:
            C.disarm()
        self._chaos_seen_rev = rev
        for entry in list(self._workers.values()):
            if entry.client is None or entry.proc.poll() is not None:
                continue
            try:
                await entry.client.call(
                    "chaos_arm", {"plan": plan, "rev": rev}, timeout=5.0)
            except Exception:  # noqa: BLE001 — worker mid-death or busy
                continue

    # ---- GCS-outage degraded mode ------------------------------------------
    # Only TRANSPORT failures mean "the GCS is unreachable"; an
    # application-level RpcError is a healthy GCS rejecting this payload —
    # deferring it would poison the replay queue (same payload, same
    # rejection, forever) and wedge the raylet in degraded mode.
    _TRANSIENT_GCS_ERRORS = (OSError, asyncio.TimeoutError)

    def _is_transient(self, e: BaseException) -> bool:
        return isinstance(e, (ConnectionLost,) + self._TRANSIENT_GCS_ERRORS)

    def _defer(self, method: str, payload: Dict) -> None:
        if len(self._deferred_gcs) == self._deferred_gcs.maxlen:
            # overflow evicts the oldest entry — COUNTED, never silent;
            # the resync path repairs with a full location republish
            self._deferred_dropped += 1
        self._deferred_gcs.append((method, payload))

    async def _gcs_publish(self, method: str, payload: Dict) -> None:
        """Bookkeeping updates (object locations, death reports) that must
        not fail LOCAL execution when the GCS is unreachable: in degraded
        mode they defer immediately (no per-call reconnect stall) and
        replay in order once the heartbeat loop sees the GCS again.
        Application errors propagate to the caller as before."""
        if self._degraded_since is not None:
            self._defer(method, payload)
            return
        try:
            await self._gcs.call(method, payload, timeout=10.0)
        except Exception as e:  # noqa: BLE001
            if not self._is_transient(e):
                raise
            if self._degraded_since is None:
                self._degraded_since = time.monotonic()
            self._defer(method, payload)

    async def _flush_deferred_guarded(self) -> None:
        try:
            await self._flush_deferred()
        finally:
            self._flushing = False

    async def _flush_deferred(self) -> None:
        """Replay deferred bookkeeping after a GCS outage; exits degraded
        mode only when the whole backlog lands. A transport failure means
        the GCS bounced again — stay degraded, keep the rest queued; an
        application rejection drops THAT entry (a poisoned payload must
        not head-of-line-block the backlog forever)."""
        n = len(self._deferred_gcs)
        while self._deferred_gcs:
            method, payload = self._deferred_gcs.popleft()
            try:
                await self._gcs.call(method, payload, timeout=10.0)
            except Exception as e:  # noqa: BLE001
                if self._is_transient(e):  # still (or again) down
                    self._deferred_gcs.appendleft((method, payload))
                    return
                continue  # rejected by a healthy GCS: drop, keep flushing
        outage_s = time.monotonic() - (self._degraded_since
                                       or time.monotonic())
        self._degraded_since = None
        dropped = self._deferred_dropped
        self._deferred_dropped = 0
        if dropped:
            # the deque overflowed during the outage: some location
            # updates are gone — repair wholesale by republishing every
            # object this node still serves (idempotent adds)
            spawn_task(self._reconcile_after_resurrection())
        self._failure_event(
            F.UNKNOWN,
            f"raylet ran degraded for {outage_s:.1f}s during a GCS "
            f"outage; resynced {n} deferred update(s)"
            + (f", {dropped} overflowed (full location republish "
               f"triggered)" if dropped else ""),
            origin="recovery")

    # ---- worker pool --------------------------------------------------------
    def _spawn_worker(self, key: Tuple, gpus: List[int],
                      runtime_env: Optional[Dict] = None,
                      python_exe: Optional[str] = None) -> _WorkerEntry:
        worker_id = os.urandom(8).hex()
        env = dict(os.environ)
        env["RT_WORKER_ID"] = worker_id
        env["RT_RAYLET_ADDR"] = self.server.address
        env["RT_GCS_ADDR"] = self.gcs_address
        env["RT_NODE_ID"] = self.node_id
        env["RT_SESSION_NAME"] = self.session_name
        env["RT_CONFIG_JSON"] = get_config().to_json()
        # user prints must reach the log file (and the driver echo) promptly,
        # not sit in a block buffer until the worker exits
        env["PYTHONUNBUFFERED"] = "1"
        if runtime_env:
            env["RT_RUNTIME_ENV_JSON"] = json.dumps(runtime_env)
        if gpus:
            accelerator.set_visible_gpus(gpus, env)
        if C.armed():
            # new workers join the tortured cluster armed from birth (live
            # workers got the plan via the chaos_arm RPC)
            env["RT_CHAOS_PLAN_JSON"] = C.plan_json()
        else:
            env.pop("RT_CHAOS_PLAN_JSON", None)
        log_dir = os.path.join(get_config().session_dir_root,
                               self.session_name, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_file = open(os.path.join(log_dir, f"worker-{worker_id}.log"), "wb")
        proc = subprocess.Popen(
            [python_exe or sys.executable, "-m",
             "ray_tpu_torch.cluster.worker_main"],
            env=env, stdout=log_file, stderr=subprocess.STDOUT)
        log_file.close()
        entry = _WorkerEntry(worker_id, proc, key, self.loop)
        self._workers[worker_id] = entry
        return entry

    async def rpc_worker_ready(self, p):
        entry = self._workers.get(p["worker_id"])
        if entry is None:
            return {"ok": False}
        entry.address = p["address"]
        entry.client = await self._pool.get(p["address"])
        if not entry.ready.done():
            entry.ready.set_result(True)
        if self._chaos_seen_rev > 0 or C.armed():
            # a worker spawned just before a plan-rev change registered too
            # late for _sync_chaos's forward and too early for the spawn
            # env — hand it the CURRENT state so no worker runs stale
            pj = C.plan_json()
            spawn_task(self._call_quietly(entry.client, "chaos_arm", {
                "plan": json.loads(pj) if pj else None,
                "rev": C.current_rev()}))
        return {"ok": True, "node_id": self.node_id}

    async def _call_quietly(self, client, method: str, payload: Dict) -> None:
        try:
            await client.call(method, payload, timeout=5.0)
        except Exception:  # noqa: BLE001 — best-effort side channel
            pass

    async def _get_worker(self, key: Tuple, gpus: List[int],
                          runtime_env: Optional[Dict] = None
                          ) -> Tuple[_WorkerEntry, str]:
        """Returns ``(worker, source)`` with source "warm" (pool hit) or
        "spawn" (fresh process) — the phase tracer's worker_acquire tag.

        Idle worker or a new spawn — with spawn THROTTLING: at most
        ``_spawn_slots`` worker processes boot concurrently. A burst of N
        first-touch tasks must not fork N interpreters at once — on a
        small host the spawn stampede thrashes every boot past the startup
        timeout, and each timed-out waiter used to ABANDON its live
        process and retry, forking more (discovered by `rt
        scale-envelope`). Waiters poll the idle pool while throttled, so
        a released worker is picked up ahead of any new spawn; a spawn
        that still times out is KILLED, not leaked."""
        while True:
            idle = self._idle.get(key)
            while idle:
                entry = idle.pop()
                if entry.proc.poll() is None:
                    entry.idle_since = None
                    return entry, "warm"
                self._workers.pop(entry.worker_id, None)
            if self._spawn_slots > 0:
                break
            await asyncio.sleep(0.05)
        self._spawn_slots -= 1
        try:
            python_exe = None
            if runtime_env and runtime_env.get("venv"):
                # hermetic env: materialize the virtualenv OFF the raylet
                # loop and boot the worker with its interpreter (reference:
                # the agent's conda/container setup swapping
                # context.py_executable)
                # rt: lint-allow(hot-path) heavy venv machinery on the
                # cold per-env boot path, not per-dispatch
                from ray_tpu_torch.runtime_env.runtime_env import ensure_venv

                cache_root = os.path.join(get_config().session_dir_root,
                                          self.session_name, "runtime_env")
                # setup stays bounded like the worker-side pip path; on
                # timeout the task fails (the executor thread finishes in
                # the background and the venv, if it completes, is cached)
                python_exe = await asyncio.wait_for(
                    self.loop.run_in_executor(
                        None, ensure_venv, runtime_env, cache_root),
                    get_config().runtime_env_setup_timeout_s)
            entry = self._spawn_worker(key, gpus, runtime_env, python_exe)
            cfg = get_config()
            timeout = cfg.process_startup_timeout_s + (
                cfg.runtime_env_setup_timeout_s if runtime_env else 0)
            try:
                await asyncio.wait_for(entry.ready, timeout)
            except asyncio.TimeoutError:
                entry.proc.kill()
                self._workers.pop(entry.worker_id, None)
                raise
            return entry, "spawn"
        finally:
            self._spawn_slots += 1

    def _release_worker(self, entry: _WorkerEntry) -> None:
        entry.busy = False
        entry.current_task = None
        if entry.proc.poll() is None and not entry.is_actor_worker:
            entry.idle_since = time.monotonic()
            self._idle.setdefault(entry.key, []).append(entry)

    _UPLOAD_TTL_S = 600.0

    async def _reap_loop(self) -> None:
        """Detect dead worker processes (reference: worker death via local
        socket disconnect); also purges client uploads abandoned mid-stream
        (dead client) so unsealed store allocations can't pile up."""
        self._last_pin_purge = 0.0
        while True:
            await asyncio.sleep(0.5)
            now = time.monotonic()
            if now - self._last_pin_purge > 5.0:
                # get-pin TTL enforcement on a timer: leaked pins from
                # crashed getters must expire even when no spill pass or
                # pin burst ever runs (they would otherwise exempt their
                # objects from eviction forever)
                self._last_pin_purge = now
                self._purge_stale_pins(now)
            for oid_hex, (_, t0) in list(self._client_uploads.items()):
                if now - t0 > self._UPLOAD_TTL_S:
                    self._client_uploads.pop(oid_hex, None)
                    try:
                        self.store.delete(ObjectID.from_hex(oid_hex))
                    except Exception:  # noqa: BLE001
                        pass
            # idle-worker reaping (reference: the worker pool's idle
            # killing): pooled workers beyond the soft limit that sat
            # idle past the TTL are retired oldest-first — bounds process
            # growth when jobs cycle through many runtime envs
            cfg = get_config()
            soft = cfg.num_workers_soft_limit or max(
                1, int(self.node.total.get(CPU) or 1))
            all_idle = sorted(
                (e for lst in self._idle.values() for e in lst
                 if e.idle_since is not None),
                key=lambda e: e.idle_since)
            surplus = len(all_idle) - soft
            for entry in all_idle[:max(0, surplus)]:
                if now - entry.idle_since <= cfg.idle_worker_ttl_s:
                    break  # oldest within TTL -> all newer ones are too
                self._idle.get(entry.key, []).remove(entry)
                self._workers.pop(entry.worker_id, None)
                try:
                    entry.proc.terminate()
                except Exception:  # noqa: BLE001 — already gone
                    pass

            # warm-pool prestart (reference: worker_pool.h PrestartWorkers):
            # keep the configured floor of plain workers idle so the next
            # cold dispatch or actor creation finds a live interpreter.
            # Bounded per tick so a floor bump can't stampede the host.
            if cfg.worker_prestart_floor > 0 and not self._stopped:
                warm_idle = sum(
                    1 for e in self._idle.get(_WARM_KEY, ())
                    if e.proc.poll() is None)
                # floor capped by the idle soft limit: a floor above it
                # would fight the surplus reaper above in a perpetual
                # boot/retire churn loop on an otherwise idle node
                floor = min(cfg.worker_prestart_floor, soft)
                want = floor - warm_idle - self._prestarting
                for _ in range(min(max(0, want), 2)):
                    self._prestarting += 1
                    spawn_task(self._prestart_worker())

            for entry in list(self._workers.values()):
                if entry.proc.poll() is not None:
                    self._workers.pop(entry.worker_id, None)
                    if entry.is_actor_worker and entry.actor_id:
                        getattr(entry, "_pool", self.node).release(
                            ResourceSet(entry_spec_resources(entry)), entry.assignment)
                        if entry.oom_killed:
                            cause = F.cause_dict(
                                F.OOM_KILL,
                                "killed by the memory monitor (node over "
                                "memory_usage_threshold)",
                                node_id=self.node_id,
                                worker_id=entry.worker_id)
                        else:
                            cause = F.cause_dict(
                                F.WORKER_CRASH,
                                f"worker exited with code "
                                f"{entry.proc.returncode}",
                                node_id=self.node_id,
                                worker_id=entry.worker_id,
                                exit_code=entry.proc.returncode)
                        # degraded-aware: a dead actor's report must not
                        # kill the reap loop while the GCS is down — it
                        # defers and replays on resync (the restart budget
                        # is honored late rather than never); an outright
                        # GCS rejection is swallowed too (retrying the
                        # same report cannot help, and the loop must live)
                        try:
                            await self._gcs_publish("actor_update", {
                                "actor_id": entry.actor_id, "state": "DEAD",
                                "node_id": self.node_id,
                                "reason": cause["message"], "cause": cause})
                        except Exception:  # noqa: BLE001
                            pass
                        entry.is_actor_worker = False

    async def _prestart_worker(self) -> None:
        """Boot one warm-pool worker and release it into the idle pool.
        Failures are silent — the floor check next tick tries again.
        Prestart never outbids task-driven boots for spawn slots: when
        the throttle is saturated it skips (worsening a boot stampede to
        warm the pool defeats both)."""
        try:
            if self._spawn_slots <= 0:
                return
            self._spawn_slots -= 1
            try:
                entry = self._spawn_worker(_WARM_KEY, [], None)
                try:
                    await asyncio.wait_for(
                        entry.ready, get_config().process_startup_timeout_s)
                except asyncio.TimeoutError:
                    entry.proc.kill()
                    self._workers.pop(entry.worker_id, None)
                    return
                self._sched_stats["prestarted"] += 1
                self._release_worker(entry)
                self._dispatch_event.set()
            finally:
                self._spawn_slots += 1
        except Exception:  # noqa: BLE001 — next reap tick retries
            pass
        finally:
            self._prestarting -= 1

    async def _reattach_after_gcs_restart(self) -> None:
        """Re-publish live actor workers to a restarted GCS, then run the
        standard reconciliation (object locations + stale-state cleanup)."""
        for entry in list(self._workers.values()):
            if not (entry.is_actor_worker and entry.actor_id
                    and entry.address):
                continue
            try:
                await self._gcs.call("actor_update", {
                    "actor_id": entry.actor_id, "state": "ALIVE",
                    "address": entry.address, "node_id": self.node_id})
            except Exception:  # noqa: BLE001 — next heartbeat retries
                return
        await self._reconcile_after_resurrection()

    async def _reconcile_after_resurrection(self) -> None:
        """While this node was (spuriously) dead, the GCS dropped our object
        locations and may have restarted our actors elsewhere / rescheduled
        our PG bundles. Re-publish every object this node can still serve
        (shm AND spilled — spill files serve chunks too), kill local actor
        workers the GCS no longer maps to this node (duplicate
        side-effecting copies otherwise), and release bundle reservations we
        no longer own. Failures are per-item; a republish that dies midway
        is retried wholesale by the next resurrection or get-path repair."""
        oids = {o.hex() for o in self.store.list_objects()}
        oids.update(h for h, m in self._object_meta.items()
                    if m.get("spilled"))
        for oid_hex in oids:
            try:
                await self._gcs.call("add_object_location", {
                    "oid": oid_hex, "node_id": self.node_id})
            except Exception:  # noqa: BLE001 — transient; keep going
                continue
        for entry in list(self._workers.values()):
            if not entry.is_actor_worker or not entry.actor_id:
                continue
            try:
                reply = await self._gcs.call(
                    "get_actor_info", {"actor_id": entry.actor_id})
                info = reply.get("info")
            except Exception:  # noqa: BLE001 — next heartbeat retries
                continue
            if info is None or info.get("node_id") != self.node_id \
                    or info.get("state") == "DEAD":
                entry.is_actor_worker = False  # suppress the DEAD re-report
                entry.actor_id = None
                getattr(entry, "_pool", self.node).release(
                    ResourceSet(entry_spec_resources(entry)),
                    entry.assignment)
                self._terminate_worker(entry)
                self._dispatch_event.set()
        for (pg_id, idx), bundle in list(self._bundles.items()):
            try:
                reply = await self._gcs.call(
                    "get_placement_group", {"pg_id": pg_id})
            except Exception:  # noqa: BLE001
                continue
            info = reply.get("info") or reply
            nodes = info.get("bundle_nodes") or []
            if (info.get("state") == "REMOVED"
                    or idx >= len(nodes) or nodes[idx] != self.node_id):
                self._bundles.pop((pg_id, idx), None)
                self.node.release(bundle.node_req, bundle.node_assignment)
                self._dispatch_event.set()

    def _terminate_worker(self, entry: _WorkerEntry,
                          grace_s: float = 5.0) -> None:
        """SIGTERM now, SIGKILL if still alive after the grace period. The
        entry STAYS in ``_workers`` so the reap loop's ``poll()`` collects
        the child (popping immediately would leak a zombie — nothing would
        ever wait() it)."""
        try:
            entry.proc.terminate()
        except ProcessLookupError:
            return

        async def _escalate():
            await asyncio.sleep(grace_s)
            if entry.proc.poll() is None:
                try:
                    entry.proc.kill()
                except ProcessLookupError:
                    pass

        spawn_task(_escalate())

    # injectable for tests (fake pressure without allocating gigabytes);
    # instance-level plain callable, so no descriptor binding applies
    _memory_info_fn = None

    async def _memory_monitor_loop(self) -> None:
        """OOM prevention (reference: ``common/memory_monitor.h`` polling +
        ``raylet/worker_killing_policy.cc``): when node memory use crosses
        ``memory_usage_threshold``, kill one worker — retriable task workers
        first, largest RSS — so the kernel OOM-killer never takes down the
        raylet or an arbitrary process."""
        cfg = get_config()
        while True:
            await asyncio.sleep(cfg.memory_monitor_interval_s)
            try:
                f = C.maybe_fire("oom.pressure")
                if f is not None:
                    # synthetic memory pressure: report the node at `value`
                    # (fraction) so the monitor's kill path runs for real
                    self._chaos_stamp("oom.pressure", f)
                    info = {"total": 1000,
                            "used": int(1000 * float(f.get("value", 0.99)))}
                else:
                    # per-tick lookup: tests inject a fake probe on the
                    # instance
                    info = (self._memory_info_fn or _native.memory_info)()
                total, used = info.get("total", -1), info.get("used", -1)
                if total <= 0 or used < 0:
                    continue
                if used / total < cfg.memory_usage_threshold:
                    continue
                victim = self._pick_oom_victim()
                if victim is None:
                    continue
                victim.oom_killed = True
                victim_rss = _native.process_rss(victim.proc.pid)
                try:
                    victim.proc.kill()
                except ProcessLookupError:
                    pass
                self._record_oom_kill(victim, victim_rss,
                                      {"total": total, "used": used})
            except Exception:  # noqa: BLE001 — monitor must never die
                pass

    def _record_oom_kill(self, victim: _WorkerEntry, victim_rss: int,
                         node_memory: Dict[str, int]) -> None:
        """OOM post-mortem: stamp a GCS ``oom_kill`` event carrying the node
        memory state, the victim (RSS, role, running task/actor) and the
        top-10 largest live store objects — what `rt memory --oom` replays.
        The kill itself already happened; everything here is best-effort."""
        self._mem_stats["oom_kills"] += 1
        if self._telemetry:
            try:
                self._telemetry_metrics()["oom_kills"].inc(
                    1.0, {"node_id": self.node_id})
            except Exception:  # noqa: BLE001
                pass
        self._failure_event(
            F.OOM_KILL,
            f"memory monitor killed worker {victim.worker_id[:8]} "
            f"(rss {victim_rss}, node at "
            f"{node_memory.get('used', 0)}/{node_memory.get('total', 0)})",
            worker_id=victim.worker_id, actor_id=victim.actor_id,
            task=victim.current_task)
        top = sorted(((oid, m) for oid, m in self._object_meta.items()),
                     key=lambda kv: -kv[1]["size"])[:10]
        self._mem_event(
            "oom_kill",
            node_memory=dict(node_memory),
            victim={
                "worker_id": victim.worker_id, "pid": victim.proc.pid,
                "rss": victim_rss,
                "role": "actor" if victim.is_actor_worker else "worker",
                "actor_id": victim.actor_id,
                "task": victim.current_task, "busy": victim.busy},
            top_objects=[{"oid": oid, "size": m["size"],
                          "state": "spilled" if m.get("spilled")
                          else "in_memory"} for oid, m in top])

    def _pick_oom_victim(self) -> Optional[_WorkerEntry]:
        idle_workers, task_workers, actor_workers = [], [], []
        for e in self._workers.values():
            if e.proc.poll() is not None or e.oom_killed:
                continue
            if e.is_actor_worker:
                actor_workers.append(e)
            elif e.busy:
                task_workers.append(e)
            else:
                idle_workers.append(e)
        # Cheapest kill first (reference worker_killing_policy.cc prefers
        # the lowest-cost victim): an idle pooled worker loses no work yet
        # can hold large RSS from its previous task; then busy task workers
        # (retriable by policy, largest RSS frees the most); actors only as
        # a last resort — their death is user-visible (restart or
        # ActorDiedError).
        for group in (idle_workers, task_workers, actor_workers):
            if not group:
                continue
            by_pid = {e.proc.pid: e for e in group}
            ranked = _native.process_memory(list(by_pid))
            if ranked:
                return by_pid[ranked[0][0]]
        return None

    # ---- worker log plumbing (reference: _private/log_monitor.py) ----------
    # The raylet tails every worker log file and keeps a bounded ring of
    # recent lines; drivers long-poll it and echo lines to their stderr
    # (``log_to_driver``). File offsets persist across the pump's life so
    # each line is forwarded once.

    @staticmethod
    def _scan_worker_logs(log_dir: str, offsets: Dict[str, int]
                          ) -> List[Tuple[str, List[str]]]:
        """One tail pass over the worker log files (executor thread —
        listdir/stat/open/read never touch the event loop). Mutates
        ``offsets`` in place; returns [(worker_id, lines), ...]."""
        out: List[Tuple[str, List[str]]] = []
        try:
            names = os.listdir(log_dir)
        except FileNotFoundError:
            return out
        for name in names:
            if not name.startswith("worker-"):
                continue
            path = os.path.join(log_dir, name)
            off = offsets.get(name, 0)
            try:
                size = os.path.getsize(path)
                if size <= off:
                    continue
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read(256 * 1024)
                # forward whole lines; keep a partial tail for next
                # tick — unless the window is FULL with no newline (one
                # giant line): forward it truncated and advance, or the
                # pump would re-read the same window forever
                cut = chunk.rfind(b"\n")
                if cut < 0:
                    if len(chunk) < 256 * 1024:
                        continue  # incomplete line still being written
                    cut = len(chunk)
                offsets[name] = off + cut + (0 if cut == len(chunk)
                                             else 1)
                wid = name[len("worker-"):-len(".log")]
                lines = chunk[:cut].decode(errors="replace").splitlines()
                if lines:
                    out.append((wid, lines))
            except OSError:
                continue
        return out

    async def _log_pump_loop(self) -> None:
        offsets: Dict[str, int] = {}
        log_dir = os.path.join(get_config().session_dir_root,
                               self.session_name, "logs")
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(0.3)
            # the tail reads run on the spill/file-IO pool; only the ring
            # append + waiter wakeup touch the loop
            scanned = await loop.run_in_executor(
                self._spill_exec, self._scan_worker_logs, log_dir, offsets)
            new_any = False
            for wid, lines in scanned:
                wentry = self._workers.get(wid)
                job = wentry.job_id if wentry is not None else None
                for line in lines:
                    self._log_seq += 1
                    self._log_buf.append(
                        {"seq": self._log_seq, "worker_id": wid,
                         "job_id": job, "line": line})
                    new_any = True
            if new_any:
                self._log_event.set()
                self._log_event = asyncio.Event()

    async def rpc_poll_logs(self, p):
        """Long-poll new worker log lines after ``seq`` (0 = from now)."""
        buf = self._log_buf
        after = p.get("after")
        if after is None:
            return {"seq": self._log_seq, "entries": []}
        job = p.get("job_id")

        def wanted(e):
            # route lines to their owning driver (reference: log_monitor
            # per-job routing); untagged lines (worker idle / pre-dispatch
            # prints) broadcast to every poller
            return (e["seq"] > after
                    and (job is None or e.get("job_id") in (None, job)))

        entries = [e for e in buf if wanted(e)]
        if not entries:
            try:
                await asyncio.wait_for(self._log_event.wait(),
                                       p.get("timeout", 10.0))
            except asyncio.TimeoutError:
                pass
            entries = [e for e in buf if wanted(e)]
        # seq must advance past FILTERED entries too, or the poller re-scans
        newest = max((e["seq"] for e in buf), default=after)
        return {"seq": max(newest, after), "entries": entries}

    async def _on_peer_disconnect(self, peer_id: str) -> None:
        pass

    # ---- task submission / dispatch ----------------------------------------
    async def rpc_submit_task(self, p):
        """Held open until the task completes; reply carries results meta.

        Duplicate submissions of the same task_id (owner retried after a
        dropped connection) join the in-flight execution or get the cached
        successful reply — the task body never runs twice for a transport
        failure. A genuine execution failure is NOT cached, so a retry after
        ``worker_crashed`` re-executes as intended.
        """
        task_id = p["task_id"]
        cached = self._replies.get(task_id)
        if cached is not None:
            if not p.get("reconstruct"):
                return cached
            # lineage reconstruction MUST re-execute: the cached reply's
            # plasma objects are exactly what was lost
            self._replies.pop(task_id, None)
        existing = self._task_futures.get(task_id)
        if existing is not None:
            return await asyncio.shield(existing)
        # Admission control (before any state is created for the task): a
        # scheduling class at its queue bound bounces the submit with a
        # backpressure reply instead of absorbing an unbounded producer —
        # the owner blocks-with-backoff (default) or fails fast
        # (on_overload="fail"); either way the raylet never wedges under a
        # runaway submit loop.
        cfg = get_config()
        skey = _SchedQueues.class_key(p)
        if (cfg.max_queued_per_class > 0
                and self._squeue.depth(skey) >= cfg.max_queued_per_class):
            self._sched_stats["backpressure"] += 1
            if self._telemetry:
                try:
                    self._telemetry_metrics()["backpressure"].inc(
                        1.0, {"node_id": self.node_id})
                except Exception:  # noqa: BLE001 — telemetry only
                    pass
            return {"error": "backpressure",
                    "queue_depth": self._squeue.depth(skey),
                    "limit": cfg.max_queued_per_class,
                    "retry_after_s": cfg.backpressure_retry_base_s}
        fut = asyncio.get_running_loop().create_future()
        self._task_futures[task_id] = fut

        def _on_done(f, _tid=task_id):
            # Runs even if this handler's connection dropped mid-await.
            self._task_futures.pop(_tid, None)
            if not f.cancelled() and f.exception() is None:
                reply = f.result()
                if not reply.get("error"):
                    self._replies[_tid] = reply
                    while len(self._replies) > 4096:
                        self._replies.pop(next(iter(self._replies)))

        fut.add_done_callback(_on_done)
        # Locally-infeasible tasks QUEUE here too (not fail): the spillback
        # pass forwards them when another node has capacity, and until then
        # they ride the heartbeat's queued_demands — the signal the
        # autoscaler provisions against (reference: infeasible tasks stay
        # pending and drive resource_demand_scheduler).
        item = {"payload": p, "future": fut, "skey": skey,
                "label": _SchedQueues.class_label(skey),
                "t": time.monotonic(), "spilling": False}
        # separate stamp: spillback backoff resets item["t"], but the
        # span's queue_wait, the per-class oldest_wait_s and the wait-p99
        # samples must all cover the FULL local wait (a class whose head
        # keeps failing spillback is starving, not freshly enqueued)
        item["t_enq"] = item["t"]
        # deadline budget: end-to-end staleness bound measured from local
        # enqueue (clocks don't cross processes); an expired item is shed
        # by the dispatch head check or the heartbeat sweep
        if p.get("deadline_s"):
            item["expires"] = item["t"] + float(p["deadline_s"])
        self._squeue.push(item)
        self._task_event(task_id, p.get("fn_name"), "PENDING",
                         trace=p.get("trace"))
        self._dispatch_event.set()
        return await asyncio.shield(fut)

    def _local_features(self, skey=None, payload=None) -> Dict[str, Any]:
        """This node's feature vector for a placement receipt's candidate
        set: the local half of what rpc_route_task's candidates carry for
        peers (queue state, warm pool, resource headroom) plus the one
        feature only the origin raylet knows — how many bytes of the
        task's args are already plasma-resident here (the locality input a
        learned placement policy would weigh)."""
        out: Dict[str, Any] = {
            "node_id": self.node_id,
            "queue_depth": len(self._squeue),
            "warm_idle": len(self._idle.get(_WARM_KEY, ())),
            "headroom": self.node.available.to_dict(),
        }
        if skey is not None:
            out["class_depth"] = self._squeue.depth(skey)
            head = self._squeue.head(skey)
            out["oldest_wait_s"] = round(max(
                0.0, time.monotonic() - head["t_enq"]), 3) if head else 0.0
        if payload is not None:
            locality = 0
            entries = list(payload.get("args") or ())
            entries += list((payload.get("kwargs") or {}).values())
            for ent in entries:
                try:
                    kind, val = ent
                    if kind != "ref":
                        continue
                    oid = val[0].hex()
                    if oid in self._local_objects:
                        meta = self._object_meta.get(oid) or {}
                        if not meta.get("spilled"):
                            locality += int(meta.get("size", 0))
                except Exception:  # noqa: BLE001 — telemetry only
                    continue
            out["locality_bytes"] = locality
        return out

    def _placement_event(self, rec: Dict[str, Any]) -> None:
        """Placement decision receipt (kind, chosen node, reason, candidate
        features) bound for the GCS ``placement_events`` store. Rides the
        SAME coalesced ``task_events`` channel as state events — one
        batched drain, no second RPC path — and is routed to its own store
        on arrival. Observability only: never blocks the dispatch path."""
        msg = {"task_id": rec.get("task_id"), "placement": rec}
        if get_config().task_event_flush_s <= 0:
            async def _send(m=rec):
                try:
                    await self._gcs.call("placement_event", m)
                except Exception:  # noqa: BLE001 — observability only
                    pass

            spawn_task(_send())
            return
        self._task_event_buf.append(msg)
        if not self._task_event_flushing:
            self._task_event_flushing = True
            spawn_task(self._flush_task_events())

    def _task_event(self, task_id: str, name, state: str,
                    trace: "Optional[Dict]" = None,
                    phases: "Optional[Dict]" = None,
                    worker_source: Optional[str] = None,
                    spill_hop: "Optional[Dict]" = None) -> None:
        """Buffered state event to the GCS task store (reference:
        TaskEventBuffer -> GcsTaskManager); observability only, never blocks
        or fails the task path. Events COALESCE into one batched
        ``task_events`` RPC per flush window instead of one round-trip per
        state change — at 3 states per task the unbatched form dominated
        the submit hot path's GCS chatter. A single in-flight flusher
        drains the buffer FIFO, so per-task state order is preserved.
        ``trace`` carries the span context when the submitter had tracing
        enabled; ``phases`` the per-phase latency breakdown this raylet
        measured for a traced task."""
        msg = {"task_id": task_id, "name": name, "state": state,
               "node_id": self.node_id}
        if state is not None:
            # client-side stamp (the driver's phase partials already do
            # this): batching would otherwise collapse a short task's
            # PENDING/RUNNING/FINISHED onto one server arrival time and
            # zero its timeline lane
            msg["times"] = {state: time.time()}
        if trace is not None:
            msg["trace"] = trace
        if phases:
            msg["phases"] = phases
        if worker_source is not None:
            msg["worker_source"] = worker_source
        if spill_hop is not None:
            msg["spill_hop"] = spill_hop
        if get_config().task_event_flush_s <= 0:
            # batching off: ship each event on its own fire-and-forget RPC
            async def _send(m=msg):
                try:
                    await self._gcs.call("task_event", m)
                except Exception:  # noqa: BLE001 — observability only
                    pass

            spawn_task(_send())
            return
        self._task_event_buf.append(msg)
        if state in ("FINISHED", "FAILED"):
            # terminal states flush NOW (whole buffer, order kept): the
            # owner's reply races this event to the GCS, and consumers
            # (tracing polls, the driver's phases partial) must find the
            # terminal event the moment the reply is visible — only the
            # PENDING/RUNNING chatter rides the coalescing window
            self._task_event_kick.set()
        if not self._task_event_flushing:
            self._task_event_flushing = True
            spawn_task(self._flush_task_events())

    async def _flush_task_events(self) -> None:
        try:
            while self._task_event_buf:
                if not self._task_event_kick.is_set():
                    try:
                        await asyncio.wait_for(
                            self._task_event_kick.wait(),
                            get_config().task_event_flush_s)
                    except asyncio.TimeoutError:
                        pass
                self._task_event_kick = asyncio.Event()
                while self._task_event_buf:
                    batch = []
                    while self._task_event_buf and len(batch) < 512:
                        batch.append(self._task_event_buf.popleft())
                    try:
                        await self._gcs.call("task_events",
                                             {"events": batch})
                    except Exception:  # noqa: BLE001 — observability only:
                        # drop this batch rather than loop hot against a
                        # down GCS; the finally-side retrigger retries the
                        # REST of the buffer after a pause (terminal events
                        # of a job's last tasks must not strand forever)
                        return
        finally:
            self._task_event_flushing = False
            if self._task_event_buf:
                spawn_task(self._reflush_task_events(1.0))
            elif self._task_event_kick.is_set():
                # a terminal event that landed mid-drain (and was drained)
                # set the kick; left set, the next flusher would skip the
                # coalescing window and ship 1-event batches
                self._task_event_kick = asyncio.Event()

    async def _reflush_task_events(self, delay_s: float) -> None:
        await asyncio.sleep(delay_s)
        if self._task_event_buf and not self._task_event_flushing:
            self._task_event_flushing = True
            await self._flush_task_events()

    async def _try_spillback(self, item) -> None:
        """Forward a queued-but-waiting task to a node with free capacity.
        The task stays in our queue (flagged) until a target accepts it, so
        local dispatch can still claim it if the attempt finds nothing."""
        payload = dict(item["payload"])
        payload["spill_count"] = payload.get("spill_count", 0) + 1
        # Acyclic hop chain: a spilled task must never return to a node it
        # already visited. Two loaded nodes ping-ponging one task would each
        # hit the peer's duplicate-task_id guard and JOIN the other's
        # held-open original future while the task sits in NEITHER queue —
        # a distributed deadlock (both futures wait on each other forever).
        path = [n for n in (item["payload"].get("spill_path") or ())
                if n != self.node_id]
        path.append(self.node_id)
        payload["spill_path"] = path
        payload.pop("spillback_hint", None)
        try:
            route = await self._gcs.call("route_task", {
                "resources": payload["resources"],
                "strategy": payload.get("strategy"),
                "require_available": True, "exclude": list(path),
                # placement receipts: ship the considered candidates'
                # feature vectors back so the hop record is truthful
                "features": True})
        except Exception:
            route = {}
        if not route.get("address"):
            item["spilling"] = False
            item["t"] = time.monotonic()  # back off before the next attempt
            return
        if not self._squeue.remove(item):
            item["spilling"] = False
            return  # local dispatch already claimed it
        # hop hand-off time, captured BEFORE the forward: the forward's
        # submit_task is held open until the task COMPLETES remotely, so
        # measuring after the call would fold the whole remote execution
        # into the hop. The spillback phase = local wait + routing overhead
        # up to hand-off (the remote raylet owns queue_wait onward).
        hop_s = time.monotonic() - item.get("t_enq", item["t"])
        try:
            client = await self._pool.get(route["address"])
            reply = await client.call("submit_task", payload)
        except Exception:
            # Target died between the GCS view and the forward: the task is
            # still locally runnable — requeue it rather than failing the
            # caller (same task_id, so a remote execution that did land
            # dedups at that raylet; tasks are retry-idempotent by contract).
            item["spilling"] = False
            item["t"] = time.monotonic()
            self._squeue.push(item)
            self._dispatch_event.set()
            return
        if isinstance(reply, dict) and reply.get("error") == "backpressure":
            # the peer's admission bound is its own: this task was already
            # admitted HERE — requeue locally instead of propagating a
            # bounce the owner never earned (fail-fast callers would raise
            # BackpressureError for a node they never overloaded).
            # Deliberately NO placement receipt on this requeue (nor on the
            # no-target / forward-failure paths above): the task did not
            # move, and stamping a bounced attempt would double-count the
            # eventual successful hop.
            item["spilling"] = False
            item["t"] = time.monotonic()
            self._squeue.push(item)
            self._dispatch_event.set()
            return
        # the task moved: THE one spillback stamp site. reason carries why
        # the local node was rejected (_maybe_spill_class stamped it on the
        # item); candidates = this node's features + the GCS's view of the
        # peers it considered.
        reason = item.get("spill_reason") or "queue_bound"
        self._placement_event({
            "kind": "spillback",
            "task_id": payload.get("task_id"),
            "name": payload.get("fn_name"),
            "from_node": self.node_id,
            "node_id": route.get("node_id"),
            "reason": reason,
            "hops": payload["spill_count"],
            "path": path + [route.get("node_id")],
            "candidates": ([self._local_features(item.get("skey"),
                                                 payload)]
                           + (route.get("candidates") or [])),
        })
        if payload.get("trace") is not None:
            # the hop joins the task's phase breakdown: a phases-only
            # partial merging into the event the executing node owns
            self._task_event(
                payload["task_id"], payload.get("fn_name"), None,
                phases={"spillback": hop_s},
                spill_hop={"from": self.node_id,
                           "to": route.get("node_id"),
                           "reason": reason})
        fut = item["future"]
        if not fut.done():
            fut.set_result(reply)

    async def _dispatch_loop(self) -> None:
        while True:
            await self._dispatch_event.wait()
            self._dispatch_event.clear()
            self._dispatch_pass()

    def _dispatch_pass(self) -> None:
        """One fairness sweep over the per-class queues (reference:
        ``LocalTaskManager::ScheduleAndDispatchTasks`` over per-class
        deques): classes take turns claiming resources — one dispatch per
        class per turn, FIFO within a class, and a class that dispatched
        rotates to the back. A 5k-deep bulk class therefore costs a 1-task
        probe class exactly one dispatch slot, not the whole backlog.
        Sweeps repeat until a full rotation makes no progress (resources
        exhausted or every head blocked)."""
        progressed = True
        while progressed:
            progressed = False
            for key in self._squeue.keys():
                while True:
                    item = self._squeue.head(key)
                    if item is None:
                        break
                    outcome = self._try_dispatch_head(item)
                    if outcome == "dispatched":
                        self._squeue.pop_head(key)
                        self._squeue.rotate(key)
                        progressed = True
                        break  # one dispatch per class per turn
                    if outcome == "resolved":
                        # errored/evicted head: drop it and inspect the
                        # next item without losing this class's turn
                        self._squeue.pop_head(key)
                        progressed = True
                        continue
                    # "blocked": the class waits for local resources — but
                    # let a bounded window of it offload in PARALLEL
                    # (head-only spillback would drain a backlog onto an
                    # idle peer at one task per round-trip)
                    self._maybe_spill_class(key)
                    break  # next class's turn

    def _try_dispatch_head(self, item: Dict) -> str:
        """Attempt one head-of-class dispatch. Returns ``"dispatched"``
        (resources claimed, task launched), ``"resolved"`` (the item
        finished without running — error reply or deadline eviction; pop
        it) or ``"blocked"`` (the class waits for resources/spillback)."""
        payload = item["payload"]
        now = time.monotonic()
        if item.get("spilling"):
            return "blocked"  # a spillback attempt owns it
        if item["future"].done():
            return "resolved"  # owner gone / already answered elsewhere
        if item.get("expires") is not None and now > item["expires"]:
            self._evict_item(item, now)
            return "resolved"
        req = ResourceSet(payload["resources"])
        pg = payload.get("pg")
        if pg is not None:
            bundle = self._bundles.get((pg["pg_id"], pg["bundle_index"]))
            if bundle is None:
                self._failure_event(
                    F.PG_REMOVED,
                    "placement group bundle not on this node "
                    "(removed or rescheduled)",
                    task_id=payload.get("task_id"),
                    name=payload.get("fn_name"),
                    pg_id=pg.get("pg_id"))
                if not item["future"].done():
                    item["future"].set_result({
                        "error": "bundle_gone",
                        "message": "placement group bundle not on this "
                                   "node (removed or rescheduled)",
                        "cause": F.cause_dict(
                            F.PG_REMOVED,
                            "placement group bundle not on this "
                            "node (removed or rescheduled)",
                            node_id=self.node_id,
                            pg_id=pg.get("pg_id"))})
                return "resolved"
            if not bundle.pool.is_feasible(req):
                msg = (f"task requires {req.to_dict()} but "
                       f"its placement group bundle only has "
                       f"{bundle.pool.total.to_dict()}")
                self._failure_event(
                    F.SCHEDULING_TIMEOUT, msg,
                    task_id=payload.get("task_id"),
                    name=payload.get("fn_name"))
                if not item["future"].done():
                    item["future"].set_result({
                        "error": "infeasible", "message": msg,
                        "cause": F.cause_dict(
                            F.SCHEDULING_TIMEOUT, msg,
                            node_id=self.node_id)})
                return "resolved"
            pool = bundle.pool
        else:
            pool = self.node
        local_ok = pg is not None or strategy_allows_local(
            payload.get("strategy"), self.node_id, self.node.labels)
        if local_ok and pool.can_fit(req):
            assignment = pool.allocate(req)
            # placement receipt: local dispatches flood, but the GCS store
            # dedups same-shaped decisions into one counted row, so this
            # stays one cheap dict per dispatch on the wire at worst
            self._placement_event({
                "kind": "dispatch_local",
                "task_id": payload.get("task_id"),
                "name": payload.get("fn_name"),
                "node_id": self.node_id,
                "reason": "pg_bundle" if pg is not None else "local_fit",
                "candidates": [self._local_features(item.get("skey"),
                                                    payload)],
            })
            spawn_task(self._run_task(item, req, assignment, pool))
            return "dispatched"
        # Load-based spillback (reference: spillback replies in
        # ScheduleAndDispatchTasks) is handled class-wide by
        # _maybe_spill_class on the "blocked" return: a feasible task that
        # has waited past the delay looks for a node with capacity free
        # NOW. PG tasks are bundle-pinned — never spill; strategy-
        # ineligible tasks MUST route and are exempt from the hop cap.
        return "blocked"

    _SPILL_SCAN = 32   # items of a blocked class scanned for spillback
    _SPILL_CONC = 8    # concurrent spillback attempts per class

    def _maybe_spill_class(self, key: Tuple) -> None:
        """Mark up to ``_SPILL_CONC`` eligible items of a blocked class as
        spilling and launch their attempts. Eligibility mirrors the head
        path: never PG-pinned, hop cap honored (strategy-ineligible items
        are exempt), waited past the spillback delay, not expired."""
        cfg = get_config()
        now = time.monotonic()
        budget = self._SPILL_CONC
        launch = []
        for item in self._squeue.window(key, self._SPILL_SCAN):
            if item.get("spilling"):
                budget -= 1
                if budget <= 0:
                    break  # cap reached — still launch what we collected
                continue
            payload = item["payload"]
            if payload.get("pg") is not None or item["future"].done():
                continue
            if (item.get("expires") is not None
                    and now > item["expires"]):
                continue  # the sweep/head check sheds it
            local_ok = strategy_allows_local(
                payload.get("strategy"), self.node_id, self.node.labels)
            if ((not local_ok
                 or payload.get("spill_count", 0) < cfg.spillback_max_hops)
                    and now - item.get("t", 0) > cfg.spillback_delay_s):
                # stamp WHY the local node was rejected, while the local
                # view that rejected it is still in hand — the decision
                # record's reason must be truthful, not reconstructed
                if not local_ok:
                    item["spill_reason"] = "strategy_ineligible"
                elif not self.node.is_feasible(
                        ResourceSet(payload["resources"])):
                    item["spill_reason"] = "resource_infeasible"
                elif item.get("expires") is not None:
                    item["spill_reason"] = "deadline_pressure"
                else:
                    item["spill_reason"] = "queue_bound"
                launch.append(item)
                budget -= 1
                if budget <= 0:
                    break
        for item in launch:
            item["spilling"] = True
            spawn_task(self._try_spillback(item))

    def _evict_expired(self, now: Optional[float] = None) -> int:
        """Deadline sweep: shed every queued item whose budget expired
        (spillback-owned items are skipped — they are mid-move). Runs from
        the heartbeat loop; the dispatch head check catches the rest."""
        if not self._squeue.expiring:
            return 0  # nothing carries a deadline: skip the full scan
        now = time.monotonic() if now is None else now
        expired = [item for item in self._squeue.items()
                   if item.get("expires") is not None
                   and now > item["expires"] and not item.get("spilling")]
        for item in expired:
            if self._squeue.remove(item):
                self._evict_item(item, now)
        return len(expired)

    def _evict_item(self, item: Dict, now: float) -> None:
        """Deadline eviction: resolve the owner's submit with a
        ``scheduling_timeout`` cause (an ORGANIC failure-feed row — shed
        stale work is a real scheduling outcome, not an injected one) and
        count it. The caller removes the item from the queue."""
        payload = item["payload"]
        waited = now - item.get("t_enq", item["t"])
        msg = (f"deadline_s={payload.get('deadline_s')} budget expired "
               f"after {waited:.1f}s in the raylet queue (class "
               f"{item['label']!r}); stale work shed instead of executed "
               f"late")
        self._sched_stats["deadline_evictions"] += 1
        if self._telemetry:
            try:
                self._telemetry_metrics()["deadline_evictions"].inc(
                    1.0, {"node_id": self.node_id})
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        cause = F.cause_dict(F.SCHEDULING_TIMEOUT, msg,
                             node_id=self.node_id,
                             task_id=payload.get("task_id"))
        self._failure_event(F.SCHEDULING_TIMEOUT, msg,
                            task_id=payload.get("task_id"),
                            name=payload.get("fn_name"))
        self._task_event(payload["task_id"], payload.get("fn_name"),
                         "FAILED")
        fut = item["future"]
        if not fut.done():
            fut.set_result({"error": "deadline_exceeded", "message": msg,
                            "cause": cause})

    async def _run_task(self, item, req: ResourceSet, assignment,
                        pool: NodeResources) -> None:
        payload, fut = item["payload"], item["future"]
        task_id = payload["task_id"]
        gpus = assignment.get(GPU, [])
        renv = payload.get("runtime_env")
        t_claim = time.monotonic()
        if self._telemetry:
            self._telemetry_metrics()["queue_wait"].observe(
                t_claim - item["t"], {"node_id": self.node_id})
        # per-class wait sample (feeds the heartbeat's wait_p99_s and the
        # doctor starvation finding); bounded ring per class label
        dq = self._class_waits.get(item.get("label") or "anonymous")
        if dq is None:
            dq = self._class_waits.setdefault(
                item.get("label") or "anonymous",
                collections.deque(maxlen=512))
        dq.append((t_claim, t_claim - item.get("t_enq", item["t"])))
        # Phase tracing (one predicate when untraced): this raylet owns
        # queue_wait / worker_acquire / transfer / sched_overhead; the
        # worker's reply contributes arg_fetch / execute / result_store.
        traced = payload.get("trace") is not None
        t_enq = item.get("t_enq", item["t"])
        phases: Optional[Dict[str, float]] = (
            {"queue_wait": t_claim - t_enq} if traced else None)
        source = None
        # worker reuse is keyed by (GPU set, env hash): a process prepared
        # for one runtime env never executes another env's tasks (reference:
        # WorkerPool cache keyed by runtime-env hash)
        key = (tuple(gpus), renv["hash"] if renv else None)
        self._inflight[task_id] = {"req": req, "released": ResourceSet(),
                                   "pool": pool}
        worker = None
        try:
            worker, source = await self._get_worker(key, gpus, renv)
            # warm-pool accounting: a pool hit skipped an interpreter boot
            if source == "warm":
                self._sched_stats["warm_hits"] += 1
                if self._telemetry:
                    try:
                        self._telemetry_metrics()["warm_hits"].inc(
                            1.0, {"node_id": self.node_id, "kind": "task"})
                    except Exception:  # noqa: BLE001 — telemetry only
                        pass
            else:
                self._sched_stats["cold_spawns"] += 1
            f = C.maybe_fire("raylet.kill_worker",
                             target=payload.get("fn_name"))
            if f is not None:
                # kill the acquired worker just before the push: the push
                # fails, the normal worker_crash path runs, and the owner's
                # retry budget proves recovery. Counters live in this
                # long-lived raylet, so at/max_fires plans stay exact.
                self._chaos_stamp("raylet.kill_worker", f, task_id=task_id,
                                  name=payload.get("fn_name"),
                                  worker_id=worker.worker_id)
                try:
                    worker.proc.kill()
                except ProcessLookupError:
                    pass
            worker.busy = True
            worker.job_id = payload.get("job_id")
            worker.current_task = payload.get("fn_name")
            self._task_event(task_id, payload.get("fn_name"), "RUNNING")
            t_acq = time.monotonic()
            try:
                reply = await worker.client.call("push_task", payload)
            finally:
                self._release_worker(worker)
            failed = (reply.get("error")
                      or reply.get("stream_error") is not None)
            if traced:
                now = time.monotonic()
                phases["worker_acquire"] = t_acq - t_claim
                worker_phases = reply.pop("worker_phases", None) or {}
                worker_total = sum(worker_phases.values())
                phases.update(worker_phases)
                # push RPC + marshalling around the worker's own span;
                # also absorbs any raylet event-loop latency inside the
                # push window (the queue side of that latency is already
                # inside queue_wait)
                phases["transfer"] = max(0.0, (now - t_acq) - worker_total)
                reply["phases"] = phases
                reply["phases_total"] = now - t_enq
                reply["worker_source"] = source
            self._task_event(task_id, payload.get("fn_name"),
                             "FAILED" if failed else "FINISHED",
                             phases=phases, worker_source=source)
            if not fut.done():
                fut.set_result(reply)
        except Exception as e:  # worker crashed mid-task or failed to start
            self._task_event(task_id, payload.get("fn_name"), "FAILED")
            if worker is not None and worker.oom_killed:
                cause = F.cause_dict(
                    F.OOM_KILL,
                    f"memory monitor killed the worker running "
                    f"{payload.get('fn_name')!r} "
                    f"(node over memory_usage_threshold)",
                    node_id=self.node_id, task_id=task_id,
                    worker_id=worker.worker_id)
                err_kind = "oom_killed"
            else:
                cause = F.cause_dict(
                    F.WORKER_CRASH, repr(e), node_id=self.node_id,
                    task_id=task_id,
                    worker_id=worker.worker_id if worker else None)
                err_kind = "worker_crashed"
            self._failure_event(cause["category"], cause["message"],
                                task_id=task_id,
                                name=payload.get("fn_name"))
            if not fut.done():
                fut.set_result({"error": err_kind,
                                "message": cause["message"],
                                "cause": cause})
        finally:
            state = self._inflight.pop(task_id)
            pool.release(state["req"].subtract(state["released"]), assignment)
            self._dispatch_event.set()

    async def rpc_task_blocked(self, p):
        """A worker entered a blocking ``get`` inside a task: return its CPU
        to the pool so dependent tasks can run (the reference's
        blocked-worker CPU release — prevents parent-waits-on-child
        deadlock). The CPU is not re-acquired on unblock; it flows back when
        the task finishes."""
        state = self._inflight.get(p["task_id"])
        if state is None or not state["released"].is_empty():
            return {"ok": False}
        cpu_part = ResourceSet({CPU: state["req"].get(CPU)})
        if cpu_part.is_empty():
            return {"ok": False}
        state["released"] = cpu_part
        state["pool"].release(cpu_part)
        self._dispatch_event.set()
        return {"ok": True}

    # ---- placement group bundles -------------------------------------------
    async def rpc_prepare_bundle(self, p):
        """Phase 1 of the 2PC: reserve the bundle's resources (+gpus)."""
        key = (p["pg_id"], p["bundle_index"])
        if key in self._bundles:
            return {"ok": True}  # idempotent re-prepare
        req = ResourceSet(p["resources"])
        if not self.node.can_fit(req):
            return {"ok": False, "retry": True}
        assignment = self.node.allocate(req)
        self._bundles[key] = _BundleState(req, assignment)
        return {"ok": True}

    async def rpc_commit_bundle(self, p):
        bundle = self._bundles.get((p["pg_id"], p["bundle_index"]))
        if bundle is None:
            return {"ok": False}
        bundle.committed = True
        return {"ok": True}

    async def rpc_release_bundle(self, p):
        bundle = self._bundles.pop((p["pg_id"], p["bundle_index"]), None)
        if bundle is not None:
            self.node.release(bundle.node_req, bundle.node_assignment)
            self._dispatch_event.set()
        return {"ok": True}

    def _actor_pool(self, spec) -> Optional[NodeResources]:
        pg = spec.get("pg")
        if pg is None:
            return self.node
        bundle = self._bundles.get((pg["pg_id"], pg["bundle_index"]))
        return bundle.pool if bundle is not None else None

    # ---- actors -------------------------------------------------------------
    async def rpc_create_actor(self, p):
        spec = p["spec"]
        req = ResourceSet(spec.get("resources", {}))
        pool = self._actor_pool(spec)
        if pool is None:
            return {"ok": False, "retry": True}  # bundle not here (yet)
        if not pool.can_fit(req):
            return {"ok": False, "retry": True}
        assignment = pool.allocate(req)
        gpus = assignment.get(GPU, [])
        worker = None
        try:
            # Warm-pool adoption (reference: the worker pool handing a
            # prestarted worker to PopWorker): an actor that needs no
            # pinned GPUs and no runtime env takes over an idle pooled
            # worker instead of paying interpreter boot — an actor's
            # spawn cost is pure process startup.
            if (get_config().worker_adopt_for_actors and not gpus
                    and not spec.get("runtime_env")):
                idle = self._idle.get(_WARM_KEY)
                while idle:
                    cand = idle.pop()
                    if cand.proc.poll() is None:
                        worker = cand
                        worker.idle_since = None
                        worker.key = (("actor", p["actor_id"]),)
                        self._sched_stats["warm_hits"] += 1
                        self._sched_stats["actor_adoptions"] += 1
                        if self._telemetry:
                            try:
                                self._telemetry_metrics()["warm_hits"].inc(
                                    1.0, {"node_id": self.node_id,
                                          "kind": "actor"})
                            except Exception:  # noqa: BLE001
                                pass
                        break
                    self._workers.pop(cand.worker_id, None)
                if worker is not None:
                    # placement receipt: adoption is a placement decision —
                    # the warm pool won over a cold spawn on this node
                    self._placement_event({
                        "kind": "warm_adopt",
                        "actor_id": p["actor_id"],
                        "name": spec.get("class_name"),
                        "node_id": self.node_id,
                        "reason": "warm_pool_hit",
                        "candidates": [self._local_features()],
                    })
            if worker is None:
                self._sched_stats["cold_spawns"] += 1
                worker = self._spawn_worker((("actor", p["actor_id"]),),
                                            gpus, spec.get("runtime_env"))
            worker.is_actor_worker = True
            worker.job_id = spec.get("job_id")
            worker.actor_id = p["actor_id"]
            worker.assignment = assignment
            worker._spec_resources = spec.get("resources", {})
            worker._pool = pool
            cfg = get_config()
            await asyncio.wait_for(
                worker.ready,
                cfg.process_startup_timeout_s
                + (cfg.runtime_env_setup_timeout_s
                   if spec.get("runtime_env") else 0))
            reply = await worker.client.call("create_actor", p)
            if not reply.get("ok"):
                # Unmark before releasing so _reap_loop doesn't release the
                # same resources a second time (double-release would corrupt
                # GPU accounting).
                worker.is_actor_worker = False
                pool.release(req, assignment)
                self._terminate_worker(worker)  # reap loop collects it
                # user code raised in __init__: a task-error-category death
                cause = F.cause_dict(
                    F.TASK_ERROR,
                    reply.get("error", "actor __init__ failed"),
                    node_id=self.node_id, actor_id=p["actor_id"])
                await self._gcs.call("actor_update", {
                    "actor_id": p["actor_id"], "state": "DEAD",
                    "node_id": self.node_id,
                    "reason": cause["message"], "cause": cause})
                return {"ok": False, "error": reply.get("error"),
                        "cause": cause}
            await self._gcs.call("actor_update", {
                "actor_id": p["actor_id"], "state": "ALIVE",
                "address": reply["address"], "node_id": self.node_id})
            return {"ok": True}
        except Exception as e:
            if worker is not None:
                worker.is_actor_worker = False
                self._terminate_worker(worker)  # reap loop collects it
            pool.release(req, assignment)
            category = (F.RUNTIME_ENV_SETUP
                        if spec.get("runtime_env")
                        and isinstance(e, asyncio.TimeoutError)
                        else F.WORKER_CRASH)
            cause = F.cause_dict(category, repr(e), node_id=self.node_id,
                                 actor_id=p["actor_id"])
            # no _failure_event here: the GCS records this same cause when
            # the create reply finalizes the actor (emitting both would
            # double rt_failures_total for one failure)
            return {"ok": False, "error": repr(e), "cause": cause}

    async def rpc_kill_actor(self, p):
        for entry in list(self._workers.values()):
            if entry.actor_id == p["actor_id"]:
                entry.is_actor_worker = False  # suppress DEAD re-report
                entry.actor_id = None  # a later duplicate kill is a no-op
                getattr(entry, "_pool", self.node).release(
                    ResourceSet(entry_spec_resources(entry)), entry.assignment)
                self._terminate_worker(entry)
        return {"ok": True}

    # ---- object plane -------------------------------------------------------
    _PIN_TTL_S = 120.0

    def _purge_stale_pins(self, now: float) -> int:
        """Drop leaked get-pins (crashed getters): live pins span only a
        fetch→read window, so a stale ``t`` means nobody is waiting. Runs
        on the reap-loop TIMER (not just when the pin path happens to get
        hot), so a leaked pin can't silently exempt its object from
        spilling for the life of the raylet. Purges are counted — leaked
        pins are a visible signal, not silent cleanup."""
        purged = 0
        for oid_hex, entry in list(self._pinned.items()):
            if now - entry["t"] > self._PIN_TTL_S:
                self._pinned.pop(oid_hex, None)
                purged += 1
        if purged:
            self._mem_stats["pin_purges"] += purged
            if self._telemetry:
                try:
                    self._telemetry_metrics()["pin_purges"].inc(
                        float(purged), {"node_id": self.node_id})
                except Exception:  # noqa: BLE001 — cleanup must proceed
                    pass
        return purged

    async def rpc_pin_objects(self, p):
        now = time.monotonic()
        if len(self._pinned) > 1024:
            self._purge_stale_pins(now)  # burst guard between timer ticks
        for oid_hex in p["oids"]:
            entry = self._pinned.setdefault(oid_hex, {"count": 0, "t": now})
            entry["count"] += 1
            entry["t"] = now
        return {"ok": True}

    async def rpc_unpin_objects(self, p):
        for oid_hex in p["oids"]:
            entry = self._pinned.get(oid_hex)
            if entry is None:
                continue
            entry["count"] -= 1
            if entry["count"] <= 0:
                self._pinned.pop(oid_hex, None)
        # released pins may allow the store to shrink back under threshold
        await self._maybe_spill()
        return {"ok": True}

    def _refresh_pin(self, oid_hex: str) -> None:
        """Restart the TTL clock for the fetch-ok→read window: a getter may
        have blocked in fetch far past the TTL (late producer), and the pin
        must be live precisely when the object lands in shm. Recreates the
        entry if the purge dropped it while the getter was blocked."""
        entry = self._pinned.get(oid_hex)
        if entry is None:
            entry = self._pinned[oid_hex] = {"count": 1, "t": 0.0}
        entry["t"] = time.monotonic()

    def _is_pinned(self, oid_hex: str, now: float) -> bool:
        """Read-only (called from the spill executor thread; mutation happens
        only on the event loop). A stale ``t`` — crashed getter — is treated
        as unpinned but left for the event loop to purge."""
        entry = self._pinned.get(oid_hex)
        return entry is not None and now - entry["t"] <= self._PIN_TTL_S

    def _spill_path(self, oid_hex: str) -> str:
        return os.path.join(self._spill_dir, oid_hex)

    def _touch(self, oid_hex: str, size: Optional[int] = None,
               spilled: Optional[bool] = None) -> None:
        meta = self._object_meta.setdefault(
            oid_hex, {"size": 0, "t": 0.0, "spilled": False})
        before = 0 if meta["spilled"] else meta["size"]
        meta["t"] = time.monotonic()
        if size is not None:
            meta["size"] = size
        if spilled is not None:
            meta["spilled"] = spilled
        self._in_mem_bytes += (0 if meta["spilled"] else meta["size"]) - before

    async def _maybe_spill(self) -> None:
        """Capacity enforcement: when sealed bytes exceed the spill
        threshold, move least-recently-used objects out of shm onto disk
        (reference: ``LocalObjectManager::SpillObjects`` dispatched by the
        plasma LRU ``EvictionPolicy``). File IO runs on the spill executor so
        the raylet keeps dispatching. Locations in the GCS stay valid — this
        node still serves the object, just from disk."""
        # Cheap loop-side precheck: don't bounce through the executor (and
        # its lock) when the store is under threshold — unpin calls this on
        # every fetch. The spill thread re-checks exactly under the lock.
        cfg = get_config()
        threshold = self._store_capacity * cfg.object_spill_threshold
        if 0 <= self._in_mem_bytes <= threshold:
            return  # negative = drift; fall through so the pass resyncs
        spilled = await asyncio.get_running_loop().run_in_executor(
            self._spill_exec, self._spill_blocking)
        # telemetry off the IO thread: histograms + instant events per
        # spilled object (the byte-side twin of the queue-wait histogram)
        for oid_hex, size, secs in spilled or ():
            self._mem_stats["spills"] += 1
            self._mem_stats["spill_bytes"] += size
            self._mem_stats["spill_seconds"] += secs
            if self._telemetry:
                self._telemetry_metrics()["spill_hist"].observe(
                    secs, {"node_id": self.node_id})
            self._mem_event("spill", oid=oid_hex, size=size, seconds=secs)

    def _spill_blocking(self) -> List[Tuple[str, int, float]]:
        """Returns [(oid_hex, size, io_seconds)] for each object spilled."""
        cfg = get_config()
        threshold = self._store_capacity * cfg.object_spill_threshold
        out: List[Tuple[str, int, float]] = []
        with self._spill_lock:
            now = time.monotonic()
            in_mem = [(oid, m) for oid, m in self._object_meta.items()
                      if not m["spilled"]]
            used = sum(m["size"] for _, m in in_mem)
            if used <= threshold:
                return out
            in_mem.sort(key=lambda kv: kv[1]["t"])  # LRU first
            os.makedirs(self._spill_dir, exist_ok=True)
            for oid_hex, meta in in_mem:
                if used <= threshold:
                    break
                if self._is_pinned(oid_hex, now):
                    continue  # a getter holds this between fetch and read
                view = self.store.read(ObjectID.from_hex(oid_hex))
                if view is None:
                    meta["spilled"] = True  # vanished (e.g. freed mid-scan)
                    used -= meta["size"]
                    continue
                t0 = time.monotonic()
                fault = C.maybe_fire("spill.slow", target=oid_hex)
                if fault is not None:
                    # slow-disk injection (spill executor thread, so the
                    # stall hits the IO histogram, not the event loop)
                    self._chaos_stamp("spill.slow", fault, oid=oid_hex)
                    # rt: lint-allow(lock-discipline) chaos injection: the
                    # stall deliberately holds the spill lock like a real
                    # slow disk would (spill executor thread, not the loop)
                    time.sleep(float(fault.get("delay_s", 0.2)))
                tmp = self._spill_path(oid_hex) + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(view)
                meta["crc"] = _native.crc32c(view)
                os.rename(tmp, self._spill_path(oid_hex))
                self.store.delete(ObjectID.from_hex(oid_hex))
                meta["spilled"] = True
                used -= meta["size"]
                out.append((oid_hex, meta["size"], time.monotonic() - t0))
            # Exact resync of the O(1)-precheck counter: per-op increments
            # race across the loop/executor threads (non-atomic RMW, frees
            # during the scan); recomputing under the lock bounds any drift
            # to one spill pass.
            self._in_mem_bytes = sum(
                m["size"] for m in self._object_meta.values()
                if not m["spilled"])
        return out

    async def _restore_from_spill(self, oid_hex: str) -> bool:
        """Disk -> shm (reference: ``SpilledObjectReader`` restore path)."""
        t0 = time.monotonic()
        restored = await asyncio.get_running_loop().run_in_executor(
            self._spill_exec, self._restore_blocking, oid_hex)
        if restored:
            secs = time.monotonic() - t0
            size = self._object_meta.get(oid_hex, {}).get("size", 0)
            self._mem_stats["restores"] += 1
            self._mem_stats["restore_bytes"] += size
            self._mem_stats["restore_seconds"] += secs
            if self._telemetry:
                self._telemetry_metrics()["restore_hist"].observe(
                    secs, {"node_id": self.node_id})
            self._mem_event("restore", oid=oid_hex, size=size, seconds=secs)
            await self._maybe_spill()  # restoring may push something else out
        return restored

    def _restore_blocking(self, oid_hex: str) -> bool:
        with self._spill_lock:
            path = self._spill_path(oid_hex)
            if not os.path.exists(path):
                return False
            with open(path, "rb") as f:
                payload = f.read()
            expected = self._object_meta.get(oid_hex, {}).get("crc")
            if expected is not None:
                if _native.crc32c(payload) != expected:
                    # corrupt spill file: drop it; the owner reconstructs
                    # from lineage (better loud loss than silent corruption)
                    try:
                        os.unlink(path)
                    except FileNotFoundError:
                        pass
                    return False
            oid = ObjectID.from_hex(oid_hex)
            if not self.store.contains(oid):
                self.store.write_whole(oid, payload)
            self._touch(oid_hex, size=len(payload), spilled=False)
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            return True

    async def rpc_seal_object(self, p):
        oid_hex = p["oid"]
        self._local_objects.add(oid_hex)
        self._touch(oid_hex, size=p.get("size", 0), spilled=False)
        await self._maybe_spill()
        # degraded-aware: a sealed object must not fail its task because
        # the GCS is briefly unreachable — the location defers + resyncs
        await self._gcs_publish("add_object_location", {
            "oid": oid_hex, "node_id": self.node_id, "size": p.get("size", 0)})
        f = C.maybe_fire("object.lose", target=oid_hex)
        if f is not None:
            # silent-loss injection: the location is registered but the
            # payload vanishes — every later get must run the owner's
            # lineage reconstruction (the recovery path under test)
            self._chaos_stamp("object.lose", f, oid=oid_hex)
            self._drop_object_copies(oid_hex)
        return {"ok": True}

    def _drop_object_copies(self, oid_hex: str) -> None:
        """Delete every local copy of an object (shm + spill + meta) —
        the chaos object-loss effect."""
        try:
            self.store.delete(ObjectID.from_hex(oid_hex))
        except Exception:  # noqa: BLE001
            pass
        meta = self._object_meta.pop(oid_hex, None)
        if meta is not None and not meta.get("spilled"):
            self._in_mem_bytes -= meta["size"]
        try:
            os.unlink(self._spill_path(oid_hex))
        except OSError:
            pass

    async def rpc_get_object_payload(self, p):
        oid_hex = p["oid"]
        view = self.store.read(ObjectID.from_hex(oid_hex))
        if view is not None:
            self._touch(oid_hex)
            return {"payload": bytes(view)}
        path = self._spill_path(oid_hex)

        def read_spill():
            # spill-file IO off the event loop: a slow disk must not
            # stall heartbeats/dispatch (the spill pool already owns
            # this discipline for writes)
            try:
                with open(path, "rb") as f:
                    return f.read()
            except OSError:
                return None

        payload = await asyncio.get_running_loop().run_in_executor(
            self._spill_exec, read_spill)
        if payload is not None:
            return {"payload": payload}
        return {"error": "not found"}

    async def rpc_put_object_chunk(self, p):
        """Client-mode upload: a process WITHOUT shared shm (Ray-Client
        analog) streams an object into this node's store in bounded chunks;
        the final chunk seals + registers the location."""
        oid_hex = p["oid"]
        oid = ObjectID.from_hex(oid_hex)
        off, total, data = p["offset"], p["total"], p["data"]
        try:
            if off == 0:
                if self.store.contains(oid):
                    return {"ok": True, "dup": True}
                self._client_uploads[oid_hex] = (
                    self.store.create(oid, total), time.monotonic())
            entry = self._client_uploads.get(oid_hex)
            if entry is None:
                return {"error": "upload not started"}
            buf = entry[0]
            # TTL tracks last ACTIVITY, not start: a slow-but-live upload
            # must never be reaped mid-stream
            self._client_uploads[oid_hex] = (buf, time.monotonic())
            buf[off:off + len(data)] = data
            if p.get("seal"):
                self._client_uploads.pop(oid_hex, None)
                self.store.seal(oid)
                self._local_objects.add(oid_hex)
                self._touch(oid_hex, size=total, spilled=False)
                await self._maybe_spill()
                await self._gcs_publish("add_object_location", {
                    "oid": oid_hex, "node_id": self.node_id, "size": total})
            return {"ok": True}
        except Exception as e:  # noqa: BLE001 — drop partial upload
            self._client_uploads.pop(oid_hex, None)
            try:
                self.store.delete(oid)
            except Exception:  # noqa: BLE001
                pass
            return {"error": repr(e)}

    async def rpc_get_object_chunk(self, p):
        """Serve one bounded slice of an object (reference: chunked reads,
        ``object_manager/chunk_object_reader.h``); shm and spill-file copies
        both serve — the puller never needs the whole payload in one frame."""
        oid_hex, off, size = p["oid"], p["offset"], p["size"]
        kind = _native.checksum_kind()
        view = self.store.read(ObjectID.from_hex(oid_hex))
        if view is not None:
            self._touch(oid_hex)
            data = bytes(view[off:off + size])
            return {"total": len(view), "data": data,
                    "crc": _native.crc32c(data), "crc_kind": kind}
        path = self._spill_path(oid_hex)

        def read_slice():
            # spill-file IO off the event loop (see rpc_get_object_payload)
            total = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(off)
                return total, f.read(size)

        try:
            total, data = await asyncio.get_running_loop().run_in_executor(
                self._spill_exec, read_slice)
            return {"total": total, "data": data,
                    "crc": _native.crc32c(data), "crc_kind": kind}
        except FileNotFoundError:
            return {"error": "not found"}

    async def _pull_chunked(self, client, oid, oid_hex: str) -> Optional[int]:
        """Pull a remote object into local shm in bounded chunks, writing
        straight into the store's mmap (peak memory = one chunk). Returns
        the object size, or None if the source doesn't have it."""
        def _checked(reply) -> Optional[bytes]:
            data = reply.get("data")
            if data is None:
                return None
            crc = reply.get("crc")
            if crc is not None:
                # verify with the ALGORITHM THE SENDER USED — a mixed
                # native/fallback cluster must not fail every transfer
                ours = _native.checksum(data, reply.get("crc_kind", "crc32c"))
                if ours is not None and ours != crc:
                    raise ConnectionError(
                        f"chunk checksum mismatch for {oid_hex} "
                        f"(corruption in transit)")
            return data

        chunk = get_config().object_transfer_chunk_bytes
        first = await client.call("get_object_chunk",
                                  {"oid": oid_hex, "offset": 0, "size": chunk})
        if "data" not in first:
            return None
        total = first["total"]
        first_data = _checked(first)
        if total <= len(first_data):
            self.store.write_whole(oid, first_data)
            return total
        buf = self.store.create(oid, total)
        try:
            n = len(first_data)
            buf[:n] = first_data
            off = n
            while off < total:
                r = await client.call(
                    "get_object_chunk",
                    {"oid": oid_hex, "offset": off, "size": chunk})
                data = _checked(r)
                if not data:  # source freed/evicted mid-transfer
                    raise ConnectionError("chunk source went away")
                buf[off:off + len(data)] = data
                off += len(data)
            self.store.seal(oid)
            return total
        except Exception:
            self.store.delete(oid)  # drop the partial .building file
            raise

    async def rpc_fetch_object(self, p):
        """Pull an object to this node's store (reference: PullManager →
        remote ObjectManager chunked push). Resolution: local shm → local
        spill restore → remote node (which itself serves shm or spill)."""
        oid_hex = p["oid"]
        oid = ObjectID.from_hex(oid_hex)
        if self.store.contains(oid):
            self._touch(oid_hex)
            self._refresh_pin(oid_hex)
            return {"ok": True}
        if await self._restore_from_spill(oid_hex):
            self._refresh_pin(oid_hex)
            return {"ok": True}
        inflight = self._pulls.get(oid_hex)
        if inflight is not None:  # join the pull already transferring this
            reply = await asyncio.shield(inflight)
            if reply.get("ok"):
                self._refresh_pin(oid_hex)
            return reply
        fut = asyncio.get_running_loop().create_future()
        self._pulls[oid_hex] = fut
        try:
            reply = await self._do_fetch(oid, oid_hex,
                                         p.get("timeout", 30.0))
        except Exception as e:  # noqa: BLE001 — joiners need a result too
            reply = {"error": "unavailable", "oid": oid_hex,
                     "message": repr(e)}
        finally:
            self._pulls.pop(oid_hex, None)
            if not fut.done():
                fut.set_result(reply)
        return reply

    async def _do_fetch(self, oid, oid_hex: str, timeout: float) -> Dict:
        reply = await self._gcs.call("get_object_locations", {
            "oid": oid_hex, "wait": True, "timeout": timeout})
        for loc in reply["locations"]:
            if loc["node_id"] == self.node_id:
                continue
            try:
                client = await self._pool.get(loc["address"])
                total = await self._pull_chunked(client, oid, oid_hex)
                if total is not None:
                    self._refresh_pin(oid_hex)
                    await self.rpc_seal_object({"oid": oid_hex,
                                                "size": total})
                    return {"ok": True}
            except Exception:
                continue
        if self.store.contains(oid) or await self._restore_from_spill(oid_hex):
            self._refresh_pin(oid_hex)
            return {"ok": True}
        return {"error": "unavailable", "oid": oid_hex}

    async def rpc_free_objects(self, p):
        for oid_hex in p["oids"]:
            self.store.delete(ObjectID.from_hex(oid_hex))
            self._local_objects.discard(oid_hex)
            meta = self._object_meta.pop(oid_hex, None)
            if meta is not None and not meta["spilled"]:
                self._in_mem_bytes -= meta["size"]
            self._pinned.pop(oid_hex, None)
            try:
                os.unlink(self._spill_path(oid_hex))
            except FileNotFoundError:
                pass
            await self._gcs_publish("remove_object_location", {
                "oid": oid_hex, "node_id": self.node_id})
        return {"ok": True}

    async def rpc_node_stats(self, p):
        return {
            "node_id": self.node_id,
            "workers": len(self._workers),
            "idle": sum(len(v) for v in self._idle.values()),
            "queued": len(self._squeue),
            "sched": self._sched_summary(),
            "object_store_bytes": self.store.used_bytes(),
            "available": self.node.available.to_dict(),
        }

    async def rpc_memory_report(self, p):
        """Node memory introspection for memory_summary() / `rt memory`:
        store usage by state, cumulative spill/restore/OOM counters, the
        per-object table (largest first, bounded by ``limit``) and live
        worker RSS (reference: the NodeManager stats behind
        ``ray memory`` / ``memory_summary``)."""
        now_mono = time.monotonic()
        states = self._store_state_bytes()
        limit = p.get("limit") or 200
        objects = []
        # snapshot first: the spill/restore executor thread inserts keys
        # concurrently, and a plain .items() walk could see a resize
        meta_items = list(self._object_meta.items())
        for oid_hex, meta in meta_items:
            pinned = self._is_pinned(oid_hex, now_mono)
            objects.append({
                "oid": oid_hex, "size": meta["size"],
                "state": ("spilled" if meta.get("spilled")
                          else "pinned" if pinned else "in_memory"),
                "age_s": max(0.0, now_mono - meta["t"]),
                "pinned": pinned})
        objects.sort(key=lambda d: -d["size"])
        by_pid = {e.proc.pid: e for e in self._workers.values()
                  if e.proc.poll() is None}
        workers = [{
            "worker_id": by_pid[pid].worker_id, "pid": pid, "rss": rss,
            "busy": by_pid[pid].busy,
            "actor_id": by_pid[pid].actor_id,
            "task": by_pid[pid].current_task}
            for pid, rss in _native.process_memory(list(by_pid))
            if pid in by_pid]
        mem = _native.memory_info()
        return {
            "node_id": self.node_id,
            "address": self.server.address,
            "node_memory": {"total": mem.get("total", -1),
                            "used": mem.get("used", -1)},
            "store": {
                "used_bytes": self.store.used_bytes(),
                "capacity_bytes": self._store_capacity,
                "in_mem_bytes": states["in_memory"],
                "spilled_bytes": states["spilled"],
                "pinned_bytes": states["pinned"],
                "spilled_count": sum(
                    1 for _, m in meta_items if m.get("spilled")),
                "pinned_count": len(self._pinned),
                "num_objects": len(meta_items),
                **{k: v for k, v in self._mem_stats.items()},
            },
            "objects": objects[:limit],
            "workers": workers,
        }

    async def rpc_dump_stacks(self, p):
        """Node-wide live stack capture (the py-spy-equivalent endpoint,
        reference ``dashboard/modules/reporter/profile_manager.py:11``):
        this raylet's threads + every live worker's, via each worker's
        ``dump_stacks`` RPC. A worker that can't respond in time (GIL held
        by native code) is reported unreachable rather than hanging the
        whole capture."""
        out = [{"pid": os.getpid(), "role": "raylet",
                "stacks": format_current_stacks()}]

        async def one(entry):
            info = {"pid": entry.proc.pid, "role": "actor"
                    if entry.is_actor_worker else "worker",
                    "worker_id": entry.worker_id, "busy": entry.busy}
            try:
                if entry.client is None:
                    raise RuntimeError("not yet registered")
                reply = await asyncio.wait_for(
                    entry.client.call("dump_stacks", {}),
                    timeout=p.get("timeout", 3.0))
                info["stacks"] = reply["stacks"]
            except Exception as e:  # noqa: BLE001 — report, don't fail
                info["unreachable"] = f"{type(e).__name__}: {e}"
            return info

        live = [e for e in self._workers.values()
                if e.proc.poll() is None]
        out.extend(await asyncio.gather(*(one(e) for e in live)))
        return {"node_id": self.node_id, "processes": out}


def entry_spec_resources(entry) -> Dict[str, float]:
    return getattr(entry, "_spec_resources", {})
