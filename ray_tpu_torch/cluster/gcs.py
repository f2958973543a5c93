"""GCS: the cluster control plane (head-node metadata + actor lifecycle).

Reference analog: ``src/ray/gcs/gcs_server/`` — node membership + health
(``GcsNodeManager``, ``GcsHealthCheckManager``), actor lifecycle + restart
(``GcsActorManager``/``GcsActorScheduler``), internal KV (``GcsKvManager``,
also the function table), the object directory, and named actors. State is
in-memory (a Redis-backed store client is a later HA concern).

Long-poll futures replace the reference's pubsub channels for the two hot
subscriptions (actor-alive, object-location): O(#waiters) wakeups, no
polling.
"""

from __future__ import annotations

import asyncio
import pickle
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.core import failure as F
from ray_tpu_torch.core.resources import NodeResources, ResourceSet
from ray_tpu_torch.cluster.rpc import ConnectionPool, spawn_task
from ray_tpu_torch.scheduler.policy import pick_node
from ray_tpu_torch.util import chaos as C

ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"


class _NodeEntry:
    def __init__(self, node_id: str, address: str, resources: Dict[str, float],
                 labels: Dict[str, str]):
        self.node_id = node_id
        self.address = address
        self.view = NodeResources(resources, labels)
        self.alive = True
        self.last_heartbeat = time.monotonic()


class _ActorEntry:
    def __init__(self, actor_id: str, spec: Dict[str, Any]):
        self.actor_id = actor_id
        self.spec = spec                      # picklable creation spec
        self.state = ACTOR_PENDING
        self.address: Optional[str] = None
        self.node_id: Optional[str] = None
        self.num_restarts = 0
        self.death_reason = ""           # str(death_cause): legacy renderers
        self.death_cause: Optional[Dict[str, Any]] = None  # failure.py wire
        self.waiters: List[asyncio.Future] = []

    def __getstate__(self):  # snapshot persistence: waiters are loop-affine
        state = dict(self.__dict__)
        state["waiters"] = []
        return state

    def info(self) -> Dict[str, Any]:
        return {
            "actor_id": self.actor_id, "state": self.state,
            "address": self.address, "node_id": self.node_id,
            "name": self.spec.get("name"), "namespace": self.spec.get("namespace"),
            "class_name": self.spec.get("class_name"),
            "num_restarts": self.num_restarts,
            "death_reason": self.death_reason,
            "death_cause": getattr(self, "death_cause", None),
            "max_task_retries": self.spec.get("max_task_retries", 0),
        }


PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_REMOVED = "REMOVED"


class _PgEntry:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str, name: str):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.state = PG_PENDING
        self.bundle_nodes: List[Optional[str]] = [None] * len(bundles)
        self.waiters: List[asyncio.Future] = []
        self._rr = 0  # round-robin pointer for bundle_index=-1 routing

    def __getstate__(self):  # snapshot persistence: waiters are loop-affine
        state = dict(self.__dict__)
        state["waiters"] = []
        return state

    def info(self) -> Dict[str, Any]:
        return {"pg_id": self.pg_id, "state": self.state, "name": self.name,
                "strategy": self.strategy, "bundles": self.bundles,
                "bundle_nodes": list(self.bundle_nodes)}


def _strategy_kind(strategy: Any) -> str:
    """Reason token for a placement receipt: the scheduling strategy's kind
    (a strategy arrives over RPC as an object or a plain dict)."""
    if strategy is None:
        return "default"
    if isinstance(strategy, dict):
        return str(strategy.get("kind", "default")).lower()
    return str(getattr(strategy, "kind", strategy)).lower()


def imbalance_cov(loads: List[float]) -> float:
    """Population coefficient of variation (std/mean) of per-node load.

    0.0 means perfectly balanced; degenerate inputs (fewer than two nodes,
    or an idle cluster with zero mean) are defined as balanced rather than
    undefined — a one-node cluster can't be imbalanced.
    """
    vals = [float(v) for v in loads]
    if len(vals) < 2:
        return 0.0
    mean = sum(vals) / len(vals)
    if mean <= 0:
        return 0.0
    var = sum((v - mean) ** 2 for v in vals) / len(vals)
    return (var ** 0.5) / mean


class GcsServer:
    def __init__(self, persist_path: Optional[str] = None):
        self.nodes: Dict[str, _NodeEntry] = {}
        self.kv: Dict[str, bytes] = {}
        self.actors: Dict[str, _ActorEntry] = {}
        self.named_actors: Dict[Tuple[str, str], str] = {}
        self.placement_groups: Dict[str, _PgEntry] = {}
        self.object_locations: Dict[str, Set[str]] = {}
        self.object_sizes: Dict[str, int] = {}
        self._location_waiters: Dict[str, List[asyncio.Future]] = {}
        self._pool = ConnectionPool(peer_id="gcs")
        self._monitor_task: Optional[asyncio.Task] = None
        self._job_counter = 0
        # chaos-plan revision (snapshotted): a restarted head must NOT come
        # back at rev 0 while the KV still holds the plan — raylets would
        # see a rev change, re-arm, and reset spent kill-once fire budgets
        self._chaos_rev = 0
        # Snapshot persistence (reference: the Redis store client behind the
        # GCS tables, ``store_client/redis_store_client.cc`` — here a pickle
        # snapshot so a restarted head recovers actors/PGs/locations, plus a
        # crc-framed append-only WAL (native LogKV) for the user KV table:
        # every kv_put is appended+flushed before the ack, so it survives a
        # GCS *process* crash; fsync happens at migration/shutdown (or per
        # record with RT_WAL_FSYNC=1), so host-crash/power-loss durability
        # is opt-in. Multi-MB runtime-env packages also stop being
        # re-pickled into each snapshot.
        self._persist_path = persist_path
        self._persist_seq = self._persisted_seq = 0
        self._kv_log = None
        self._kv_log_exec = None
        if persist_path:
            self._restore_snapshot()
            try:
                from concurrent.futures import ThreadPoolExecutor

                from ray_tpu_torch import _native

                import os as _os

                wal_path = persist_path + ".kv"
                # A non-empty WAL is AUTHORITATIVE for kv, including
                # deletions: snapshot-held keys must not be merged over it
                # (a tombstoned key is absent from keys(), so a merge would
                # resurrect durably-deleted data).
                fresh_wal = (not _os.path.exists(wal_path)
                             or _os.path.getsize(wal_path) == 0)
                self._kv_log = _native.LogKV(wal_path)
                if fresh_wal:
                    # one-time migration of pre-WAL snapshot keys, then an
                    # immediate kv={} snapshot so the old copy can't shadow
                    # later WAL deletes
                    for k, v in self.kv.items():
                        self._kv_log.put(k, self._encode_kv(v))
                    self._kv_log.sync()
                else:
                    wal_kv = {k: self._decode_kv(self._kv_log.get(k))
                              for k in self._kv_log.keys()}
                    if self.kv:
                        # A healthy lifecycle persists kv={} snapshots while
                        # the WAL is active, so a NON-empty snapshot kv next
                        # to a non-empty WAL means a previous run couldn't
                        # open the WAL and acked puts into the snapshot
                        # (degraded mode). Overlay those puts back into the
                        # WAL instead of silently discarding them; deletes
                        # acked during the degraded run are unrecoverable
                        # (no tombstone was written) and may resurrect.
                        import logging

                        changed = {k: v for k, v in self.kv.items()
                                   if wal_kv.get(k) != v}
                        for k, v in changed.items():
                            self._kv_log.put(k, self._encode_kv(v))
                        if changed:
                            self._kv_log.sync()
                            logging.getLogger("ray_tpu_torch.gcs").warning(
                                "KV WAL re-opened after a degraded run: "
                                "merged %d snapshot-acked put(s) back into "
                                "the WAL. Deletes acked while the WAL was "
                                "unavailable were not tombstoned and may "
                                "have resurrected.", len(changed))
                        wal_kv.update(changed)
                    self.kv = wal_kv
                # single thread => append order == table order per key
                self._kv_log_exec = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="rt-gcs-kvlog")
                self.mark_dirty()
                self._persist_snapshot()
            except Exception as e:  # noqa: BLE001 — WAL an upgrade, not a dep
                import logging
                import os as _os

                self._kv_log = None
                wal_path = persist_path + ".kv"
                if _os.path.exists(wal_path) and _os.path.getsize(wal_path):
                    # A WAL exists but could not be opened/replayed. Earlier
                    # runs snapshot kv={} once the WAL is authoritative, so
                    # falling back silently would present an EMPTY durable KV
                    # (runtime-env packages, job/function tables) while the
                    # real data still sits in the unreadable file. Run
                    # degraded but say so loudly; the file is left intact for
                    # a later restart to recover.
                    logging.getLogger("ray_tpu_torch.gcs").error(
                        "KV WAL %s exists but failed to open (%s: %s) — "
                        "durable KV from previous runs is NOT loaded this "
                        "run, and new puts are snapshot-only until a restart "
                        "re-opens the WAL.", wal_path, type(e).__name__, e)
                else:
                    logging.getLogger("ray_tpu_torch.gcs").warning(
                        "KV WAL unavailable (%s: %s); falling back to "
                        "snapshot-only KV persistence.", type(e).__name__, e)
            # A restarted head with a persisted chaos plan must RE-ARM its
            # own process (GCS-local sites + its ConnectionPool clients) —
            # otherwise rt chaos status would report armed cluster-wide
            # while the head itself runs dead. Raylets stay armed on their
            # own; the unchanged rev means no re-sync churn.
            raw = self.kv.get(self._CHAOS_KEY)
            if raw:
                try:
                    C.arm(raw.decode() if isinstance(raw, bytes) else raw,
                          rev=max(1, self._chaos_rev))
                    self._chaos_rev = max(1, self._chaos_rev)
                except (ValueError, TypeError):
                    pass

    @staticmethod
    def _encode_kv(value) -> bytes:
        """Type-tagged WAL value: callers pass str OR bytes and must get the
        same type back after a restart."""
        if isinstance(value, str):
            return b"s" + value.encode()
        return b"b" + bytes(value)

    @staticmethod
    def _decode_kv(blob: bytes):
        if blob[:1] == b"s":
            return blob[1:].decode()
        return bytes(blob[1:])

    def mark_dirty(self) -> None:
        self._persist_seq += 1

    # failure_events/_failure_seq are lazily created by _record_failure —
    # snapshot/restore tolerate their absence
    _SNAPSHOT_TABLES = ("kv", "actors", "named_actors", "placement_groups",
                        "object_locations", "object_sizes", "_job_counter",
                        "_chaos_rev", "failure_events", "_failure_seq")

    def _persist_snapshot(self) -> None:
        if not self._persist_path or self._persist_seq == self._persisted_seq:
            return
        seq = self._persist_seq
        self._write_snapshot(self._snapshot_tables())
        self._persisted_seq = seq

    def _write_snapshot(self, state: Dict) -> None:
        import os

        # unique tmp per writer: a stop()-time sync write racing an
        # in-flight executor write must never interleave on one file
        tmp = f"{self._persist_path}.tmp.{os.getpid()}.{id(state)}"
        os.makedirs(os.path.dirname(self._persist_path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, self._persist_path)

    def _snapshot_tables(self) -> Dict:
        """Loop-side copies: shallow for scalar tables, per-value copies for
        mutable containers (location sets mutate mid-pickle otherwise)."""
        state: Dict[str, Any] = {}
        for name in self._SNAPSHOT_TABLES:
            table = getattr(self, name, None)
            if table is None:
                continue  # lazily-created table never materialized
            if name == "kv" and self._kv_log is not None:
                state[name] = {}  # the WAL is the KV's source of truth
            elif name == "object_locations":
                state[name] = {k: set(v) for k, v in table.items()}
            elif name == "failure_events":
                # per-row copies: the dedup path mutates rows in place
                # (count/last_t) and a row changing size mid-pickle on the
                # executor thread would corrupt the snapshot
                state[name] = [dict(e) for e in table]
            elif isinstance(table, dict):
                state[name] = dict(table)
            else:
                state[name] = table
        return state

    def _restore_snapshot(self) -> None:
        import os

        if not os.path.exists(self._persist_path):
            return
        try:
            with open(self._persist_path, "rb") as f:
                state = pickle.load(f)
        except Exception:
            return  # corrupt snapshot: start fresh rather than crash
        for name in self._SNAPSHOT_TABLES:
            if name in state:
                setattr(self, name, state[name])
        if isinstance(self.__dict__.get("failure_events"), list):
            # the feed survives a head restart (a chaos gcs.kill must stay
            # attributable after its own kill): rebuild the bounded deque
            # and reset the dedup index (cross-restart dedup not needed)
            from collections import deque

            self.failure_events = deque(self.failure_events,
                                        maxlen=self._FAILURE_EVENTS_CAP)
            self._failure_last = {}
            self._failure_seq = int(self.__dict__.get("_failure_seq", 0)
                                    or len(self.failure_events))
        # Restored ALIVE actors may still be running (their workers outlive
        # a GCS restart); callers re-resolve addresses on first use. Nodes
        # are NOT restored — raylets re-register with their next heartbeat.

    def start_monitor(self) -> None:
        self._monitor_task = asyncio.ensure_future(self._monitor_loop())

    async def stop(self) -> None:
        from ray_tpu_torch.cluster.rpc import cancel_and_wait

        await cancel_and_wait(self._monitor_task)
        self._monitor_task = None
        try:
            self._persist_snapshot()
        except Exception:
            pass
        if self._kv_log is not None:
            try:
                self._kv_log_exec.shutdown(wait=True)
                self._kv_log.sync()
                self._kv_log.close()
            except Exception:  # noqa: BLE001
                pass
            self._kv_log = None
        await self._pool.close_all()

    # ---- nodes ------------------------------------------------------------
    async def rpc_register_node(self, p):
        entry = _NodeEntry(p["node_id"], p["address"], p["resources"],
                           p.get("labels", {}))
        self.nodes[p["node_id"]] = entry
        return {"ok": True}

    async def rpc_heartbeat(self, p):
        f = C.maybe_fire("gcs.kill")
        if f is not None:
            self._record_failure(C.event_payload("gcs.kill", f))
            import os as _os

            if _os.environ.get("RT_NODE_DAEMON"):
                # standalone head daemon (rt start): die for real — but
                # snapshot FIRST so the injection event survives its own
                # kill (the restarted head replays the feed)
                self.mark_dirty()
                try:
                    self._persist_snapshot()
                except Exception:  # noqa: BLE001 — the kill still happens
                    pass
                asyncio.get_running_loop().call_later(0.1, _os._exit, 137)
            # in-process GCS (driver-hosted / test cluster): exiting would
            # kill the host process — the stamped event records the
            # suppression; tests use Cluster.kill_gcs() instead
        entry = self.nodes.get(p["node_id"])
        if entry is None:
            return {"ok": False, "unknown": True,
                    "chaos_rev": self._chaos_rev,
                    "chaos_armed": self._CHAOS_KEY in self.kv}
        entry.last_heartbeat = time.monotonic()
        resurrected = False
        if not entry.alive:
            # A heartbeat from a "dead" node proves the death was spurious —
            # on a loaded single-core host the shared event loop can stall
            # past node_death_timeout_s (a large pickle, a jit compile)
            # and the monitor then wins the post-stall race against the
            # queued heartbeat. Leaving the node dead wedges every future
            # actor/task placement (pick_node skips dead nodes forever).
            # The reference instead kills the raylet and has it re-register
            # under a new node id (gcs_node_manager.cc); an in-process
            # raylet can't restart, so resurrect it in place. The reply
            # flag tells the raylet to re-publish its object locations
            # (death dropped them from the directory).
            entry.alive = True
            resurrected = True
            self.mark_dirty()
        if "available" in p:
            entry.view.available = ResourceSet(p["available"])
        entry.queued_demands = p.get("queued_demands", [])
        # scheduler queue telemetry: depth of the raylet's pending-task
        # queue rides every heartbeat (feeds rt_raylet_queue_depth and the
        # nodes listing — the number that explains a 255 s probe latency)
        if "queue_depth" in p:
            entry.queue_depth = p["queue_depth"]
        if "sched" in p:
            # scheduling-plane snapshot (per-class depth/wait + warm-pool
            # occupancy/hit-rate): feeds `rt status`, the dashboard Nodes
            # tab and the `rt doctor` per-class starvation finding
            entry.sched = p["sched"]
        # chaos-plan revision + armed flag ride every heartbeat reply:
        # raylets compare against their last-seen rev and (re)fetch
        # @chaos/plan on change — the distribution path that lets
        # `rt chaos` torture a live cluster. The armed flag lets a DISARM
        # propagate without any KV fetch, so even a plan dropping every
        # other rpc stays disarmable.
        return {"ok": True, "resurrected": resurrected,
                "chaos_rev": self._chaos_rev,
                "chaos_armed": self._CHAOS_KEY in self.kv}

    async def rpc_cluster_load(self, p):
        """Autoscaler input: per-node capacity/usage + unplaced demand
        (reference: the load report behind resource_demand_scheduler)."""
        out = []
        for n in self.nodes.values():
            out.append({
                "node_id": n.node_id, "alive": n.alive,
                "labels": dict(n.view.labels),
                "total": n.view.total.to_dict(),
                "available": n.view.available.to_dict(),
                "queued_demands": getattr(n, "queued_demands", []),
            })
        # Unplaced placement-group bundles are cluster-level demand (PGs are
        # scheduled by the GCS, so they never sit in any raylet's queue);
        # ride them on a synthetic zero-capacity entry so the autoscaler
        # bin-packs gang reservations too — a pending slice_group() is
        # exactly what should provision a multi-host gang (reference:
        # resource_demand_scheduler handles pending PGs the same way).
        pending = []
        for pg in self.placement_groups.values():
            if pg.state == PG_PENDING:
                for i, b in enumerate(pg.bundles):
                    if pg.bundle_nodes[i] is None:
                        d = {"resources": dict(b), "count": 1}
                        # STRICT_SPREAD bundles can never share a node —
                        # the autoscaler's bin-pack must know (else a gang
                        # that numerically fits one node never provisions).
                        if pg.strategy == "STRICT_SPREAD":
                            d["strict_spread_group"] = pg.pg_id
                        pending.append(d)
        if pending:
            out.append({
                "node_id": "@pending_pg_bundles", "alive": True,
                "labels": {}, "total": {}, "available": {},
                "queued_demands": pending[:100],
            })
        return out

    async def rpc_list_nodes(self, p):
        return [{
            "node_id": n.node_id, "address": n.address, "alive": n.alive,
            "resources": n.view.total.to_dict(),
            "available": n.view.available.to_dict(),
            "labels": dict(n.view.labels),
            "queue_depth": getattr(n, "queue_depth", 0),
            "sched": getattr(n, "sched", None),
            # dead rows persist for the cluster's lifetime: when + why the
            # node died lets `rt doctor` window its findings instead of
            # flagging a drain from hours ago as critical forever
            "death_t": getattr(n, "death_t", None),
            "death_reason": getattr(n, "death_reason", ""),
        } for n in self.nodes.values()]

    async def rpc_drain_node(self, p):
        entry = self.nodes.get(p["node_id"])
        if entry:
            await self._mark_node_dead(entry, "drained")
        return {"ok": True}

    async def _monitor_loop(self) -> None:
        cfg = get_config()
        started = time.monotonic()
        while True:
            await asyncio.sleep(cfg.heartbeat_interval_s)
            now = time.monotonic()
            for entry in list(self.nodes.values()):
                if entry.alive and now - entry.last_heartbeat > cfg.node_death_timeout_s:
                    await self._mark_node_dead(entry, "heartbeat timeout")
            try:
                # per-tick cross-node balance sample: feeds the
                # rt_sched_node_imbalance gauge, `rt sched balance` and the
                # doctor's sustained-imbalance grading
                self._update_balance()
            except Exception:  # noqa: BLE001 — telemetry only
                pass
            # Restored-ALIVE actors whose node never (re-)registered: after a
            # grace window for surviving raylets to reattach (they re-register
            # under their old node id on an "unknown" heartbeat reply), the
            # worker is provably gone — run the normal failure path so the
            # restart budget can recreate the actor (reference: GCS FT
            # reconciliation of the actor table after restart).
            if now - started > cfg.node_death_timeout_s:
                for actor in list(self.actors.values()):
                    if (actor.state in (ACTOR_ALIVE,)
                            and actor.node_id is not None
                            and actor.node_id not in self.nodes):
                        await self._handle_actor_failure(
                            actor, F.cause_dict(
                                F.NODE_DEATH,
                                "node never re-registered after GCS "
                                "restart", node_id=actor.node_id))
            try:
                # pickle+write runs OFF the loop: a large table snapshot
                # must not stall heartbeat handling (and spuriously kill
                # nodes). Copies are taken on the loop; IO in the executor.
                if (self._persist_path
                        and self._persist_seq != self._persisted_seq):
                    seq = self._persist_seq
                    state = self._snapshot_tables()
                    await asyncio.get_running_loop().run_in_executor(
                        None, self._write_snapshot, state)
                    self._persisted_seq = seq
            except Exception:
                pass

    async def _mark_node_dead(self, entry: _NodeEntry, reason: str) -> None:
        self.mark_dirty()  # internal transitions must persist too
        entry.alive = False
        entry.death_t = time.time()
        entry.death_reason = reason
        self._record_failure({
            "category": F.NODE_DEATH, "message": f"node died: {reason}",
            "node_id": entry.node_id, "address": entry.address})
        # Objects whose only copy was there are lost (lineage reconstruction
        # is later work); actors there restart elsewhere if budgeted.
        for oid, locs in list(self.object_locations.items()):
            locs.discard(entry.node_id)
        for actor in list(self.actors.values()):
            if actor.node_id == entry.node_id and actor.state in (
                    ACTOR_ALIVE, ACTOR_PENDING, ACTOR_RESTARTING):
                await self._handle_actor_failure(actor, F.cause_dict(
                    F.NODE_DEATH, f"node died: {reason}",
                    node_id=entry.node_id))
        # Reschedule ONLY the lost bundles of affected placement groups
        # (reference: GcsPlacementGroupManager PG rescheduling on node death).
        # Surviving bundles keep their reservations — actors/tasks inside
        # them are still running and hold GPUs from those reservations.
        # PENDING groups are cleared too (a second death mid-reschedule must
        # not leave the dead node's id pinned in bundle_nodes); their
        # already-running _schedule_pg loop replans the now-missing slots.
        for pg in self.placement_groups.values():
            if pg.state == PG_REMOVED or entry.node_id not in pg.bundle_nodes:
                continue
            was_created = pg.state == PG_CREATED
            pg.bundle_nodes = [None if nid == entry.node_id else nid
                               for nid in pg.bundle_nodes]
            if was_created:
                pg.state = PG_PENDING
                spawn_task(self._schedule_pg(pg))

    # ---- chaos plane (util/chaos.py) ---------------------------------------
    # The GCS is the plan's distribution point: arm stores the plan in the
    # KV (@chaos/plan) and bumps a revision that rides every heartbeat
    # reply; raylets fetch + arm on rev change and forward to their workers.

    _CHAOS_KEY = "@chaos/plan"

    async def rpc_chaos_arm(self, p):
        try:
            plan = C.ChaosPlan.from_value(p.get("plan"))
        except (ValueError, TypeError) as e:
            return {"error": str(e)}
        self._chaos_rev = self._chaos_rev + 1
        # fresh nonce per EXPLICIT arm: re-running the same plan repeats
        # the experiment (counters reset everywhere), while re-announces
        # of this stored copy (head restart, worker forwards) keep the
        # nonce and stay idempotent
        plan.nonce = self._chaos_rev
        await self.rpc_kv_put({"key": self._CHAOS_KEY,
                               "value": plan.to_json()})
        # arm this process too (gcs.kill / rpc.* sites in the GCS's own
        # clients; in-process clusters share the process with everything)
        C.arm(plan, rev=self._chaos_rev)
        return {"ok": True, "rev": self._chaos_rev,
                "plan": plan.to_dict()}

    async def rpc_chaos_disarm(self, p):
        await self.rpc_kv_del({"key": self._CHAOS_KEY})
        self._chaos_rev = self._chaos_rev + 1
        C.disarm()
        return {"ok": True, "rev": self._chaos_rev}

    async def rpc_chaos_status(self, p):
        raw = self.kv.get(self._CHAOS_KEY)
        plan = None
        if raw:
            try:
                plan = C.ChaosPlan.from_value(
                    raw.decode() if isinstance(raw, bytes) else raw).to_dict()
            except (ValueError, TypeError):
                plan = None
        return {"armed": plan is not None,
                "rev": self._chaos_rev, "plan": plan,
                "local": C.status()}

    # ---- kv / function table ----------------------------------------------
    async def rpc_kv_put(self, p):
        self.mark_dirty()
        self.kv[p["key"]] = p["value"]
        if self._kv_log is not None:
            # WAL append off-loop (native side releases the GIL during the
            # write); the single-thread executor keeps append order == the
            # order the table saw
            await asyncio.get_running_loop().run_in_executor(
                self._kv_log_exec, self._kv_put_durable, p["key"],
                self._encode_kv(p["value"]))
        return {"ok": True}

    def _kv_put_durable(self, key: str, value: bytes) -> None:
        """Runs on the WAL executor thread: append, and fsync when the
        operator asked for host-crash durability (RT_WAL_FSYNC=1)."""
        from ray_tpu_torch._private.config import get_config

        self._kv_log.put(key, value)
        if get_config().wal_fsync:
            self._kv_log.sync()

    async def rpc_kv_get(self, p):
        return {"value": self.kv.get(p["key"])}

    async def rpc_kv_del(self, p):
        self.mark_dirty()
        self.kv.pop(p["key"], None)
        if self._kv_log is not None:
            await asyncio.get_running_loop().run_in_executor(
                self._kv_log_exec, self._kv_del_durable, p["key"])
        return {"ok": True}

    def _kv_del_durable(self, key: str) -> None:
        """WAL-executor thread: tombstone, honoring RT_WAL_FSYNC like puts —
        an un-fsynced acked delete resurrecting after a host crash breaks
        the same durability promise as a lost put."""
        from ray_tpu_torch._private.config import get_config

        self._kv_log.delete(key)
        if get_config().wal_fsync:
            self._kv_log.sync()

    async def rpc_kv_keys(self, p):
        return {"keys": [k for k in self.kv if k.startswith(p["prefix"])]}

    # ---- object directory --------------------------------------------------
    async def rpc_add_object_location(self, p):
        self.mark_dirty()
        oid, node_id = p["oid"], p["node_id"]
        self.object_locations.setdefault(oid, set()).add(node_id)
        if "size" in p:
            self.object_sizes[oid] = p["size"]
        for fut in self._location_waiters.pop(oid, []):
            if not fut.done():
                fut.set_result(True)
        return {"ok": True}

    async def rpc_remove_object_location(self, p):
        self.mark_dirty()
        locs = self.object_locations.get(p["oid"])
        if locs:
            locs.discard(p["node_id"])
        return {"ok": True}

    async def rpc_get_object_locations(self, p):
        oid = p["oid"]
        timeout = p.get("timeout")
        locs = self.object_locations.get(oid)
        if not locs and p.get("wait"):
            fut = asyncio.get_running_loop().create_future()
            self._location_waiters.setdefault(oid, []).append(fut)
            try:
                await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                pass
            locs = self.object_locations.get(oid)
        alive = [n for n in (locs or ()) if self.nodes.get(n) and self.nodes[n].alive]
        return {
            "locations": [{"node_id": n, "address": self.nodes[n].address}
                          for n in alive],
            "size": self.object_sizes.get(oid),
        }

    # ---- actors ------------------------------------------------------------
    async def rpc_register_actor(self, p):
        self.mark_dirty()
        spec = p["spec"]
        actor_id = spec["actor_id"]
        name, ns = spec.get("name"), spec.get("namespace", "default")
        if name is not None:
            existing = self.named_actors.get((ns, name))
            if existing is not None:
                if spec.get("get_if_exists"):
                    return {"actor_id": existing, "existing": True,
                            "info": self.actors[existing].info(),
                            "method_meta": self.actors[existing].spec.get("method_meta")}
                return {"error": f"actor name {name!r} taken in namespace {ns!r}"}
        entry = _ActorEntry(actor_id, spec)
        self.actors[actor_id] = entry
        if name is not None:
            self.named_actors[(ns, name)] = actor_id
        spawn_task(self._schedule_actor(entry))
        return {"actor_id": actor_id, "existing": False}

    async def _schedule_actor(self, entry: _ActorEntry,
                              backoff: float = 0.0) -> None:
        if backoff:
            await asyncio.sleep(backoff)
        req = ResourceSet(entry.spec.get("resources", {}))
        strategy = entry.spec.get("scheduling_strategy")
        pg_info = entry.spec.get("pg")
        deadline = time.monotonic() + 3600.0
        while time.monotonic() < deadline:
            if entry.state == ACTOR_DEAD:
                return  # killed while pending/restarting
            if pg_info is not None:
                node_id = await self._pg_bundle_node(pg_info, entry)
                if node_id is None:
                    if entry.state == ACTOR_DEAD:
                        return
                    await asyncio.sleep(0.2)
                    continue
            else:
                views = {nid: n.view for nid, n in self.nodes.items() if n.alive}
                node_id = pick_node(strategy, views, req)
            if node_id is None:
                await asyncio.sleep(0.2)  # infeasible now; wait for nodes
                continue
            node = self.nodes[node_id]
            # placement receipt: which candidates were considered and why
            # this node won (bundle pin for PG actors, strategy pick
            # otherwise). Create-side failures retry through this loop and
            # restamp; the store's dedup folds the repeats.
            self._record_placement({
                "kind": "actor_place",
                "actor_id": entry.actor_id,
                "name": entry.spec.get("class_name"),
                "node_id": node_id,
                "reason": ("pg_bundle" if pg_info is not None
                           else _strategy_kind(strategy)),
                "candidates": [self._node_features(nid) for nid in (
                    [node_id] if pg_info is not None else list(views)[:8])],
            })
            try:
                client = await self._pool.get(node.address)
                # Bounded: a wedged raylet must fail over to another node,
                # not pin this actor PENDING_CREATION forever (the raylet's
                # own create path is bounded by process_startup_timeout_s).
                cfg = get_config()
                create_timeout = (cfg.process_startup_timeout_s
                                  + (cfg.runtime_env_setup_timeout_s
                                     if entry.spec.get("runtime_env") else 0)
                                  + 30.0)
                restarts_before = entry.num_restarts
                reply = await client.call("create_actor", {
                    "actor_id": entry.actor_id, "spec": entry.spec},
                    timeout=create_timeout)
                if entry.state == ACTOR_DEAD:
                    # Killed during creation: reap the just-created worker.
                    if reply.get("ok"):
                        await client.call("kill_actor",
                                          {"actor_id": entry.actor_id})
                    return
                if reply.get("ok"):
                    # Don't clobber node_id once an ALIVE report landed — if
                    # a timed-out earlier attempt won the ALIVE race, THIS
                    # copy is the stale one (rpc_actor_update already killed
                    # it) and node_id must keep pointing at the winner.
                    if entry.state != ACTOR_ALIVE:
                        entry.node_id = node_id
                    return  # raylet reports actor_update(ALIVE) when ready
                if reply.get("retry"):
                    await asyncio.sleep(0.2)
                    continue
                if (entry.state == ACTOR_DEAD
                        or entry.num_restarts != restarts_before):
                    # the raylet reported this same death via actor_update
                    # BEFORE replying and _handle_actor_failure already
                    # scheduled a restart (num_restarts moved) or finalized
                    # — finalizing here would burn the restart budget the
                    # GCS just honored. A reply with NO matching
                    # actor_update (raylet spawn failure / startup timeout:
                    # its generic except path never updates) falls through,
                    # so the actor still dies loudly instead of wedging in
                    # RESTARTING forever.
                    return
                await self._finalize_actor_death(
                    entry, reply.get("cause") or F.cause_dict(
                        F.WORKER_CRASH,
                        reply.get("error", "creation failed"),
                        node_id=node_id))
                return
            except Exception:  # node unreachable or create timed out
                # If the create was merely SLOW (not dead), its worker may
                # still come up after we re-place the actor elsewhere —
                # best-effort kill so two live copies can never coexist
                # (rpc_actor_update's stale-ALIVE guard is the backstop).
                spawn_task(self._kill_stale_creation(node.address,
                                                     entry.actor_id))
                self._pool.invalidate(node.address)
                await asyncio.sleep(0.2)
        await self._finalize_actor_death(entry, F.cause_dict(
            F.SCHEDULING_TIMEOUT, "scheduling timed out"))

    async def _kill_stale_creation(self, address: str, actor_id: str) -> None:
        try:
            client = await self._pool.get(address)
            await client.call("kill_actor", {"actor_id": actor_id},
                              timeout=10)
        except Exception:  # noqa: BLE001 — node really is gone
            pass

    async def _pg_bundle_node(self, pg_info: Dict, entry: _ActorEntry
                              ) -> Optional[str]:
        """Resolve (and fix) the bundle an actor lands in; None = not ready."""
        pg = self.placement_groups.get(pg_info["pg_id"])
        if pg is None or pg.state == PG_REMOVED:
            await self._finalize_actor_death(entry, F.cause_dict(
                F.PG_REMOVED, "placement group removed",
                pg_id=pg_info.get("pg_id")))
            return None
        if pg.state != PG_CREATED:
            return None
        idx = pg_info.get("bundle_index", -1)
        if idx < 0:
            idx = pg._rr % len(pg.bundles)
            pg._rr += 1
            pg_info["bundle_index"] = idx  # pin for restarts
        entry.spec["pg"] = pg_info
        return pg.bundle_nodes[idx]

    async def rpc_actor_update(self, p):
        self.mark_dirty()
        entry = self.actors.get(p["actor_id"])
        if entry is None:
            return {"ok": False}
        state = p["state"]
        if state == ACTOR_ALIVE:
            stale_alive = (
                entry.state == ACTOR_DEAD
                # A second copy finishing creation after the scheduler timed
                # out and placed the actor elsewhere: the FIRST ALIVE wins,
                # the loser's worker is reaped (never two live copies).
                or (entry.state == ACTOR_ALIVE and entry.node_id is not None
                    and p.get("node_id") not in (None, entry.node_id)))
            if stale_alive:
                node = self.nodes.get(p.get("node_id", ""))
                if node is not None:
                    try:
                        client = await self._pool.get(node.address)
                        await client.call("kill_actor",
                                          {"actor_id": entry.actor_id})
                    except Exception:
                        pass
                return {"ok": True, "stale": True}
            entry.state = ACTOR_ALIVE
            entry.address = p.get("address")
            entry.node_id = p.get("node_id", entry.node_id)
            self._wake_actor_waiters(entry)
        elif state == ACTOR_DEAD:
            # Ignore death reports from a node that no longer owns the actor
            # (e.g. a resurrected node reaping its orphaned pre-death copy —
            # the restarted copy elsewhere is alive and well).
            reporter = p.get("node_id")
            if (reporter is not None and entry.node_id is not None
                    and reporter != entry.node_id):
                return {"ok": True, "stale": True}
            await self._handle_actor_failure(
                entry, p.get("cause") or F.cause_dict(
                    F.WORKER_CRASH, p.get("reason", "worker died"),
                    node_id=reporter))
        return {"ok": True}

    async def rpc_actor_unreachable(self, p):
        """A caller failed to CONNECT to an ALIVE actor's address. Verify
        before acting (the caller may just have a stale cache): if the
        actor's node is gone or dead, run the normal failure path so the
        restart budget applies — the fast lane for post-GCS-restart
        recovery, ahead of the monitor's grace window."""
        entry = self.actors.get(p["actor_id"])
        if (entry is None or entry.state != ACTOR_ALIVE
                or entry.address != p.get("address")):
            return {"ok": False}
        node = self.nodes.get(entry.node_id or "")
        if node is not None and node.alive:
            return {"ok": False}  # node looks fine; caller should retry
        await self._handle_actor_failure(entry, F.cause_dict(
            F.NODE_DEATH, "reported unreachable and its node is gone",
            node_id=entry.node_id))
        return {"ok": True}

    def _observe_actor_restart(self) -> None:
        """``rt_actor_restarts_total``: restarts the GCS scheduled after an
        actor worker died with budget left. Registry-local; shipped by the
        co-resident pusher (driver, or the head raylet's)."""
        try:
            from ray_tpu_torch.util import metrics as M

            if not hasattr(self, "_restart_counter"):
                self._restart_counter = M.get_or_create(
                    M.Counter, "rt_actor_restarts_total",
                    "Actor restarts scheduled by the GCS after a failure")
            self._restart_counter.inc()
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    async def _handle_actor_failure(self, entry: _ActorEntry, reason) -> None:
        """``reason`` is a ``failure.py`` cause dict (legacy strings are
        coerced). With restart budget left the actor restarts and the
        failure is recorded with the underlying category; an exhausted
        budget re-categorizes the terminal event as restart-exhausted."""
        self.mark_dirty()
        if entry.state == ACTOR_DEAD:
            return
        cause = F.FailureCause.from_value(reason)
        max_restarts = entry.spec.get("max_restarts", 0)
        if entry.spec.get("_explicit_kill"):
            max_restarts = 0
        if max_restarts == -1 or entry.num_restarts < max_restarts:
            entry.num_restarts += 1
            entry.state = ACTOR_RESTARTING
            entry.address = None
            self._observe_actor_restart()
            self._record_failure({
                "category": cause.category, "message": str(cause),
                "actor_id": entry.actor_id,
                "name": entry.spec.get("class_name"),
                "node_id": cause.context.get("node_id", entry.node_id),
                "restarting": True, "num_restarts": entry.num_restarts})
            # Restart-storm damping: CONSECUTIVE restarts back off
            # exponentially (capped, jittered) instead of re-dispatching a
            # crash loop at a fixed 0.5s cadence. The streak — not the
            # lifetime num_restarts — keys the exponent, and it resets
            # once the actor stayed healthy past the cap: an isolated
            # failure of a long-lived actor recovers at base speed.
            # Recorded on the entry so `rt list actors` / tests see it.
            cfg = get_config()
            now = time.monotonic()
            if (now - getattr(entry, "last_failure_t", -1e9)
                    > cfg.actor_restart_backoff_max_s):
                entry.restart_streak = 0
            entry.restart_streak = getattr(entry, "restart_streak", 0) + 1
            entry.last_failure_t = now
            backoff = F.backoff_with_jitter(
                entry.restart_streak, cfg.actor_restart_backoff_s,
                cfg.actor_restart_backoff_max_s)
            entry.last_restart_backoff_s = backoff
            # Backoff happens inside the spawned task — this path runs on the
            # monitor loop and must not stall node-death handling.
            spawn_task(self._schedule_actor(entry, backoff=backoff))
        else:
            if entry.num_restarts >= max_restarts > 0:
                # the budget existed and is spent: the terminal cause is
                # the exhaustion itself; the last underlying cause rides
                # the message
                cause = F.FailureCause(
                    F.ACTOR_RESTART_EXHAUSTED,
                    f"out of restarts ({entry.num_restarts}/"
                    f"{max_restarts}); last failure: {cause}",
                    **cause.context)
            await self._finalize_actor_death(entry, cause)

    async def _finalize_actor_death(self, entry: _ActorEntry, reason) -> None:
        cause = F.FailureCause.from_value(reason)
        entry.state = ACTOR_DEAD
        entry.death_reason = str(cause)
        entry.death_cause = dict(
            cause.to_dict(), actor_id=entry.actor_id,
            num_restarts=entry.num_restarts,
            node_id=cause.context.get("node_id", entry.node_id),
            t=time.time())  # recency: rt doctor windows actor findings
        self._record_failure(dict(
            entry.death_cause, name=entry.spec.get("class_name")))
        name, ns = entry.spec.get("name"), entry.spec.get("namespace", "default")
        if name is not None and self.named_actors.get((ns, name)) == entry.actor_id:
            del self.named_actors[(ns, name)]
        self._wake_actor_waiters(entry)

    def _wake_actor_waiters(self, entry: _ActorEntry) -> None:
        for fut in entry.waiters:
            if not fut.done():
                fut.set_result(True)
        entry.waiters.clear()

    async def rpc_get_actor_info(self, p):
        entry = self.actors.get(p["actor_id"])
        if entry is None:
            return {"error": "unknown actor"}
        if p.get("wait_alive"):
            deadline = time.monotonic() + p.get("timeout", 60.0)
            while entry.state in (ACTOR_PENDING, ACTOR_RESTARTING):
                fut = asyncio.get_running_loop().create_future()
                entry.waiters.append(fut)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    await asyncio.wait_for(fut, remaining)
                except asyncio.TimeoutError:
                    break
        return {"info": entry.info(),
                "method_meta": entry.spec.get("method_meta")}

    async def rpc_get_named_actor(self, p):
        actor_id = self.named_actors.get((p.get("namespace", "default"), p["name"]))
        if actor_id is None:
            return {"error": f"no actor named {p['name']!r}"}
        entry = self.actors[actor_id]
        return {"actor_id": actor_id, "info": entry.info(),
                "method_meta": entry.spec.get("method_meta")}

    async def rpc_kill_actor(self, p):
        self.mark_dirty()
        entry = self.actors.get(p["actor_id"])
        if entry is None:
            return {"ok": False}
        entry.spec["_explicit_kill"] = True
        if entry.address and entry.node_id:
            node = self.nodes.get(entry.node_id)
            if node:
                try:
                    client = await self._pool.get(node.address)
                    await client.call("kill_actor", {"actor_id": entry.actor_id})
                except Exception:
                    pass
        await self._finalize_actor_death(entry, F.cause_dict(
            F.CANCELLED, "killed via kill()"))
        return {"ok": True}

    async def rpc_list_actors(self, p):
        return [a.info() for a in self.actors.values()]

    # ---- placement groups ---------------------------------------------------
    async def rpc_create_placement_group(self, p):
        self.mark_dirty()
        entry = _PgEntry(p["pg_id"], p["bundles"], p["strategy"],
                         p.get("name", ""))
        self.placement_groups[p["pg_id"]] = entry
        spawn_task(self._schedule_pg(entry))
        return {"ok": True}

    def _pg_plan(self, entry: _PgEntry) -> Optional[Dict[int, str]]:
        """Pick a node for every UNPLACED bundle under the strategy, against a
        scratch copy of the availability view (so multi-bundle fits are
        accounted). Already-placed bundles (partial reschedule after node
        death) constrain the plan but are not re-placed."""
        import copy

        views = {nid: copy.deepcopy(n.view) for nid, n in self.nodes.items()
                 if n.alive}
        reqs = [ResourceSet(b) for b in entry.bundles]
        missing = [i for i, nid in enumerate(entry.bundle_nodes) if nid is None]
        used_nodes: Set[str] = {nid for nid in entry.bundle_nodes if nid}
        plan: Dict[int, str] = {}
        if entry.strategy == "STRICT_PACK":
            total = ResourceSet()
            for i in missing:
                total = total.add(reqs[i])
            placed = next((n for n in entry.bundle_nodes if n), None)
            candidates = ([placed] if placed else list(views.keys()))
            for nid in candidates:
                if nid in views and views[nid].can_fit(total):
                    return {i: nid for i in missing}
            return None
        for i in missing:
            req = reqs[i]
            candidates = list(views.items())
            if entry.strategy in ("SPREAD", "STRICT_SPREAD"):
                fresh = [(nid, v) for nid, v in candidates if nid not in used_nodes]
                if entry.strategy == "STRICT_SPREAD":
                    candidates = fresh
                elif fresh:
                    candidates = fresh + [(n, v) for n, v in candidates
                                          if n in used_nodes]
            elif entry.strategy == "PACK" and used_nodes:
                candidates.sort(key=lambda kv: kv[0] not in used_nodes)
            chosen = None
            for nid, view in candidates:
                if view.can_fit(req):
                    chosen = nid
                    break
            if chosen is None:
                return None
            views[chosen].allocate(req)
            used_nodes.add(chosen)
            plan[i] = chosen
        return plan

    async def _schedule_pg(self, entry: _PgEntry) -> None:
        """2-phase commit: prepare every (missing) bundle, then commit all —
        atomic gang reservation (reference: prepare-all/commit-all in
        ``gcs_placement_group_scheduler.cc``)."""
        while entry.state == PG_PENDING:
            plan = self._pg_plan(entry)
            if plan is None:
                await asyncio.sleep(0.2)
                continue
            # `prepared` tracks every bundle a prepare RPC was *sent* for —
            # a lost reply may still have reserved resources on the raylet,
            # so the unwind must release those too (release is idempotent).
            prepared: List[Tuple[int, str]] = []
            confirmed: List[Tuple[int, str]] = []
            ok = True
            for i, nid in plan.items():
                try:
                    client = await self._pool.get(self.nodes[nid].address)
                    prepared.append((i, nid))
                    reply = await client.call("prepare_bundle", {
                        "pg_id": entry.pg_id, "bundle_index": i,
                        "resources": entry.bundles[i]})
                    if reply.get("ok"):
                        confirmed.append((i, nid))
                    else:
                        ok = False
                        break
                except Exception:
                    ok = False
                    break
            committed: List[Tuple[int, str]] = []
            if ok and entry.state == PG_PENDING:
                for i, nid in confirmed:
                    try:
                        client = await self._pool.get(self.nodes[nid].address)
                        await client.call("commit_bundle", {
                            "pg_id": entry.pg_id, "bundle_index": i})
                        committed.append((i, nid))
                    except Exception:
                        ok = False  # node died mid-commit: unwind and retry
                        break
            if not ok or entry.state != PG_PENDING:
                for i, nid in prepared:
                    try:
                        client = await self._pool.get(self.nodes[nid].address)
                        await client.call("release_bundle", {
                            "pg_id": entry.pg_id, "bundle_index": i})
                    except Exception:
                        pass
                if entry.state != PG_PENDING:
                    return
                await asyncio.sleep(0.2)
                continue
            for i, nid in committed:
                entry.bundle_nodes[i] = nid
            # Re-check liveness AFTER recording placements: a node that died
            # while this loop was committing other bundles was invisible to
            # the death handler (its slot wasn't in bundle_nodes yet), so
            # null those slots here and let the replan below pick them up.
            for i, nid in committed:
                node = self.nodes.get(nid)
                if node is None or not node.alive:
                    entry.bundle_nodes[i] = None
            if any(nid is None for nid in entry.bundle_nodes):
                # A node holding an already-placed bundle died while this
                # iteration was preparing/committing (the death handler nulls
                # the slot but spawns no new loop for PENDING groups) —
                # replan the now-missing slots before declaring CREATED.
                await asyncio.sleep(0.2)
                continue
            entry.state = PG_CREATED
            self.mark_dirty()
            # placement receipt: one record per gang commit — gang_place
            # for multi-bundle groups (the slice_group case), pg_place
            # for a single reserved bundle — with the committed
            # bundle→node map as the decision payload
            self._record_placement({
                "kind": ("gang_place" if len(entry.bundles) > 1
                         else "pg_place"),
                "pg_id": entry.pg_id,
                "name": entry.name,
                "node_id": next((n for n in entry.bundle_nodes if n), None),
                "reason": str(entry.strategy or "PACK").lower(),
                "bundle_nodes": list(entry.bundle_nodes),
                "candidates": [self._node_features(nid) for nid in
                               dict.fromkeys(n for n in entry.bundle_nodes
                                             if n)],
            })
            for fut in entry.waiters:
                if not fut.done():
                    fut.set_result(True)
            entry.waiters.clear()
            return

    async def rpc_wait_placement_group(self, p):
        entry = self.placement_groups.get(p["pg_id"])
        if entry is None:
            return {"error": "unknown placement group"}
        deadline = time.monotonic() + p.get("timeout", 3600.0)
        while entry.state == PG_PENDING and time.monotonic() < deadline:
            fut = asyncio.get_running_loop().create_future()
            entry.waiters.append(fut)
            try:
                await asyncio.wait_for(fut, deadline - time.monotonic())
            except asyncio.TimeoutError:
                break
        return {"state": entry.state}

    async def rpc_get_placement_group(self, p):
        entry = self.placement_groups.get(p["pg_id"])
        if entry is None:
            return {"error": "unknown placement group"}
        info = entry.info()
        if p.get("pick_bundle") and entry.state == PG_CREATED:
            idx = p.get("bundle_index", -1)
            if idx < 0:
                idx = entry._rr % len(entry.bundles)
                entry._rr += 1
            nid = entry.bundle_nodes[idx]
            info["picked_bundle"] = idx
            info["picked_address"] = (self.nodes[nid].address
                                      if nid in self.nodes else None)
        return info

    async def rpc_remove_placement_group(self, p):
        self.mark_dirty()
        entry = self.placement_groups.get(p["pg_id"])
        if entry is None:
            return {"ok": False}
        entry.state = PG_REMOVED
        for fut in entry.waiters:
            if not fut.done():
                fut.set_result(True)
        entry.waiters.clear()
        # Kill actors living in this PG's bundles BEFORE the bundle resources
        # (and GPU assignments) are returned to the nodes — otherwise the
        # next scheduled task shares GPUs with a still-running actor
        # (reference: PG removal destroys all actors/tasks in the group).
        for actor in list(self.actors.values()):
            actor_pg = (actor.spec or {}).get("pg") or {}
            if actor_pg.get("pg_id") != entry.pg_id:
                continue
            if actor.state not in (ACTOR_ALIVE, ACTOR_PENDING, ACTOR_RESTARTING):
                continue
            actor.spec["_explicit_kill"] = True
            if actor.node_id and actor.node_id in self.nodes:
                try:
                    client = await self._pool.get(
                        self.nodes[actor.node_id].address)
                    await client.call("kill_actor", {"actor_id": actor.actor_id})
                except Exception:
                    pass
            await self._finalize_actor_death(actor, F.cause_dict(
                F.PG_REMOVED, "placement group removed",
                pg_id=entry.pg_id))
        for i, nid in enumerate(entry.bundle_nodes):
            if nid is None or nid not in self.nodes:
                continue
            try:
                client = await self._pool.get(self.nodes[nid].address)
                await client.call("release_bundle", {
                    "pg_id": entry.pg_id, "bundle_index": i})
            except Exception:
                pass
        return {"ok": True}

    async def rpc_list_placement_groups(self, p):
        return [e.info() for e in self.placement_groups.values()]

    # ---- task routing (spillback target selection) -------------------------
    # ---- task events (reference: GcsTaskManager, gcs_task_manager.h:61 —
    # a bounded in-memory event store behind the State API) -----------------
    _TASK_EVENTS_CAP = 10000
    _STEP_EVENTS_CAP = 4096
    _SERVE_EVENTS_CAP = 4096
    _RECORDER_EVENTS_CAP = 4096

    #: payload keys of flight-recorder events (engine ticks/requests,
    #: rlhf pipeline iterations) — opaque to the GCS, rendered into
    #: timeline lanes client-side (util/timeline.py)
    _RECORDER_KEYS = ("engine_tick", "engine_request", "rlhf_iter")

    async def rpc_task_event(self, p):
        self._apply_task_event(p)
        return {"ok": True}

    async def rpc_task_events(self, p):
        """Batched form: the step profiler drains its whole ring in ONE
        call instead of a round-trip per record."""
        for ev in p.get("events") or ():
            self._apply_task_event(ev)
        return {"ok": True, "count": len(p.get("events") or ())}

    def _apply_task_event(self, p):
        if p.get("placement") is not None:
            # placement receipts ride the coalesced task_events channel
            # (one batched drain, no second RPC path) but land in their own
            # bounded deduping store — a dispatch flood must never evict
            # real task history
            self._record_placement(p["placement"])
            return
        if not hasattr(self, "task_events"):
            from collections import OrderedDict

            self.task_events: "OrderedDict[str, Dict]" = OrderedDict()
            # step-profiler records get their OWN bounded store: a streamed
            # profile run emits a record per token, and sharing the task
            # FIFO would evict the real task history
            self.step_events: "OrderedDict[str, Dict]" = OrderedDict()
            # serve request spans likewise (serve/obs.py): heavy traffic
            # emits several spans per request and must not crowd out tasks
            self.serve_events: "OrderedDict[str, Dict]" = OrderedDict()
            # flight-recorder events (engine ticks/requests, rlhf
            # iterations) likewise: a busy engine drains up to 256 ticks
            # per cadence and would flush the real task history
            self.recorder_events: "OrderedDict[str, Dict]" = OrderedDict()
        is_step = p.get("profile") is not None
        is_serve = str(p.get("task_id", "")).startswith("serve:")
        is_recorder = any(p.get(k) is not None for k in self._RECORDER_KEYS)
        if is_step:
            store, cap = self.step_events, self._STEP_EVENTS_CAP
        elif is_recorder:
            store, cap = self.recorder_events, self._RECORDER_EVENTS_CAP
        elif is_serve:
            store, cap = self.serve_events, self._SERVE_EVENTS_CAP
        else:
            store, cap = self.task_events, self._TASK_EVENTS_CAP
        ev = store.pop(p["task_id"], None)
        if ev is None and p.get("state") is None:
            # a phases-only partial for a task the FIFO already evicted:
            # don't resurrect a skeleton row (and evict a live event)
            return
        ev = ev or {}
        # Partial merges (a driver's phases-only update) omit state/node_id
        # and must not clobber what the raylet recorded — a FAILED task
        # stays FAILED and keeps its node.
        ev.update({"task_id": p["task_id"], "name": p.get("name", ev.get("name")),
                   "state": p.get("state", ev.get("state")),
                   "node_id": p.get("node_id", ev.get("node_id")),
                   "updated_at": time.time()})
        if p.get("trace") is not None:
            ev["trace"] = p["trace"]
        # per-phase latency breakdown: the raylet, the executing worker and
        # the driver each report the phases they own; the union accumulates
        # on the one event (tracing.PHASE_ORDER documents the partition)
        if p.get("phases"):
            ev.setdefault("phases", {}).update(p["phases"])
        if p.get("worker_source") is not None:
            ev["worker_source"] = p["worker_source"]
        # spillback hop chain (from-node → to-node → reason) joins the
        # task's trace: `rt trace` renders it on the spillback phase row.
        # Bounded — spillback_max_hops caps real chains far below this.
        if p.get("spill_hop"):
            hops = ev.setdefault("spill_hops", [])
            if len(hops) < 8:
                hops.append(p["spill_hop"])
        # step-profiler records ride the same store: a breakdown payload
        # plus caller-supplied span times (the profiler measured the real
        # start/end; server receive-time would misplace the lane)
        if p.get("profile") is not None:
            ev["profile"] = p["profile"]
        for key in self._RECORDER_KEYS:
            if p.get(key) is not None:
                ev[key] = p[key]
        # per-state transition times feed ray_tpu_torch.timeline()'s Chrome trace
        if p.get("times"):
            ev.setdefault("times", {}).update(p["times"])
        elif p.get("state"):
            ev.setdefault("times", {})[p["state"]] = time.time()
        store[p["task_id"]] = ev
        while len(store) > cap:
            store.popitem(last=False)

    async def rpc_list_tasks(self, p):
        # "profile": "only" -> step-profiler records (the Steps page);
        # "include" -> both lanes (the Perfetto timeline asks for this
        # explicitly); default EXCLUDES step records so legacy callers
        # (rt list tasks, the /metrics rt_tasks scrape, tracing) keep
        # seeing real tasks only. "serve": "include" additionally returns
        # the serve request spans (rt trace and the timeline ask for them;
        # the state API / dashboard Tasks tab stay real-tasks-only).
        mode = p.get("profile") or "exclude"
        limit = p.get("limit") or 1000
        events = []
        # limit applies PER STORE: a step store at its cap must not crowd
        # the real task events out of a combined (timeline) response
        if mode != "only":
            events += list(getattr(self, "task_events", {}).values())[-limit:]
        if mode != "exclude":
            events += list(getattr(self, "step_events", {}).values())[-limit:]
            # flight-recorder lanes ride the same opt-in: only the
            # timeline (profile "include") wants them — the state API,
            # `rt list tasks`, and the Steps page must not see
            # engtick/engreq/rlhfit pseudo-tasks
            if mode == "include":
                events += list(
                    getattr(self, "recorder_events", {}).values())[-limit:]
        if p.get("serve") == "include" and mode != "only":
            events += list(
                getattr(self, "serve_events", {}).values())[-limit:]
        return events

    # ---- serve events (autoscaler decision records; the store behind the
    # timeline's serve lane and `rt serve status --verbose`) --------------
    _SERVE_DECISIONS_CAP = 1024

    async def rpc_serve_event(self, p):
        if not hasattr(self, "serve_decisions"):
            from collections import deque

            self.serve_decisions: "deque" = deque(
                maxlen=self._SERVE_DECISIONS_CAP)
        p.setdefault("t", time.time())
        self.serve_decisions.append(p)
        return {"ok": True}

    async def rpc_list_serve_events(self, p):
        limit = p.get("limit") or 200
        events = list(getattr(self, "serve_decisions", ()))
        return events[-limit:]

    # ---- placement events (scheduling decision receipts: the store behind
    # `rt sched decisions`, `/api/sched` and the timeline's placement lane;
    # the instrument-first layer ROADMAP item 1's learned-placement work
    # scores against — Placeto-style features, recorded not discarded) -----
    _PLACEMENT_EVENTS_CAP = 2048
    _PLACEMENT_DEDUP_WINDOW_S = 5.0
    PLACEMENT_KINDS = ("dispatch_local", "spillback", "actor_place",
                       "pg_place", "warm_adopt", "gang_place")

    def _record_placement(self, p: Dict) -> None:
        """Store one placement decision record. Repeated identical decisions
        (same kind/node/reason/name) inside the dedup window collapse into
        the existing record's ``count`` — a 5k-task flood of local
        dispatches folds into one row instead of evicting the rest of the
        feed — and every report, deduped or not, increments
        ``rt_sched_placement_decisions_total{kind=}`` exactly once, here
        (single counting site: emitters never double-count)."""
        if not hasattr(self, "placement_events"):
            from collections import deque

            # GCS runs a single asyncio loop; these are loop-only (no lock)
            self.placement_events: "deque" = deque(
                maxlen=self._PLACEMENT_EVENTS_CAP)
            self._placement_last: Dict[Tuple, Dict] = {}
            self._placement_seq = 0
        p.setdefault("t", time.time())
        kind = p.setdefault("kind", "unknown")
        self._observe_placement(kind, p.get("hops"))
        # task_id deliberately NOT in the key: same-shaped decisions fold
        # into one row (count=N, first ids kept)
        key = (kind, p.get("node_id"), p.get("reason"), p.get("name"))
        last = self._placement_last.get(key)
        if (last is not None
                and p["t"] - last.get("last_t", last["t"])
                <= self._PLACEMENT_DEDUP_WINDOW_S):
            last["count"] = last.get("count", 1) + 1
            last["last_t"] = p["t"]
            # keep the freshest candidate features on the folded row — the
            # point of the record is the scheduler's CURRENT view
            if p.get("candidates"):
                last["candidates"] = p["candidates"]
            if (not self.placement_events
                    or last["seq"] < self.placement_events[0]["seq"]):
                self._placement_seq += 1
                last["seq"] = self._placement_seq
                self.placement_events.append(last)
            return
        p.setdefault("count", 1)
        self._placement_seq += 1
        p["seq"] = self._placement_seq
        self.placement_events.append(p)
        self._placement_last[key] = p
        if len(self._placement_last) > 2 * self._PLACEMENT_EVENTS_CAP:
            cutoff = p["t"] - self._PLACEMENT_DEDUP_WINDOW_S
            kept = {k: e for k, e in self._placement_last.items()
                    if e.get("last_t", e["t"]) > cutoff}
            if len(kept) > self._PLACEMENT_EVENTS_CAP:
                kept = dict(sorted(
                    kept.items(),
                    key=lambda kv: kv[1].get("last_t", kv[1]["t"])
                )[-self._PLACEMENT_EVENTS_CAP:])
            self._placement_last = kept

    def _observe_placement(self, kind: str, hops) -> None:
        """Decision counter + spillback-hop histogram. Registry-local;
        shipped by the co-resident pusher (driver, or the head raylet's)."""
        try:
            from ray_tpu_torch.util import metrics as M

            if not hasattr(self, "_placement_counter"):
                self._placement_counter = M.get_or_create(
                    M.Counter, "rt_sched_placement_decisions_total",
                    "Placement decisions recorded, by decision kind",
                    tag_keys=("kind",))
                self._spillback_hops_hist = M.get_or_create(
                    M.Histogram, "rt_sched_spillback_hops",
                    "Spillback hops a task took before dispatching",
                    boundaries=(1.0, 2.0, 3.0, 5.0, 8.0))
            self._placement_counter.inc(1, {"kind": kind})
            if kind == "spillback" and hops:
                self._spillback_hops_hist.observe(float(hops))
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def _node_features(self, nid: str) -> Dict[str, Any]:
        """Per-node scheduling feature vector for a placement receipt's
        candidate set (queue state, warm pool, resource headroom — from the
        node's last heartbeat ``sched`` summary): the inputs a learned
        placement policy would score."""
        n = self.nodes.get(nid)
        if n is None:
            return {"node_id": nid}
        sched = getattr(n, "sched", None) or {}
        classes = sched.get("classes") or []
        warm = sched.get("warm") or {}
        return {
            "node_id": nid,
            "queue_depth": getattr(n, "queue_depth", 0),
            "running": sched.get("running", 0),
            "oldest_wait_s": round(max(
                (c.get("oldest_wait_s") or 0.0 for c in classes),
                default=0.0), 3),
            "warm_idle": warm.get("idle", 0),
            "headroom": n.view.available.to_dict(),
        }

    async def rpc_placement_event(self, p):
        self._record_placement(p)
        return {"ok": True}

    async def rpc_list_placement_events(self, p):
        events = list(getattr(self, "placement_events", ()))
        kind = p.get("kind")
        if kind:
            events = [e for e in events if e.get("kind") == kind]
        node = p.get("node")
        if node:  # prefix match on chosen OR origin node (spillback hops)
            events = [e for e in events
                      if str(e.get("node_id") or "").startswith(node)
                      or str(e.get("from_node") or "").startswith(node)]
        since = p.get("since")
        if since:
            events = [e for e in events
                      if e.get("last_t", e.get("t", 0)) >= since]
        limit = p.get("limit") or 200
        return events[-limit:]

    # ---- cross-node balance telemetry (rt_sched_node_imbalance) ----------
    _BALANCE_HIST_CAP = 128

    def _update_balance(self) -> None:
        """Sample cross-node imbalance: the coefficient of variation over
        per-node queued+running load from the heartbeat ``sched``
        summaries. Called each monitor tick; ROADMAP item 1's bar is this
        series trending flat."""
        rows = []
        for n in self.nodes.values():
            if not n.alive:
                continue
            sched = getattr(n, "sched", None) or {}
            queued = getattr(n, "queue_depth", 0) or 0
            running = sched.get("running", 0) or 0
            rows.append({"node_id": n.node_id, "queued": queued,
                         "running": running, "load": queued + running})
        cov = imbalance_cov([r["load"] for r in rows])
        self._balance_now = {"cov": round(cov, 4), "nodes": rows}
        if not hasattr(self, "_balance_hist"):
            from collections import deque

            self._balance_hist: "deque" = deque(
                maxlen=self._BALANCE_HIST_CAP)
        self._balance_hist.append(
            {"t": time.time(), "cov": round(cov, 4),
             "loads": {r["node_id"]: r["load"] for r in rows}})
        try:
            from ray_tpu_torch.util import metrics as M

            if not hasattr(self, "_imbalance_gauge"):
                # Registry-local; shipped by the co-resident pusher
                self._imbalance_gauge = M.get_or_create(
                    M.Gauge, "rt_sched_node_imbalance",
                    "Coefficient of variation of per-node queued+running "
                    "load (0 = balanced)")
            self._imbalance_gauge.set(cov)
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    async def rpc_sched_balance(self, p):
        """Balance snapshot + recent per-tick history: `rt sched balance`,
        `/api/sched` and the doctor's sustained-imbalance grading."""
        snap = getattr(self, "_balance_now", None)
        if snap is None:
            self._update_balance()
            snap = self._balance_now
        limit = p.get("limit") or 60
        return {"cov": snap["cov"], "nodes": snap["nodes"],
                "history": list(getattr(self, "_balance_hist", ()))[-limit:]}

    # ---- serve proxy registry (multi-proxy front doors): the controller
    # registers every HTTP proxy it starts so load balancers / `rt serve
    # status` / the dashboard can enumerate ingress endpoints without a
    # serve driver attached --------------------------------------------------
    _SERVE_PROXIES_CAP = 256

    async def rpc_serve_proxy_register(self, p):
        if not hasattr(self, "serve_proxies"):
            self.serve_proxies: Dict[str, Dict[str, Any]] = {}
        pid = str(p.get("proxy_id") or "")
        if not pid:
            return {"ok": False, "error": "proxy_id required"}
        self.serve_proxies[pid] = {
            "proxy_id": pid, "host": p.get("host"), "port": p.get("port"),
            "registered_at": time.time()}
        while len(self.serve_proxies) > self._SERVE_PROXIES_CAP:
            self.serve_proxies.pop(next(iter(self.serve_proxies)))
        return {"ok": True, "count": len(self.serve_proxies)}

    async def rpc_serve_proxy_deregister(self, p):
        """``proxy_id: "*"`` clears the registry (serve shutdown)."""
        reg = getattr(self, "serve_proxies", None)
        if not reg:
            return {"ok": True, "count": 0}
        pid = str(p.get("proxy_id") or "")
        if pid == "*":
            reg.clear()
        else:
            reg.pop(pid, None)
        return {"ok": True, "count": len(reg)}

    async def rpc_list_serve_proxies(self, p):
        return list(getattr(self, "serve_proxies", {}).values())

    # ---- memory events (spill / restore / oom_kill instants; the store
    # behind `rt memory --oom` and the timeline's memory lane) -------------
    _MEM_EVENTS_CAP = 2048

    async def rpc_mem_event(self, p):
        if not hasattr(self, "mem_events"):
            from collections import deque

            self.mem_events: "deque" = deque(maxlen=self._MEM_EVENTS_CAP)
        p.setdefault("t", time.time())
        self.mem_events.append(p)
        return {"ok": True}

    async def rpc_list_mem_events(self, p):
        events = list(getattr(self, "mem_events", ()))
        kind = p.get("kind")
        if kind:
            events = [e for e in events if e.get("kind") == kind]
        limit = p.get("limit") or 1000
        return events[-limit:]

    # ---- failure events (the death-cause feed behind `rt errors`,
    # `/api/errors` and the timeline's errors lane; reference: the
    # error-info pubsub channel + RayErrorInfo in common.proto) ------------
    _FAILURE_EVENTS_CAP = 2048
    _FAILURE_DEDUP_WINDOW_S = 30.0

    def _record_failure(self, p: Dict) -> None:
        """Store one categorized FailureEvent. Repeated identical causes
        within the dedup window collapse into the existing event's
        ``count`` (a crash loop must not evict the rest of the feed), and
        every report — deduped or not — increments
        ``rt_failures_total{category=}`` exactly once, here (single
        counting site: emitters never double-count)."""
        if not hasattr(self, "failure_events"):
            from collections import deque

            self.failure_events: "deque" = deque(
                maxlen=self._FAILURE_EVENTS_CAP)
            self._failure_last: Dict[Tuple, Dict] = {}
            self._failure_seq = 0
        p.setdefault("t", time.time())
        p.setdefault("category", F.UNKNOWN)
        F.observe_failure(p["category"])
        # task_id deliberately NOT in the key: 5000 tasks failing the same
        # way within the window fold into one row (count=5000, first
        # task_id kept) instead of evicting the rest of the feed
        key = (p.get("category"), p.get("node_id"), p.get("actor_id"),
               p.get("name"), p.get("message"))
        last = self._failure_last.get(key)
        if (last is not None
                and p["t"] - last.get("last_t", last["t"])
                <= self._FAILURE_DEDUP_WINDOW_S):
            last["count"] = last.get("count", 1) + 1
            last["last_t"] = p["t"]
            # the deque may have rotated this row out while its crash loop
            # kept the dedup key warm — re-append (same dict, accrued
            # count) so an ONGOING failure stays visible in the feed
            if (not self.failure_events
                    or last["seq"] < self.failure_events[0]["seq"]):
                self._failure_seq += 1
                last["seq"] = self._failure_seq
                self.failure_events.append(last)
            return
        p.setdefault("count", 1)
        self._failure_seq += 1
        p["seq"] = self._failure_seq
        self.failure_events.append(p)
        self._failure_last[key] = p
        if len(self._failure_last) > 2 * self._FAILURE_EVENTS_CAP:
            # drop tracking for events long rotated out of the deque; if a
            # unique-key burst keeps everything inside the window, hard-cap
            # to the newest half so the prune actually shrinks (never an
            # O(n) rebuild per insert on the GCS loop)
            cutoff = p["t"] - self._FAILURE_DEDUP_WINDOW_S
            kept = {k: e for k, e in self._failure_last.items()
                    if e.get("last_t", e["t"]) > cutoff}
            if len(kept) > self._FAILURE_EVENTS_CAP:
                kept = dict(sorted(
                    kept.items(),
                    key=lambda kv: kv[1].get("last_t", kv[1]["t"])
                )[-self._FAILURE_EVENTS_CAP:])
            self._failure_last = kept

    async def rpc_failure_event(self, p):
        self._record_failure(p)
        return {"ok": True}

    async def rpc_list_failure_events(self, p):
        events = list(getattr(self, "failure_events", ()))
        category = p.get("category")
        if category:
            events = [e for e in events if e.get("category") == category]
        origin = p.get("origin")
        if origin == "organic":  # everything NOT injected by the chaos plane
            events = [e for e in events if not e.get("origin")]
        elif origin:
            events = [e for e in events if e.get("origin") == origin]
        since = p.get("since")
        if since:
            events = [e for e in events
                      if e.get("last_t", e.get("t", 0)) >= since]
        limit = p.get("limit") or 1000
        return events[-limit:]

    async def rpc_list_objects(self, p):
        limit = p.get("limit") or 1000
        out = []
        for oid, locs in list(self.object_locations.items())[:limit]:
            out.append({"object_id": oid,
                        "size": self.object_sizes.get(oid, 0),
                        "locations": sorted(locs)})
        return out

    async def rpc_route_task(self, p):
        req = ResourceSet(p["resources"])
        exclude = set(p.get("exclude") or ())
        views = {nid: n.view for nid, n in self.nodes.items()
                 if n.alive and nid not in exclude}
        if p.get("require_available"):
            # load-based spillback: only nodes that can run the task NOW
            # (by their last-heartbeat view) are acceptable targets
            views = {nid: v for nid, v in views.items() if v.can_fit(req)}
            if not views:
                return {"node_id": None}
        node_id = pick_node(p.get("strategy"), views, req,
                            preferred=p.get("preferred"))
        if node_id is None:
            return {"error": "infeasible", "node_id": None}
        reply = {"node_id": node_id, "address": self.nodes[node_id].address}
        if p.get("features"):
            # spillback receipts: ship the considered candidates' feature
            # vectors back so the origin raylet can stamp a truthful
            # record. Bounded — a wide cluster must not turn every route
            # reply into a telemetry payload.
            reply["candidates"] = [self._node_features(nid)
                                   for nid in list(views)[:8]]
        return reply

    # ---- cluster info -------------------------------------------------------
    async def rpc_cluster_resources(self, p):
        total: Dict[str, float] = {}
        avail: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.view.total.to_dict().items():
                total[k] = total.get(k, 0) + v
            for k, v in n.view.available.to_dict().items():
                avail[k] = avail.get(k, 0) + v
        return {"total": total, "available": avail}

    async def rpc_next_job_id(self, p):
        self.mark_dirty()
        self._job_counter += 1
        return {"job_index": self._job_counter}
