"""ServeController: the control plane actor for the serve layer.

Reference analogs: ``serve/controller.py:82`` (``ServeController``),
``_private/application_state.py:669`` (``ApplicationStateManager``),
``_private/deployment_state.py:1156`` (``DeploymentState`` reconciler) and
``_private/autoscaling_policy.py:12`` (``calculate_desired_num_replicas``).

One actor owns all desired/actual state:
  - ``deploy_application`` records the desired app graph;
  - a reconcile thread starts missing replicas, removes dead ones, and
    applies autoscaling decisions computed from polled per-replica
    ongoing-request counts with upscale/downscale hysteresis;
  - routers/proxies read versioned replica sets from ``get_replicas`` /
    ``get_routing_table``.

Methods are sync on purpose: they run on the actor's thread pool where
blocking ``ray_tpu_torch.get`` is legal (async actor methods run on the worker's
io loop, which blocking calls would deadlock).

Scale-to-zero: a deployment with ``min_replicas=0`` drops to zero when idle;
a handle's ``wake`` RPC records demand, which the next reconcile tick serves
by starting a replica.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.replica import ReplicaActor

CONTROLLER_NAME = "RT_SERVE_CONTROLLER"
RECONCILE_PERIOD_S = 0.25
_METRICS_WINDOW_CAP = 512   # samples per deployment (one per reconcile tick)
_DECISION_LOG_CAP = 256
_STATUS_KV_KEY = "@serve/status"
_STATUS_PUSH_PERIOD_S = 1.0
_STATS_POLL_PERIOD_S = 1.0


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


class _ReplicaInfo:
    def __init__(self, replica_id: str, handle):
        self.replica_id = replica_id
        self.handle = handle
        self.last_health_check = time.time()
        self.last_ongoing = 0


class _DeploymentState:
    def __init__(self, app_name: str, name: str, config: DeploymentConfig,
                 body, init_args, init_kwargs):
        self.app_name = app_name
        self.name = name
        self.config = config
        self.body = body
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.replicas: Dict[str, _ReplicaInfo] = {}
        # Replica-set version: assigned from the controller's GLOBAL counter
        # so versions stay monotonic across redeploys of the same name — a
        # long-polling router must never see a fresh state reuse a version
        # it already knows.
        self.version = 0
        self.next_replica_idx = 0
        # autoscaling bookkeeping: a bounded ring pruned in place — the
        # old list rebuild ran on every poll AND every target_replicas
        # call. Sized to cover the configured look-back at the per-tick
        # sample rate, or a long look_back_period_s would silently
        # average over a truncated window.
        cap = _METRICS_WINDOW_CAP
        ac = self.config.autoscaling_config
        if ac is not None:
            cap = max(cap, int(ac.look_back_period_s
                               / RECONCILE_PERIOD_S) + 16)
        self.metrics: "deque[Tuple[float, float]]" = deque(
            maxlen=cap)  # (t, total_ongoing)
        self.wake_requested_at: Optional[float] = None
        self.scale_candidate: Optional[int] = None
        self.scale_candidate_since: float = 0.0
        self.last_target: int = 0
        self.starting: Dict[str, Any] = {}  # replica_id -> (handle, ready ref)
        # windowed request stats from the last replica poll (the numbers
        # the decision log records and `rt serve status` prints)
        self.win_stats: Dict[str, Any] = {}
        self.last_stats_poll: float = 0.0
        # why the last target_replicas() returned what it did
        self.last_trigger: Dict[str, Any] = {}

    @property
    def autoscaling(self) -> Optional[AutoscalingConfig]:
        return self.config.autoscaling_config

    def _prune_metrics(self, now: float, keep_s: float) -> None:
        while self.metrics and now - self.metrics[0][0] > keep_s:
            self.metrics.popleft()

    def target_replicas(self, now: float) -> int:
        """Fixed num_replicas, or the autoscaler's desired count
        (reference ``calculate_desired_num_replicas``), extended with the
        optional queue-depth / p99 / QPS signals computed from the
        windowed stats poll — desired is the MAX across enabled signals
        and the trigger records which one drove it."""
        ac = self.autoscaling
        if ac is None:
            self.last_trigger = {"reason": "fixed",
                                 "num_replicas": self.config.num_replicas}
            return self.config.num_replicas
        current = len(self.replicas) + len(self.starting)
        self._prune_metrics(now, ac.look_back_period_s)
        total_ongoing = (sum(m[1] for m in self.metrics) / len(self.metrics)
                         if self.metrics else 0.0)
        desired = int(-(-total_ongoing // ac.target_ongoing_requests))  # ceil
        signal = "ongoing"
        # continuous-batching replicas queue INSIDE the engine (every
        # request is a stream, so the replica-level executor queue stays
        # ~0) — the engine's pending count must feed the queue signal or
        # the signal is blind on exactly the deployments it exists for
        queue_depth = (self.win_stats.get("queue_depth", 0)
                       + self.win_stats.get("cb_pending", 0))
        p99_s = self.win_stats.get("p99_s", 0.0)
        qps = self.win_stats.get("qps", 0.0)
        if ac.target_queue_depth is not None and queue_depth:
            by_queue = int(-(-queue_depth // ac.target_queue_depth))
            if by_queue > desired:
                desired, signal = by_queue, "queue_depth"
        if ac.target_qps_per_replica is not None and qps:
            by_qps = int(-(-qps // ac.target_qps_per_replica))
            if by_qps > desired:
                desired, signal = by_qps, "qps"
        if (ac.max_p99_s is not None and qps > 0 and p99_s > ac.max_p99_s
                and current + 1 > desired):
            # latency backstop: ask for one more than we have; the
            # hysteresis delay keeps a single slow window from thrashing
            desired, signal = current + 1, "p99"
        woke = (self.wake_requested_at is not None
                and now - self.wake_requested_at < 30.0)
        if woke:
            # cold-start demand: guarantee capacity even before metrics move
            desired = max(desired, 1)
        desired = max(ac.min_replicas, min(ac.max_replicas, desired))
        self.last_trigger = {
            "reason": "wake" if (woke and total_ongoing == 0) else "ongoing",
            "signal": signal,
            "ongoing_avg": round(total_ongoing, 3),
            "target_ongoing_requests": ac.target_ongoing_requests,
            "look_back_period_s": ac.look_back_period_s,
            "queue_depth": queue_depth,
            "p50_s": self.win_stats.get("p50_s", 0.0),
            "p99_s": p99_s,
            "qps": qps,
        }
        if desired == current:
            self.scale_candidate = None
            return current
        # hysteresis: hold the new value for the delay before acting
        if self.scale_candidate != desired:
            self.scale_candidate = desired
            self.scale_candidate_since = now
        delay = (ac.upscale_delay_s if desired > current
                 else ac.downscale_delay_s)
        self.last_trigger["hysteresis"] = {
            "candidate": desired, "held_s": round(
                now - self.scale_candidate_since, 3),
            "delay_s": delay}
        if now - self.scale_candidate_since >= delay:
            return desired
        return current


@ray_tpu_torch.remote
class ServeController:
    def __init__(self):
        self._lock = threading.RLock()
        self._update_cond = threading.Condition(self._lock)
        self._apps: Dict[str, Dict[str, Any]] = {}
        self._deployments: Dict[Tuple[str, str], _DeploymentState] = {}
        self._routing_version = 0
        self._version_counter = 0
        self._proxy = None
        self._grpc_proxy = None
        self._grpc_port = None
        self._proxy_port: Optional[int] = None
        # multi-proxy scale-out: [(proxy_id, handle, port)]; entry 0 is
        # the back-compat RT_SERVE_PROXY on the requested port
        self._proxies: List[Tuple[str, Any, int]] = []  # rt: guarded-by(_lock)
        # serializes proxy *boots* only: actor creation + ready round-trips
        # take seconds and must never run under self._lock, which every
        # cheap status/routing getter shares (rt lint: lock-discipline)
        self._proxy_boot_lock = threading.Lock()
        self._shutdown = False
        # autoscaler decision log: every applied target change, with the
        # metric values that produced it (bounded; `rt serve status
        # --verbose`, /api/serve and the timeline serve lane read it)
        self._decisions: "deque" = deque(maxlen=_DECISION_LOG_CAP)
        self._last_status_push = 0.0
        self._reconciler = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="rt-serve-rec")
        self._reconciler.start()

    # -- deploy ---------------------------------------------------------------
    def deploy_application(self, app_name: str, route_prefix: str,
                           ingress: str, deployments: List[Dict]) -> None:
        """deployments: [{name, body, init_args, init_kwargs, config}]"""
        with self._lock:
            new_names = {d["name"] for d in deployments}
            for key in [k for k in self._deployments
                        if k[0] == app_name and k[1] not in new_names]:
                self._stop_deployment(self._deployments.pop(key))
            self._apps[app_name] = {"route_prefix": route_prefix,
                                    "ingress": ingress}
            for d in deployments:
                cfg: DeploymentConfig = d["config"]
                cfg.validate()
                key = (app_name, d["name"])
                existing = self._deployments.get(key)
                if existing is not None:
                    # redeploy: new code/config — restart replicas
                    self._stop_deployment(existing)
                self._deployments[key] = _DeploymentState(
                    app_name, d["name"], cfg, d["body"], d["init_args"],
                    d["init_kwargs"])
            self._bump_routing()

    def delete_application(self, app_name: str) -> None:
        with self._lock:
            for key in [k for k in self._deployments if k[0] == app_name]:
                self._stop_deployment(self._deployments.pop(key))
            self._apps.pop(app_name, None)
            self._bump_routing()

    def wait_healthy(self, app_name: str, timeout_s: float = 60.0) -> bool:
        """Block until every deployment of the app has its minimum replica
        count running (autoscaling min may be 0 — then 'healthy' is free)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                states = [s for (a, _), s in self._deployments.items()
                          if a == app_name]
                ok = states and all(
                    len(s.replicas) >= self._min_required(s) for s in states)
            if ok:
                return True
            time.sleep(0.05)
        raise TimeoutError(f"app {app_name!r} not healthy in {timeout_s}s")

    def _min_required(self, s: _DeploymentState) -> int:
        if s.autoscaling is not None:
            return s.autoscaling.min_replicas
        return s.config.num_replicas

    # -- routing --------------------------------------------------------------
    def _bump_routing(self) -> None:
        self._routing_version += 1
        self._update_cond.notify_all()

    def _next_version(self) -> int:
        self._version_counter += 1
        self._update_cond.notify_all()
        return self._version_counter

    def get_replicas(self, app_name: str, deployment: str,
                     known_version: int, wait: bool = False,
                     timeout: float = 10.0) -> Dict[str, Any]:
        """``wait=True`` long-polls: block until the replica set's version
        moves past ``known_version`` or the timeout lapses (reference:
        ``LongPollHost``, ``serve/_private/long_poll.py`` — handles hold ONE
        blocked call instead of TTL-polling). Runs on the controller's actor
        thread pool, so blocking here is legal and local; version bumps
        ``notify_all`` the condition, so waiters wake immediately."""
        deadline = time.time() + timeout
        with self._update_cond:
            while True:
                s = self._deployments.get((app_name, deployment))
                version = s.version if s is not None else known_version
                remaining = deadline - time.time()
                if (not wait or version != known_version
                        or remaining <= 0 or self._shutdown):
                    if s is None:
                        return {"version": known_version, "replicas": []}
                    return {"version": s.version,
                            "replicas": [(r.replica_id, r.handle)
                                         for r in s.replicas.values()]}
                self._update_cond.wait(remaining)

    def get_routing_table(self, known_version: int = -1, wait: bool = False,
                          timeout: float = 10.0) -> Dict[str, Any]:
        """For proxies: route_prefix -> (app, ingress deployment); long-polls
        like ``get_replicas`` when ``wait=True``."""
        deadline = time.time() + timeout
        with self._update_cond:
            while True:
                remaining = deadline - time.time()
                if (not wait or self._routing_version != known_version
                        or remaining <= 0 or self._shutdown):
                    return {
                        "version": self._routing_version,
                        "routes": {meta["route_prefix"]: (app, meta["ingress"])
                                   for app, meta in self._apps.items()}}
                self._update_cond.wait(remaining)

    def wake(self, app_name: str, deployment: str) -> None:
        with self._lock:
            s = self._deployments.get((app_name, deployment))
            if s is not None:
                s.wake_requested_at = time.time()

    def list_applications(self) -> Dict[str, Any]:
        with self._lock:
            out = {}
            for app, meta in self._apps.items():
                deps = {}
                for (a, name), s in self._deployments.items():
                    if a != app:
                        continue
                    deps[name] = {
                        "replicas": len(s.replicas),
                        "starting": len(s.starting),
                        "target": s.last_target,
                        "autoscaling": s.autoscaling is not None,
                        "stats": dict(s.win_stats),
                    }
                out[app] = {"route_prefix": meta["route_prefix"],
                            "ingress": meta["ingress"], "deployments": deps}
            return out

    def get_decisions(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Tail of the autoscaler decision log, oldest first."""
        with self._lock:
            return list(self._decisions)[-limit:]

    def serve_status(self, decision_limit: int = 50) -> Dict[str, Any]:
        """Everything `rt serve status` / the dashboard Serve tab renders:
        applications with per-deployment windowed stats, plus the
        decision-log tail."""
        return {"applications": self.list_applications(),
                "decisions": self.get_decisions(decision_limit),
                "proxies": self._proxy_rows(),
                "t": time.time()}

    def flush_metrics(self) -> None:
        """Push the controller's metric registry to the KV now (tests)."""
        from ray_tpu_torch.util import metrics

        metrics.flush_now()

    def get_ingress(self, app_name: str):
        """Ingress deployment name of one application (gRPC proxy lookup)."""
        with self._lock:
            meta = self._apps.get(app_name)
            return meta["ingress"] if meta else None

    def ensure_grpc_proxy(self, host: str, port: int) -> int:
        """gRPC ingress (reference: ``gRPCProxy``); idempotent like the
        HTTP proxy."""
        from ray_tpu_torch.serve.grpc_proxy import GrpcProxyActor

        with self._proxy_boot_lock:
            with self._lock:
                if self._grpc_proxy is not None:
                    return self._grpc_port
            if self._shutdown:
                # shutdown held the boot lock first and already tore the
                # proxies down — booting now would leak past teardown
                raise RuntimeError("serve controller is shut down")
            # boot OUTSIDE self._lock: the ready round-trip takes seconds
            # and would convoy every status/routing getter behind it
            handle = GrpcProxyActor.options(
                name="RT_SERVE_GRPC_PROXY", max_concurrency=256,
                num_cpus=0).remote(host, port)
            try:
                # rt: lint-allow(lock-discipline) the boot lock's whole
                # job is to serialize this slow boot; nothing latency-
                # sensitive contends on it (self._lock must stay free)
                got = ray_tpu_torch.get(handle.ready.remote())
            except BaseException:
                # a half-booted NAMED actor left alive would block every
                # retry with "actor name taken" and escape shutdown
                try:
                    ray_tpu_torch.kill(handle)
                except Exception:  # noqa: BLE001 — best-effort reap
                    pass
                raise
            with self._lock:
                self._grpc_proxy, self._grpc_port = handle, got
                return self._grpc_port

    # -- http proxy -----------------------------------------------------------
    def ensure_proxy(self, host: str, port: int, count: int = 1) -> int:
        """Start (up to) ``count`` HTTP proxy processes; idempotent and
        grow-only — a later call with a larger ``count`` adds proxies,
        a smaller one never tears running ones down (requests may be in
        flight). The first proxy keeps the RT_SERVE_PROXY name and the
        requested port; the rest bind ephemeral ports and register in
        the GCS proxy registry so an external load balancer (or
        ``serve.proxy_ports()``) can fan traffic across every event
        loop instead of queueing behind one proxy process."""
        from ray_tpu_torch.serve.proxy import ProxyActor

        want = max(1, int(count))
        # the boot lock (not self._lock) serializes concurrent growers:
        # each actor boot + start round-trip takes seconds, and holding
        # self._lock across it used to freeze every status/routing getter
        with self._proxy_boot_lock:
            while True:
                with self._lock:
                    idx = len(self._proxies)
                    if idx >= want:
                        return self._proxy_port
                if self._shutdown:
                    # shutdown held the boot lock first and already tore
                    # the proxies down — booting now would leak past it
                    raise RuntimeError("serve controller is shut down")
                proxy_id = "proxy-0" if idx == 0 else f"proxy-{idx}"
                name = ("RT_SERVE_PROXY" if idx == 0
                        else f"RT_SERVE_PROXY_{idx}")
                handle = ProxyActor.options(
                    name=name, max_concurrency=256, num_cpus=0).remote()
                bind_port = port if idx == 0 else 0
                try:
                    # rt: lint-allow(lock-discipline) boot lock again:
                    # held across the boot on purpose, cheap getters use
                    # self._lock
                    got = ray_tpu_torch.get(handle.start.remote(host, bind_port,
                                                          proxy_id))
                except BaseException:
                    # reap the half-booted named actor or its name blocks
                    # every retry and it escapes shutdown teardown
                    try:
                        ray_tpu_torch.kill(handle)
                    except Exception:  # noqa: BLE001 — best-effort reap
                        pass
                    raise
                with self._lock:
                    self._proxies.append((proxy_id, handle, got))
                    if idx == 0:
                        self._proxy, self._proxy_port = handle, got
                self._register_proxy(proxy_id, host, got)

    def proxy_ports(self) -> List[int]:
        with self._lock:
            return [p for _, _, p in self._proxies]

    def _proxy_rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"proxy": pid, "port": port}
                    for pid, _, port in self._proxies]

    def _register_proxy(self, proxy_id: str, host: str, port: int) -> None:
        """Best-effort row in the GCS proxy registry (``rt serve status``
        and external LB config readers see every front door)."""
        try:
            backend = ray_tpu_torch.global_worker()._require_backend()
            if hasattr(backend, "_gcs"):
                backend.io.run(backend._gcs.call(
                    "serve_proxy_register",
                    {"proxy_id": proxy_id, "host": host, "port": port,
                     "pid": None}))
        except Exception:  # noqa: BLE001 — registry is advisory
            pass

    def _deregister_proxies(self) -> None:
        try:
            backend = ray_tpu_torch.global_worker()._require_backend()
            if hasattr(backend, "_gcs"):
                backend.io.run(backend._gcs.call(
                    "serve_proxy_deregister", {"proxy_id": "*"}))
        except Exception:  # noqa: BLE001
            pass

    # -- reconcile ------------------------------------------------------------
    def _reconcile_loop(self) -> None:
        while not self._shutdown:
            try:
                self._reconcile_once()
            except Exception:  # noqa: BLE001 — keep the loop alive
                traceback.print_exc()
            time.sleep(RECONCILE_PERIOD_S)

    def _reconcile_once(self) -> None:
        now = time.time()
        with self._lock:
            states = list(self._deployments.values())
        for s in states:
            self._adopt_started(s)
            self._poll_metrics(s, now)
            rec = None
            with self._lock:
                old_target = s.last_target
                target = s.target_replicas(now)
                s.last_target = target
                current = len(s.replicas) + len(s.starting)
                if target != old_target:
                    rec = self._record_decision(s, old_target, target, now)
                if current < target:
                    for _ in range(target - current):
                        self._start_replica(s)
                elif current > target:
                    self._remove_replicas(s, current - target)
            if rec is not None:
                # best-effort mirror into the GCS serve-event feed (the
                # timeline serve lane joins decisions against the request
                # spans) — a blocking RPC, so OUTSIDE the lock that
                # routers' long-polls contend on
                try:
                    backend = ray_tpu_torch.global_worker()._require_backend()
                    if hasattr(backend, "_gcs"):
                        backend.io.run(
                            backend._gcs.call("serve_event", dict(rec)))
                except Exception:  # noqa: BLE001
                    pass
            self._health_check(s, now)
        self._push_status_snapshot(now)

    def _record_decision(self, s: _DeploymentState, old_target: int,
                         new_target: int, now: float) -> Dict[str, Any]:
        """Stamp one scaling decision (caller holds the lock): old->new
        target, the triggering metric values, and the hysteresis state —
        so "why did it scale?" is answerable after the fact."""
        direction = ("deploy" if old_target == 0 and s.next_replica_idx == 0
                     else "up" if new_target > old_target else "down")
        rec = {"t": now, "kind": "autoscale_decision",
               "app": s.app_name, "deployment": s.name,
               "old_target": old_target, "new_target": new_target,
               "direction": direction,
               "trigger": dict(s.last_trigger),
               "replicas": len(s.replicas), "starting": len(s.starting)}
        self._decisions.append(rec)
        try:
            from ray_tpu_torch.serve import obs

            obs.autoscale_decisions_total().inc(tags={
                "app": s.app_name, "deployment": s.name,
                "direction": direction})
        except Exception:  # noqa: BLE001 — telemetry best-effort
            pass
        return rec

    def _push_status_snapshot(self, now: float) -> None:
        """Throttled compact status snapshot into the GCS KV, so `rt
        doctor` can grade serve health without attaching a driver."""
        if now - self._last_status_push < _STATUS_PUSH_PERIOD_S:
            return
        self._last_status_push = now
        try:
            import json

            backend = ray_tpu_torch.global_worker()._require_backend()
            if not hasattr(backend, "kv_put"):
                return
            with self._lock:
                deployments = [
                    {"app": s.app_name, "name": s.name,
                     "replicas": len(s.replicas),
                     "starting": len(s.starting),
                     "target": s.last_target,
                     "autoscaling": s.autoscaling is not None,
                     **{k: s.win_stats.get(k, 0) for k in
                        ("ongoing", "queue_depth", "p50_s", "p99_s",
                         "qps")}}
                    for s in self._deployments.values()]
            backend.kv_put(_STATUS_KV_KEY, json.dumps(
                {"t": now, "deployments": deployments}).encode())
        except Exception:  # noqa: BLE001 — snapshot best-effort
            pass

    def _start_replica(self, s: _DeploymentState) -> None:
        rid = f"{s.app_name}#{s.name}#{s.next_replica_idx}"
        s.next_replica_idx += 1
        opts = dict(s.config.ray_actor_options or {})
        opts.setdefault("num_cpus", 0.1)
        # replicas spread across nodes by default (reference:
        # SpreadDeploymentSchedulingPolicy) — one node dying must not take a
        # whole deployment's replica set with it
        if "scheduling_strategy" not in opts:
            from ray_tpu_torch.core.task_spec import SpreadStrategy

            opts["scheduling_strategy"] = SpreadStrategy()
        opts["max_concurrency"] = max(16, s.config.max_ongoing_requests + 4)
        opts["name"] = f"RT_SERVE:{rid}"
        handle = ReplicaActor.options(**opts).remote(
            s.name, s.app_name, rid, s.body, s.init_args, s.init_kwargs,
            s.config.max_ongoing_requests, s.config.user_config)
        # readiness probe: the first health check resolving means __init__ ran
        s.starting[rid] = (handle, handle.check_health.remote())

    def _adopt_started(self, s: _DeploymentState) -> None:
        with self._lock:
            pending = list(s.starting.items())
        for rid, (handle, ready_ref) in pending:
            done, _ = ray_tpu_torch.wait([ready_ref], num_returns=1, timeout=0)
            if not done:
                continue
            with self._lock:
                s.starting.pop(rid, None)
            try:
                ray_tpu_torch.get(done[0])
            except Exception:  # init failed — drop; next tick restarts
                traceback.print_exc()
                continue
            with self._lock:
                s.replicas[rid] = _ReplicaInfo(rid, handle)
                s.version = self._next_version()
                self._bump_routing()

    def _poll_metrics(self, s: _DeploymentState, now: float) -> None:
        """Windowed stats poll: every replica reports ongoing, executor
        queue depth and its recent request latencies in ONE RPC; the merge
        feeds the autoscaler, the decision log, the `rt_serve_ongoing` /
        `rt_serve_queue_depth` gauges and `rt serve status`.

        The stats poll re-ships up to 200 latency floats per replica, so
        it runs at the 1 s status cadence (its consumers — snapshot,
        gauges, decision log — are 1 s-grained), not per reconcile tick;
        autoscaled deployments keep the cheap per-tick ``ongoing_count``
        sample in between so the look-back average keeps its resolution."""
        with self._lock:
            reps = list(s.replicas.values())
        if now - s.last_stats_poll < _STATS_POLL_PERIOD_S:
            if s.autoscaling is None:
                return
            total = 0
            if reps:
                refs = [r.handle.ongoing_count.remote() for r in reps]
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=2.0)
                for r, ref in zip(reps, refs):
                    if ref in ready:
                        try:
                            r.last_ongoing = ray_tpu_torch.get(ref)
                            total += r.last_ongoing
                        except Exception:  # noqa: BLE001
                            pass
            with self._lock:
                s.metrics.append((now, total))
            return
        s.last_stats_poll = now
        total_ongoing = 0
        total_queue = 0
        completed = 0
        qps = 0.0
        window_s = 30.0
        lats: List[float] = []
        cb = {"active": 0, "max_slots": 0, "pending": 0,
              "tokens_generated": 0, "requests_completed": 0}
        cb_seen = False
        kv = {"hits": 0, "misses": 0, "evictions": 0, "bytes": 0,
              "pages": 0, "hit_tokens": 0}
        kv_seen = False
        # engine flight-recorder rollup (attainment/goodput averaged,
        # gap p99 worst-of-fleet): the replica's engine_stats() carries
        # its recorder summary, and `rt serve status` shows the fleet
        # SLO picture without a second RPC
        eng_roll = {"ttft_att": 0.0, "tpot_att": 0.0, "goodput": 0.0,
                    "gap_p99": 0.0, "n": 0}
        if reps:
            refs = [r.handle.stats_window.remote(window_s) for r in reps]
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=2.0)
            for r, ref in zip(reps, refs):
                if ref in ready:
                    try:
                        st = ray_tpu_torch.get(ref)
                        r.last_ongoing = st.get("ongoing", 0)
                        total_ongoing += r.last_ongoing
                        total_queue += st.get("queue_depth", 0)
                        completed += st.get("completed", 0)
                        # per-replica effective window: a saturated latency
                        # ring reports the shorter span it actually covers
                        qps += (st.get("completed", 0)
                                / max(1e-3, st.get("window_s", window_s)))
                        lats.extend(st.get("latencies") or ())
                        eng = st.get("engine")
                        if eng:
                            # continuous-batching engines report slot
                            # occupancy; the sum is the deployment's
                            # live decode capacity picture
                            cb_seen = True
                            for k in cb:
                                cb[k] += eng.get(k, 0)
                            ekv = eng.get("kv")
                            if ekv:
                                # prefix/KV-cache plane: summed over the
                                # replica fleet (monotonic counters +
                                # live bytes/pages)
                                kv_seen = True
                                for k in kv:
                                    kv[k] += ekv.get(k, 0)
                            rec = eng.get("recorder")
                            if rec and rec.get("window_completed"):
                                eng_roll["n"] += 1
                                eng_roll["ttft_att"] += rec.get(
                                    "ttft_attainment", 0.0)
                                eng_roll["tpot_att"] += rec.get(
                                    "tpot_attainment", 0.0)
                                eng_roll["goodput"] += rec.get(
                                    "goodput_tok_s", 0.0)
                                eng_roll["gap_p99"] = max(
                                    eng_roll["gap_p99"],
                                    rec.get("tick_gap_p99_s", 0.0))
                    except Exception:  # noqa: BLE001 — health check handles it
                        pass
        lats.sort()
        win = {"ongoing": total_ongoing, "queue_depth": total_queue,
               "completed": completed, "window_s": window_s,
               "qps": round(qps, 3),
               "p50_s": round(_percentile(lats, 0.50), 6),
               "p99_s": round(_percentile(lats, 0.99), 6)}
        if cb_seen:
            win["cb_active"] = cb["active"]
            win["cb_slots"] = cb["max_slots"]
            win["cb_pending"] = cb["pending"]
            # monotonic engine counters (summed over replicas): `rt
            # serve status` and pollers difference these across windows
            # instead of inferring load from instantaneous occupancy
            win["cb_tokens_generated"] = cb["tokens_generated"]
            win["cb_requests_completed"] = cb["requests_completed"]
        if eng_roll["n"]:
            n = eng_roll["n"]
            win["eng_ttft_att"] = round(eng_roll["ttft_att"] / n, 4)
            win["eng_tpot_att"] = round(eng_roll["tpot_att"] / n, 4)
            win["eng_goodput_tok_s"] = round(eng_roll["goodput"], 1)
            win["eng_gap_p99_s"] = round(eng_roll["gap_p99"], 6)
        if kv_seen:
            win["kv_hits"] = kv["hits"]
            win["kv_misses"] = kv["misses"]
            win["kv_evictions"] = kv["evictions"]
            win["kv_bytes"] = kv["bytes"]
            win["kv_pages"] = kv["pages"]
            win["kv_hit_tokens"] = kv["hit_tokens"]
            lookups = kv["hits"] + kv["misses"]
            # lifetime hit rate: `rt serve status` / the dashboard show
            # this as the hit-rate column; pollers wanting a windowed
            # rate difference the monotonic hits/misses across polls
            win["kv_hit_rate"] = round(kv["hits"] / lookups, 4) \
                if lookups else 0.0
        with self._lock:
            s.win_stats = win
            s.metrics.append((now, total_ongoing))
        try:
            from ray_tpu_torch.serve import obs

            tags = {"app": s.app_name, "deployment": s.name}
            obs.ongoing_gauge().set(total_ongoing, tags=tags)
            obs.queue_depth_gauge().set(total_queue, tags=tags)
        except Exception:  # noqa: BLE001 — telemetry best-effort
            pass

    def _health_check(self, s: _DeploymentState, now: float) -> None:
        with self._lock:
            due = [r for r in s.replicas.values()
                   if now - r.last_health_check >= s.config.health_check_period_s]
            for r in due:
                r.last_health_check = now
        for r in due:
            ref = r.handle.check_health.remote()
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1,
                                    timeout=s.config.health_check_timeout_s)
            ok = False
            if ready:
                try:
                    ray_tpu_torch.get(ready[0])
                    ok = True
                except Exception:  # noqa: BLE001
                    pass
            if not ok:
                with self._lock:
                    s.replicas.pop(r.replica_id, None)
                    s.version = self._next_version()
                    self._bump_routing()
                try:
                    ray_tpu_torch.kill(r.handle)
                except Exception:  # noqa: BLE001
                    pass

    def _remove_replicas(self, s: _DeploymentState, n: int) -> None:
        # caller holds the lock; prefer tearing down still-starting replicas
        for rid in list(s.starting)[:n]:
            handle, _ = s.starting.pop(rid)
            n -= 1
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass
        if n <= 0:
            return
        victims = sorted(s.replicas.values(),
                         key=lambda r: r.last_ongoing)[:n]
        for r in victims:
            del s.replicas[r.replica_id]
            s.version = self._next_version()
            self._bump_routing()
            threading.Thread(
                target=self._drain_and_kill,
                args=(r.handle, s.config.graceful_shutdown_timeout_s),
                daemon=True).start()

    def _drain_and_kill(self, handle, timeout_s: float) -> None:
        try:
            ref = handle.prepare_shutdown.remote(timeout_s)
            ray_tpu_torch.wait([ref], num_returns=1, timeout=timeout_s + 5.0)
        except Exception:  # noqa: BLE001
            pass
        try:
            ray_tpu_torch.kill(handle)
        except Exception:  # noqa: BLE001
            pass

    def _stop_deployment(self, s: _DeploymentState) -> None:
        # caller holds the lock
        for rid in list(s.starting):
            handle, _ = s.starting.pop(rid)
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass
        for r in list(s.replicas.values()):
            try:
                ray_tpu_torch.kill(r.handle)
            except Exception:  # noqa: BLE001
                pass
        s.replicas.clear()
        s.version = self._next_version()
        self._bump_routing()
        # stale-label removal: a deleted deployment's gauges must not
        # linger on the Prometheus page forever
        try:
            from ray_tpu_torch.serve import obs

            tags = {"app": s.app_name, "deployment": s.name}
            obs.ongoing_gauge().remove(tags=tags)
            obs.queue_depth_gauge().remove(tags=tags)
        except Exception:  # noqa: BLE001
            pass

    def shutdown(self) -> None:
        self._shutdown = True
        try:
            # drop the status snapshot: doctor must not grade a dead
            # serve instance's numbers (it also skips stale stamps)
            backend = ray_tpu_torch.global_worker()._require_backend()
            if hasattr(backend, "kv_del"):
                backend.kv_del(_STATUS_KV_KEY)
        except Exception:  # noqa: BLE001
            pass
        with self._update_cond:
            self._update_cond.notify_all()  # release blocked long-polls
        # the boot lock serializes against an in-flight ensure_proxy /
        # ensure_grpc_proxy on another controller thread: without it, a
        # proxy mid-boot would be appended+registered AFTER the teardown
        # below swapped the list, leaking a live actor past shutdown
        # rt: lint-allow(lock-discipline) boot lock: held across the
        # proxy stop RPCs on purpose (see ensure_proxy)
        with self._proxy_boot_lock:
            self._deregister_proxies()
            with self._lock:
                for key in list(self._deployments):
                    self._stop_deployment(self._deployments.pop(key))
                self._apps.clear()
                proxies, self._proxies = list(self._proxies), []
                self._proxy = None
                gproxy, self._grpc_proxy = self._grpc_proxy, None
            for _, proxy, _ in proxies:
                try:
                    # rt: lint-allow(lock-discipline) shutdown stop RPC:
                    # the boot lock is held on purpose (header comment)
                    ray_tpu_torch.get(proxy.stop.remote())
                    ray_tpu_torch.kill(proxy)
                except Exception:  # noqa: BLE001
                    pass
            if gproxy is not None:
                try:
                    # rt: lint-allow(lock-discipline) same as above
                    ray_tpu_torch.get(gproxy.shutdown.remote())
                    ray_tpu_torch.kill(gproxy)
                except Exception:  # noqa: BLE001
                    pass
