"""Chaos plane: seeded, deterministic fault injection for the whole runtime.

Reference analogs: the ``NodeKiller``/``WorkerKillerActor`` fault injectors
behind Ray's chaos suites (``_private/test_utils.py:1401``) and the
``RAY_testing_*`` fault-injection flags — except first-class: a
:class:`ChaosPlan` is a *seeded, replayable* set of faults armed against
**named injection sites** threaded through the raylet, GCS, worker-core, RPC
layer and object store. The same plan + seed produces the same fire
sequence, so a chaos test is an assertion, not a dice roll.

Sites (see README "Chaos & recovery" for the effects table):

  ======================  ====================================================
  site                    fires in / effect
  ======================  ====================================================
  ``worker.kill``         worker process, at task/actor-method entry:
                          ``os._exit(137)`` mid-execution
  ``raylet.kill_worker``  raylet ``_run_task``: SIGKILL the acquired worker
                          just before the push (counters live in the
                          long-lived raylet — use this for kill-once plans)
  ``raylet.heartbeat_drop``  raylet heartbeat loop: skip the beat
                          (partition raylet from the GCS -> node death)
  ``gcs.kill``            GCS heartbeat handler: ``os._exit(137)`` when the
                          GCS runs as a standalone daemon (``rt start``);
                          suppressed (stamped only) for an in-process GCS
  ``rpc.delay``           RpcClient.call: sleep ``delay_s`` before sending
                          (``target`` matches the method name)
  ``rpc.drop``            RpcClient.call: raise ConnectionLost instead of
                          sending (simulated partition)
  ``object.lose``         raylet seal path: the object's store copy (and any
                          spill file) is deleted right after its location
                          registers — every later get must reconstruct
  ``spill.slow``          raylet spill executor: sleep ``delay_s`` per
                          spilled object (slow disk)
  ``oom.pressure``        raylet memory monitor: report fake node memory at
                          ``value`` (fraction, default 0.99) -> OOM kill
  ======================  ====================================================

Fault spec fields (all optional except ``site``): ``at`` (fire exactly on
hit #N of the site, 1-based), ``after`` (fire on every hit > N), ``prob``
(fire with seeded probability), ``max_fires`` (stop after M fires),
``target`` (substring match against the site's target, e.g. a method or
function name), ``delay_s`` / ``value`` (effect parameters). Counters are
**per process**: a killed worker's replacement starts fresh, so kill-once
plans belong on the raylet-side sites.

Distribution: ``rt chaos arm`` ships the plan to the GCS
(``rpc_chaos_arm``), which stores it in the KV under ``@chaos/plan`` and
bumps a revision that rides every heartbeat reply; raylets see the new rev,
fetch the plan, arm their own process, forward it to live workers
(``chaos_arm`` worker RPC) and inject ``RT_CHAOS_PLAN_JSON`` into every new
worker's env. Every fired fault stamps a FailureEvent with
``origin="chaos"`` into the failure feed — injected and organic failures stay
distinguishable (``rt errors --origin chaos`` / ``--origin organic``) — and
ticks ``rt_chaos_injections_total{site=}``.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Any, Dict, List, Optional

ORIGIN_CHAOS = "chaos"

# site -> the failure category its injection event is stamped with
# (core/failure.py taxonomy; values must stay inside F.CATEGORIES)
SITE_CATEGORIES: Dict[str, str] = {
    "worker.kill": "worker_crash",
    "raylet.kill_worker": "worker_crash",
    "raylet.heartbeat_drop": "node_death",
    "gcs.kill": "node_death",
    "rpc.delay": "unknown",
    "rpc.drop": "unknown",
    "object.lose": "object_lost",
    "spill.slow": "unknown",
    "oom.pressure": "oom_kill",
}
SITES = tuple(SITE_CATEGORIES)

_FAULT_FIELDS = ("site", "at", "after", "prob", "max_fires", "target",
                 "delay_s", "value")


class ChaosPlan:
    """A seeded list of fault specs. Validates eagerly so a typo'd site
    fails at arm time, not silently never-fires. ``nonce`` is stamped by
    the GCS per explicit ``rt chaos arm``: a DELIBERATE re-arm of the
    same faults gets a fresh nonce (counters reset, the experiment
    repeats), while re-announcements of one stored plan (head restart,
    worker forwards) carry the same nonce and stay idempotent."""

    def __init__(self, seed: int = 0,
                 faults: Optional[List[Dict[str, Any]]] = None,
                 nonce: int = 0):
        self.seed = int(seed)
        self.nonce = int(nonce)
        self.faults: List[Dict[str, Any]] = []
        for f in faults or ():
            if not isinstance(f, dict) or "site" not in f:
                raise ValueError(f"fault {f!r} needs a 'site'")
            if f["site"] not in SITE_CATEGORIES:
                raise ValueError(
                    f"unknown injection site {f['site']!r}; valid sites: "
                    f"{', '.join(SITES)}")
            unknown = set(f) - set(_FAULT_FIELDS)
            if unknown:
                raise ValueError(
                    f"fault {f['site']!r} has unknown field(s) "
                    f"{sorted(unknown)}; valid: {_FAULT_FIELDS}")
            f = dict(f)
            # eager numeric coercion: a malformed value (e.g. "at": null
            # from a JSON plan file) must fail HERE, not silently disable
            # evaluation inside maybe_fire's never-raise guard
            try:
                for key in ("at", "after", "max_fires"):
                    if key in f:
                        f[key] = int(f[key])
                for key in ("prob", "delay_s", "value"):
                    if key in f:
                        f[key] = float(f[key])
            except (TypeError, ValueError):
                raise ValueError(
                    f"fault {f['site']!r}: non-numeric value for a "
                    f"numeric field in {f!r}") from None
            if "prob" in f and not 0.0 <= f["prob"] <= 1.0:
                raise ValueError(f"prob must be in [0, 1], got {f['prob']}")
            self.faults.append(f)
        if not self.faults:
            raise ValueError("a ChaosPlan needs at least one fault")

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"seed": self.seed,
                             "faults": [dict(f) for f in self.faults]}
        if self.nonce:
            d["nonce"] = self.nonce
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_value(cls, value: Any) -> "ChaosPlan":
        if isinstance(value, ChaosPlan):
            return value
        if isinstance(value, str):
            value = json.loads(value)
        if not isinstance(value, dict):
            raise ValueError(f"cannot build a ChaosPlan from {type(value)}")
        return cls(value.get("seed", 0), value.get("faults"),
                   nonce=value.get("nonce", 0))


class _ArmedState:
    """Process-local armed plan + deterministic per-fault decision streams."""

    def __init__(self, plan: ChaosPlan, rev: int):
        self.plan = plan
        self.rev = rev
        self.hits: Dict[str, int] = {}        # per-site (status/debug)
        self.fault_hits: Dict[int, int] = {}  # per-fault, target-filtered
        self.fires: Dict[int, int] = {}
        # one seeded stream per fault: the Nth probability draw of fault i
        # is identical across arm() calls with the same plan — determinism
        self.rngs: Dict[int, random.Random] = {
            i: random.Random(f"{plan.seed}:{f['site']}:{i}")
            for i, f in enumerate(plan.faults)}
        # rpc.* fires have no GCS handle at the site (and a dropped GCS rpc
        # cannot report itself) — they buffer here and the host process's
        # maintenance loop (raylet heartbeat, worker raylet-watch) drains
        # them to the failure feed
        from collections import deque

        self.pending_events: "deque" = deque(maxlen=256)
        self.lock = threading.Lock()


_STATE: Optional[_ArmedState] = None


def arm(plan: Any, rev: int = 0) -> ChaosPlan:
    """Arm this process. ``plan`` is a ChaosPlan, dict, or JSON string.

    Distributed arms (rev > 0, from the GCS heartbeat sync or a raylet's
    worker forward) are idempotent whenever the PLAN is unchanged:
    re-arms of the same plan — several in-process raylets syncing one
    rev, a worker armed from its spawn env then re-armed by the
    worker_ready forward, a head restart re-announcing the persisted
    plan under a drifted rev — must not reset hit/fire counters (a
    kill-once plan would fire once per reset, breaking seeded
    determinism). Direct arms (rev == 0, tests/tools) always reset."""
    global _STATE
    p = ChaosPlan.from_value(plan)
    st = _STATE
    if (st is not None and rev > 0
            and st.plan.to_json() == p.to_json()):
        st.rev = rev
        return st.plan
    _STATE = _ArmedState(p, rev)
    return p


def disarm() -> None:
    global _STATE
    _STATE = None


def armed() -> bool:
    return _STATE is not None


def current_rev() -> int:
    st = _STATE
    return st.rev if st is not None else -1


def plan_json() -> Optional[str]:
    st = _STATE
    return st.plan.to_json() if st is not None else None


def status() -> Dict[str, Any]:
    """This process's armed state + hit/fire counters (rt chaos status)."""
    st = _STATE
    if st is None:
        return {"armed": False}
    with st.lock:
        fires: Dict[str, int] = {}
        for i, n in st.fires.items():  # sum per site: a plan may hold
            site = st.plan.faults[i]["site"]  # several faults on one site
            fires[site] = fires.get(site, 0) + n
        return {"armed": True, "rev": st.rev, "seed": st.plan.seed,
                "hits": dict(st.hits), "fires": fires}


def maybe_fire(site: str, target: Optional[str] = None
               ) -> Optional[Dict[str, Any]]:
    """The one hook every injection site calls. Unarmed: two loads and out.
    Armed: bump the site's hit counter and evaluate each matching fault
    deterministically; returns the fault spec on fire, else None. Never
    raises — chaos must not add failure modes of its own."""
    st = _STATE
    if st is None:
        return None
    try:
        with st.lock:
            st.hits[site] = st.hits.get(site, 0) + 1
            for i, f in enumerate(st.plan.faults):
                if f["site"] != site:
                    continue
                if f.get("target") and (target is None
                                        or f["target"] not in str(target)):
                    continue
                # at/after count THIS fault's target-matched hits — a
                # busy site (every rpc, every seal) doesn't skew the plan
                n = st.fault_hits.get(i, 0) + 1
                st.fault_hits[i] = n
                fired = st.fires.get(i, 0)
                if f.get("max_fires") is not None \
                        and fired >= int(f["max_fires"]):
                    continue
                if "at" in f:
                    if n != int(f["at"]):
                        continue
                elif "after" in f and n <= int(f["after"]):
                    continue
                if "prob" in f:
                    # draw even when at/after gated us in, so the stream
                    # index depends only on how often this check ran
                    if st.rngs[i].random() >= float(f["prob"]):
                        continue
                st.fires[i] = fired + 1
                _observe_injection(site)
                if site in ("rpc.delay", "rpc.drop"):
                    st.pending_events.append(
                        event_payload(site, f, target=target))
                return dict(f)
    except Exception:  # noqa: BLE001 — injection must never break the host
        return None
    return None


def drain_events() -> List[Dict[str, Any]]:
    """Pop buffered injection events (rpc.* sites) for shipping to the GCS
    failure store. Called from the raylet heartbeat loop and the worker's
    raylet-watch loop."""
    st = _STATE
    if st is None or not st.pending_events:
        return []
    out: List[Dict[str, Any]] = []
    with st.lock:
        while st.pending_events:
            out.append(st.pending_events.popleft())
    return out


def event_payload(site: str, fault: Dict[str, Any],
                  **fields: Any) -> Dict[str, Any]:
    """The FailureEvent wire dict an injection stamps into the GCS feed:
    categorized per site, tagged ``origin="chaos"`` so `rt errors` and
    `rt doctor` can tell injected failures from organic ones."""
    msg: Dict[str, Any] = {
        "category": SITE_CATEGORIES.get(site, "unknown"),
        "message": f"chaos: injected {site}",
        "origin": ORIGIN_CHAOS, "site": site, "t": time.time(),
    }
    if fault.get("target"):
        msg["message"] += f" (target {fault['target']!r})"
    msg.update({k: v for k, v in fields.items() if v is not None})
    return msg


# ---- Prometheus twin --------------------------------------------------------

_injections_counter = None


def _observe_injection(site: str) -> None:
    """``rt_chaos_injections_total{site=}``: one tick per fired fault in
    the firing process's registry. Never raises."""
    global _injections_counter
    try:
        from ray_tpu_torch.util import metrics as M

        if _injections_counter is None:
            _injections_counter = M.get_or_create(
                M.Counter, "rt_chaos_injections_total",
                "Chaos faults fired, by injection site",
                tag_keys=("site",))
        _injections_counter.inc(1.0, {"site": site})
    except Exception:  # noqa: BLE001
        pass
