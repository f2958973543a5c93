"""RLHF dataflow flight recorder: per-role bubble attribution,
weight-plane transfer receipts, and staleness accounting for
``RLHFPipeline`` (the port's own copy of
``ray_tpu/util/pipeline_recorder.py``: the same records, derived fields,
summaries and environment variables).

What one ITERATION record holds:

  intervals   per-role phase intervals stamped inside each role's method
              (generate / score_ref / score_reward / update / ship /
              sync_swap), joined to the driver's record
  driver_s    the driver-observed wall per driver phase (generate /
              score / update / ship / sync_swap)
  tax_s       orchestration tax per phase: driver wall minus role wall
  bubble      role-seconds idle while ANY other role works / total
              role-seconds over the busy span (interval sweep)
  staleness   learner weights-version minus the version the generate
              batch decoded under (strict phases measure 0)
  receipt     the joined weight transfer record: ship -> swap in one dict
              (bytes, leaves, transport, drain-barrier wall, swap apply
              wall)

The driver path ONLY appends to bounded in-process deques under a
microsecond lock; metric observations, the ``@rlhf/`` snapshot and the
timeline events go to the caller's :class:`Sinks` on the drain thread
(``util/recorder_core.py``), where the JAX package pushes the same into
its metrics registry and GCS. The recorder times itself: ``overhead_s``
accumulates wall spent inside recorder calls and ``summary()`` reports it
as a fraction of recorded iteration wall.

Disable with ``RT_RLHF_RECORDER=0``: every hook then costs one predicate
check per iteration.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util.recorder_core import (RecorderCore, RecorderRegistry,
                                              Sinks, pct as _pct)

_ENABLED_DEFAULT = os.environ.get("RT_RLHF_RECORDER", "1") \
    not in ("", "0", "false")
_CAP = int(os.environ.get("RT_RLHF_RECORDER_CAP", "1024"))
_DRAIN_S = float(os.environ.get("RT_RLHF_DRAIN_S", "2.0"))
_KV_PREFIX = "@rlhf/"

#: canonical actor-side phase vocabulary, in strict-phase order (the
#: JAX package's timeline lanes render phases in this order)
PIPE_PHASES = ("generate", "score_ref", "score_reward", "update",
               "ship", "sync_swap")

#: which role executes each phase (one lane per role in the timeline)
PHASE_ROLE = {"generate": "generator", "score_ref": "reference",
              "score_reward": "reward", "update": "learner",
              "ship": "learner", "sync_swap": "generator"}

#: the driver's phase vocabulary and which actor phases each one covers
#: (the driver's "score" wall spans BOTH parallel scoring roles, so its
#: orchestration tax is measured against their union span)
DRIVER_PHASES = ("generate", "score", "update", "ship", "sync_swap")
DRIVER_PHASE_ACTORS = {"generate": ("generate",),
                       "score": ("score_ref", "score_reward"),
                       "update": ("update",),
                       "ship": ("ship",),
                       "sync_swap": ("sync_swap",)}

ROLES = ("generator", "reference", "reward", "learner")

_REGISTRY = RecorderRegistry()


def live_recorders() -> List["PipelineRecorder"]:
    """Every recorder constructed in this process and not yet closed."""
    return _REGISTRY.live()


def bubble_attribution(intervals: List[Dict[str, Any]],
                       roles: Optional[List[str]] = None) -> Dict[str, Any]:
    """Interval-sweep bubble accounting over one iteration's role
    intervals (``{"role", "phase", "t0", "t1"}`` each).

    Over every elementary segment where AT LEAST one role is busy, a
    role not busy in that segment contributes idle role-seconds — the
    pipeline bubble. ``bubble_fraction`` = idle role-seconds ÷ total
    role-seconds over the busy span. A perfectly overlapped pipeline
    scores 0.0; a 4-role strict-phase pipeline whose score phase runs
    two roles concurrently lands around 0.7.
    """
    role_list = list(roles) if roles else sorted(
        {iv["role"] for iv in intervals}) or list(ROLES)
    n_roles = max(1, len(role_list))
    by_role: Dict[str, List] = {r: [] for r in role_list}
    points: List[float] = []
    for iv in intervals:
        t0, t1 = float(iv["t0"]), float(iv["t1"])
        if t1 <= t0 or iv["role"] not in by_role:
            continue
        by_role[iv["role"]].append((t0, t1))
        points.append(t0)
        points.append(t1)
    points = sorted(set(points))
    busy_s = {r: 0.0 for r in role_list}
    idle_s = {r: 0.0 for r in role_list}
    span_busy = 0.0
    bubble = 0.0
    for a, b in zip(points, points[1:]):
        seg = b - a
        if seg <= 0:
            continue
        busy = [r for r in role_list
                if any(t0 <= a and b <= t1 for t0, t1 in by_role[r])]
        if not busy:
            continue
        span_busy += seg
        for r in role_list:
            if r in busy:
                busy_s[r] += seg
            else:
                idle_s[r] += seg
                bubble += seg
    total_role_s = n_roles * span_busy
    return {
        "bubble_fraction": round(bubble / total_role_s, 4)
        if total_role_s > 0 else 0.0,
        "bubble_role_s": round(bubble, 6),
        "total_role_s": round(total_role_s, 6),
        "span_busy_s": round(span_busy, 6),
        "role_busy_s": {r: round(v, 6) for r, v in busy_s.items()},
        "role_idle_s": {r: round(v, 6) for r, v in idle_s.items()},
    }


class PipelineRecorder(RecorderCore):
    """Bounded flight recorder for one ``RLHFPipeline``.

    The DRIVER THREAD is the only writer (`record_iteration` /
    `record_interrupt` fire from `run_iteration`); the drain thread only
    reads. All shared state lives behind one lock held for O(1) appends
    plus a ~10-interval sweep — never across an RPC or a metrics
    observation.
    """

    KV_PREFIX = _KV_PREFIX
    DRAIN_S = _DRAIN_S
    THREAD_NAME = "rtt-rlhf-rec"
    REGISTRY = _REGISTRY

    def __init__(self, name: str = "rlhf", *, cap: int = _CAP,
                 enabled: Optional[bool] = None,
                 sinks: Optional[Sinks] = None):
        self.name = name or "rlhf"
        self.enabled = _ENABLED_DEFAULT if enabled is None else bool(enabled)
        cap = max(64, int(cap))
        self._init_core(self.name, sinks)
        self._iters: "deque[Dict[str, Any]]" = deque(maxlen=cap)  # rt: guarded-by(_lock)
        self._seq = 0  # rt: guarded-by(_lock)
        self._interrupted_total = 0  # rt: guarded-by(_lock)
        self._last_interrupt_t: Optional[float] = None  # rt: guarded-by(_lock)
        # drain-side watermarks (drain thread only; the lock still guards
        # the snapshot reads that feed them)
        self._metrics_wm = 0
        self._event_wm = 0

    # -- driver path -------------------------------------------------------

    def record_iteration(self, *, iteration: int, t0: float, wall_s: float,
                         intervals: List[Dict[str, Any]],
                         driver_s: Dict[str, float],
                         tokens: int = 0,
                         learner_version: int = 0,
                         decoded_version: int = 0,
                         receipt: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        """One completed pipeline iteration: the driver's record joined
        with the actor-side intervals every role stamped. Appends to a
        bounded deque plus one O(k log k) sweep over ~10 intervals — no
        metrics, no I/O (drained off-thread). Returns the derived fields
        (bubble / coverage / tax / staleness) so the driver can surface
        them in its own result dict without recomputing."""
        if not self.enabled:
            return {}
        t_in = time.perf_counter()
        actor_s = {p: 0.0 for p in PIPE_PHASES}
        for iv in intervals:
            w = iv.get("wall_s")
            if w is None:
                w = max(0.0, float(iv["t1"]) - float(iv["t0"]))
            actor_s[iv["phase"]] = actor_s.get(iv["phase"], 0.0) + float(w)
        tax_s: Dict[str, float] = {}
        for p, dv in driver_s.items():
            sub = [iv for iv in intervals
                   if iv["phase"] in DRIVER_PHASE_ACTORS.get(p, (p,))]
            span = max(float(iv["t1"]) for iv in sub) \
                - min(float(iv["t0"]) for iv in sub) if sub else 0.0
            tax_s[p] = round(max(0.0, float(dv) - span), 6)
        bub = bubble_attribution(intervals, roles=list(ROLES))
        coverage = round(bub["span_busy_s"] / wall_s, 4) if wall_s > 0 \
            else 0.0
        staleness = max(0, int(learner_version) - int(decoded_version))
        rec = {"t": t0, "t1": t0 + wall_s, "wall_s": round(wall_s, 6),
               "state": "ok", "iteration": int(iteration),
               "tokens": int(tokens),
               "learner_version": int(learner_version),
               "decoded_version": int(decoded_version),
               "staleness": staleness,
               "intervals": [{"role": iv["role"], "phase": iv["phase"],
                              "t0": float(iv["t0"]), "t1": float(iv["t1"])}
                             for iv in intervals],
               "actor_s": {p: round(v, 6) for p, v in actor_s.items()
                           if v > 0.0},
               "driver_s": {p: round(float(v), 6)
                            for p, v in driver_s.items()},
               "tax_s": tax_s,
               "bubble_fraction": bub["bubble_fraction"],
               "coverage": coverage,
               "role_busy_s": bub["role_busy_s"],
               "role_idle_s": bub["role_idle_s"],
               "span_busy_s": bub["span_busy_s"]}
        if receipt:
            rec["receipt"] = dict(receipt)
        with self._lock:
            if self._last_interrupt_t is not None:
                rec["restart_gap_s"] = round(
                    max(0.0, t0 - self._last_interrupt_t), 6)
                self._last_interrupt_t = None
            self._seq += 1
            rec["seq"] = self._seq
            self._iters.append(rec)
            self._wall_total_s += wall_s
            self._overhead_s += time.perf_counter() - t_in
        self._ensure_drainer()
        return {"bubble_fraction": rec["bubble_fraction"],
                "coverage": coverage, "staleness": staleness,
                "tax_s": tax_s,
                "restart_gap_s": rec.get("restart_gap_s")}

    def record_interrupt(self, *, phase: str, t: float,
                         error: str = "") -> None:
        """An iteration died mid-phase (chaos kill, actor crash): stamp
        the interrupted phase so the postmortem snapshot names where the
        pipeline stopped. The next successful iteration stamps its
        ``restart_gap_s`` against this timestamp."""
        if not self.enabled:
            return
        t_in = time.perf_counter()
        rec = {"t": t, "state": "interrupted", "phase": phase,
               "error": str(error)[:200]}
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._iters.append(rec)
            self._interrupted_total += 1
            self._last_interrupt_t = t
            self._overhead_s += time.perf_counter() - t_in
        self._ensure_drainer()

    # -- derived accounting ------------------------------------------------

    def iterations(self, limit: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._iters)
        return out[-limit:] if limit else out

    def summary(self) -> Dict[str, Any]:
        """The strict-phase waste picture: what the gauges read (JAX's
        ``rt rlhf stats`` and doctor read the same summary)."""
        with self._lock:
            recs = list(self._iters)
            interrupted = self._interrupted_total
            total = self._seq
        ok = [r for r in recs if r["state"] == "ok"]
        out: Dict[str, Any] = {"name": self.name,
                               "iterations_total": total,
                               "interrupted_total": interrupted,
                               "window_iterations": len(ok)}
        actor_tot = {p: 0.0 for p in PIPE_PHASES}
        driver_tot: Dict[str, float] = {}
        tax_tot: Dict[str, float] = {}
        busy_tot = {r: 0.0 for r in ROLES}
        idle_tot = {r: 0.0 for r in ROLES}
        span_tot = 0.0
        bubbles: List[float] = []
        coverages: List[float] = []
        stalenesses: List[int] = []
        gaps: List[float] = []
        tokens = 0
        receipt_last = None
        for r in ok:
            for p, v in r["actor_s"].items():
                actor_tot[p] = actor_tot.get(p, 0.0) + v
            for p, v in r["driver_s"].items():
                driver_tot[p] = driver_tot.get(p, 0.0) + v
            for p, v in r["tax_s"].items():
                tax_tot[p] = tax_tot.get(p, 0.0) + v
            for role, v in r["role_busy_s"].items():
                busy_tot[role] = busy_tot.get(role, 0.0) + v
            for role, v in r["role_idle_s"].items():
                idle_tot[role] = idle_tot.get(role, 0.0) + v
            span_tot += r["span_busy_s"]
            bubbles.append(r["bubble_fraction"])
            coverages.append(r["coverage"])
            stalenesses.append(r["staleness"])
            tokens += r["tokens"]
            if "restart_gap_s" in r:
                gaps.append(r["restart_gap_s"])
            if "receipt" in r:
                receipt_last = r["receipt"]
        out["tokens"] = tokens
        out["actor_s"] = {p: round(v, 6) for p, v in actor_tot.items()
                          if v > 0.0}
        out["driver_s"] = {p: round(v, 6) for p, v in driver_tot.items()}
        out["tax_s"] = {p: round(v, 6) for p, v in tax_tot.items()}
        if span_tot > 0:
            out["role_busy_frac"] = {r: round(busy_tot[r] / span_tot, 4)
                                     for r in busy_tot}
            out["role_idle_frac"] = {r: round(idle_tot[r] / span_tot, 4)
                                     for r in idle_tot}
        if ok:
            out["bubble_fraction"] = round(sum(bubbles) / len(bubbles), 4)
            out["bubble_last"] = bubbles[-1]
            # the "sustained" signal: the last few per-iteration
            # bubble fractions, newest last
            out["bubble_recent"] = bubbles[-8:]
            out["coverage"] = round(sum(coverages) / len(coverages), 4)
            srt = sorted(stalenesses)
            out["staleness"] = {"last": stalenesses[-1],
                                "p50": _pct(srt, 0.50),
                                "p99": _pct(srt, 0.99),
                                "max": srt[-1]}
        if gaps:
            out["restart_gaps_s"] = [round(g, 4) for g in gaps[-4:]]
        if receipt_last:
            out["receipt_last"] = receipt_last
        last_int = [r for r in recs if r["state"] == "interrupted"]
        if last_int:
            out["interrupted_last"] = {"phase": last_int[-1]["phase"],
                                       "t": last_int[-1]["t"],
                                       "error": last_int[-1]["error"]}
        self._overhead_fields(out)
        return out

    def snapshot(self, iters_limit: int = 32) -> Dict[str, Any]:
        """The ``@rlhf/`` KV payload: summary + iteration-record tail,
        compact enough to push every couple of seconds."""
        out = self._snapshot_header()
        out["summary"] = self.summary()
        out["iterations"] = [self._compact_iter(r)
                             for r in self.iterations(iters_limit)]
        return out

    @staticmethod
    def _compact_iter(r: Dict[str, Any]) -> Dict[str, Any]:
        if r["state"] == "interrupted":
            return {"seq": r["seq"], "t": round(r["t"], 4),
                    "state": "interrupted", "phase": r["phase"],
                    "error": r["error"]}
        out = {"seq": r["seq"], "t": round(r["t"], 4),
               "state": "ok", "iteration": r["iteration"],
               "wall_ms": round(r["wall_s"] * 1e3, 3),
               "bubble_fraction": r["bubble_fraction"],
               "coverage": r["coverage"], "staleness": r["staleness"],
               "tokens": r["tokens"],
               "actor_ms": {p: round(v * 1e3, 3)
                            for p, v in r["actor_s"].items()},
               "tax_ms": {p: round(v * 1e3, 3)
                          for p, v in r["tax_s"].items()}}
        if "restart_gap_s" in r:
            out["restart_gap_s"] = r["restart_gap_s"]
        if "receipt" in r:
            out["receipt"] = r["receipt"]
        return out

    # -- off-driver drain (template in recorder_core; hooks below) ---------

    def _pending_since(self, wm_attr: str) -> List[Dict]:
        with self._lock:
            wm = getattr(self, wm_attr)
            return [r for r in self._iters if r.get("seq", 0) > wm]

    def _drain_metrics(self) -> int:
        emit = self.sinks.metric
        if emit is None:
            return 0
        tags = {"pipeline": self.name}
        new = self._pending_since("_metrics_wm")
        for r in new:
            if r["state"] != "ok":
                continue
            for p, v in r["tax_s"].items():
                emit(SERIES["tax"], "observe", v,
                     {"pipeline": self.name, "phase": p})
            emit(SERIES["staleness"], "observe", float(r["staleness"]),
                 tags)
            rcpt = r.get("receipt") or {}
            for stage, key in (("pump", "pump_wall_s"),
                               ("fetch", "fetch_wall_s"),
                               ("barrier", "barrier_drain_s"),
                               ("swap", "swap_apply_s")):
                v = rcpt.get(key)
                if v is not None:
                    emit(SERIES["transfer"], "observe", float(v),
                         {"pipeline": self.name, "stage": stage})
        if new:
            self._metrics_wm = new[-1]["seq"]
        summ = self.summary()
        if summ.get("window_iterations"):
            emit(SERIES["bubble"], "set", summ["bubble_last"], tags)
            for role, v in summ.get("role_idle_frac", {}).items():
                emit(SERIES["idle"], "set", v,
                     {"pipeline": self.name, "role": role})
            emit(SERIES["overhead"], "set", summ["overhead_frac"], tags)
        return len(new)

    def _build_events(self, node: str, pid: int):
        """Iteration records as timeline task events; the advance closure
        runs only after the events sink returned."""
        events = []
        new = self._pending_since("_event_wm")
        for r in new[-128:]:
            if r["state"] == "interrupted":
                events.append({
                    "task_id": f"rlhfit:{node}:{pid}:{self.name}:"
                               f"{r['seq']}",
                    "name": f"rlhf:{self.name}:interrupt",
                    "state": "FAILED", "node_id": node,
                    "times": {"RUNNING": r["t"], "FAILED": r["t"]},
                    "rlhf_iter": {**r, "pipeline": self.name}})
                continue
            events.append({
                "task_id": f"rlhfit:{node}:{pid}:{self.name}:{r['seq']}",
                "name": f"rlhf:{self.name}:iter{r['iteration']}",
                "state": "FINISHED", "node_id": node,
                "times": {"RUNNING": r["t"], "FINISHED": r["t1"]},
                "rlhf_iter": {**{k: v for k, v in r.items()
                                 if k not in ("role_busy_s",
                                              "role_idle_s")},
                              "pipeline": self.name}})

        def advance() -> None:
            if new:
                self._event_wm = new[-1]["seq"]

        return events, advance


#: the metric series the drain observes, by role; the names and the
#: meaning of each are the JAX package's ``rt_rlhf_*`` recorder series
SERIES = {
    "bubble": "rt_rlhf_bubble_fraction",
    "idle": "rt_rlhf_role_idle_fraction",
    "tax": "rt_rlhf_orchestration_tax_seconds",
    "staleness": "rt_rlhf_staleness_versions",
    "transfer": "rt_rlhf_transfer_seconds",
    "overhead": "rt_rlhf_recorder_overhead_ratio",
}
