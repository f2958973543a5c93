"""Engine flight recorder: per-tick phase attribution, request lifecycle
records, and SLO/goodput accounting for ``ContinuousEngine`` (the port's
own copy of ``ray_tpu/util/engine_recorder.py``: the same records, phases,
summaries and environment variables).

What one TICK record holds: a partition of the tick's wall into the
phases the loop actually runs (``models/serving.py`` stamps them):

  admission       slot bookkeeping around admitting pending requests
                  (queue pop, cancel checks, emit of the first token)
  kv_restore      prefix-cache lookup + the copy of the retained pages
                  into the slot (on ``cuda``: enqueued, see below)
  prefill         the prefill of the uncached suffix, to the first token
  decode_step     the fused ``step_many(k)`` tick across active slots
  token_delivery  handing each tick's token bursts to their consumers
  swap_barrier    applying a drain-barrier weight swap, when one landed

plus active-slot count, the decode bucket (lone row vs full engine), the
k-step fusion stride, and the decode TICK-GAP: the wall between
consecutive decode ticks while slots were active, the number that spikes
when a long-prompt prefill (or a KV capture) starves decode.

Every time here is the host's clock; no CUDA event is read. On ``cuda``
the port's engine launches asynchronously and syncs only where it reads
tokens back, so ``decode_step`` is the host wall of the tick INCLUDING
the device sync of its token read (the device time of the tick plus the
host's launch time where the host is slower), and ``prefill`` ends at the
read of the first token. ``kv_restore`` is the lookup plus enqueuing the
host-to-device copy of the pages, whose transfer then overlaps the
prefill's launches and is counted in ``prefill``.

What one REQUEST record holds: queue-wait, cached-vs-computed prefill
tokens (from the batcher's ``last_admission``), decode ticks, TTFT, TPOT,
and the terminal state (done / cancelled). A request submitted with a
serve context (``obs_ctx``) becomes a span under the serve span at drain.

Derived SLO/goodput accounting (``summary()``): rolling TTFT/TPOT
SLO-attainment ratios against configurable targets
(``RT_ENGINE_TTFT_SLO_MS`` / ``RT_ENGINE_TPOT_SLO_MS``), goodput tok/s
(tokens of SLO-attaining requests) vs the raw-capacity estimate
(``bucket × k`` tokens per decode tick), and occupancy-weighted decode
efficiency (tokens actually emitted / slot-tokens the ticks paid for).

The tick path ONLY appends to bounded in-process deques under a
microsecond lock; metric observations, spans, the ``@engine/`` snapshot
and timeline events go to the caller's :class:`Sinks` on the drain
thread (``util/recorder_core.py``). The JAX package pushes the same
things into its metrics registry, serve span buffer and GCS, which the
port does not import. The recorder times itself: ``overhead_s``
accumulates the wall spent inside recorder calls on the engine thread,
and ``summary()`` reports it as a fraction of recorded tick wall.

Disable with ``RT_ENGINE_RECORDER=0``: every hook then costs one
predicate check per tick.
"""

from __future__ import annotations

import os
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util.recorder_core import (RecorderCore, RecorderRegistry,
                                              Sinks, pct as _pct)

_ENABLED_DEFAULT = os.environ.get("RT_ENGINE_RECORDER", "1") \
    not in ("", "0", "false")
_CAP = int(os.environ.get("RT_ENGINE_RECORDER_CAP", "2048"))
_SLO_WINDOW = int(os.environ.get("RT_ENGINE_SLO_WINDOW", "256"))
_DRAIN_S = float(os.environ.get("RT_ENGINE_DRAIN_S", "2.0"))
_KV_PREFIX = "@engine/"

#: canonical tick-phase vocabulary, in tick-loop order (JAX's, so the
#: two packages' records read alike)
TICK_PHASES = ("admission", "kv_restore", "prefill", "decode_step",
               "token_delivery", "swap_barrier")

_REGISTRY = RecorderRegistry()


def live_recorders() -> List["EngineRecorder"]:
    """Every recorder constructed in this process and not yet closed."""
    return _REGISTRY.live()


class EngineRecorder(RecorderCore):
    """Bounded flight recorder for one ``ContinuousEngine``.

    The ENGINE THREAD is the only writer of tick records and the only
    caller of ``request_admitted`` / ``request_tokens``; ``request_done``
    may additionally fire from client threads (cancel). All shared state
    lives behind one lock held for O(1) appends — never across a device
    call, an RPC, or a metrics observation.
    """

    KV_PREFIX = _KV_PREFIX
    DRAIN_S = _DRAIN_S
    THREAD_NAME = "rtt-engine-rec"
    REGISTRY = _REGISTRY

    def __init__(self, name: str = "engine", *, max_slots: int = 8,
                 ttft_slo_s: Optional[float] = None,
                 tpot_slo_s: Optional[float] = None,
                 cap: int = _CAP, enabled: Optional[bool] = None,
                 sinks: Optional[Sinks] = None):
        self.name = name or "engine"
        self.max_slots = max(1, int(max_slots))
        self.enabled = _ENABLED_DEFAULT if enabled is None else bool(enabled)
        self.ttft_slo_s = float(
            os.environ.get("RT_ENGINE_TTFT_SLO_MS", "1500")) / 1e3 \
            if ttft_slo_s is None else float(ttft_slo_s)
        self.tpot_slo_s = float(
            os.environ.get("RT_ENGINE_TPOT_SLO_MS", "150")) / 1e3 \
            if tpot_slo_s is None else float(tpot_slo_s)
        cap = max(64, int(cap))
        self._init_core(self.name, sinks)
        self._ticks: "deque[Dict[str, Any]]" = deque(maxlen=cap)  # rt: guarded-by(_lock)
        self._active: "OrderedDict[int, Dict[str, Any]]" = \
            OrderedDict()  # rt: guarded-by(_lock)
        self._done: "deque[Dict[str, Any]]" = deque(maxlen=cap)  # rt: guarded-by(_lock)
        self._window: "deque[Dict[str, Any]]" = \
            deque(maxlen=_SLO_WINDOW)  # rt: guarded-by(_lock)
        self._tick_seq = 0  # rt: guarded-by(_lock)
        self._req_seq = 0  # rt: guarded-by(_lock)
        self._swaps = 0  # rt: guarded-by(_lock)
        self._last_swap: Optional[Dict[str, Any]] = None  # rt: guarded-by(_lock)
        self._requests_total = 0  # rt: guarded-by(_lock)
        self._cancelled_total = 0  # rt: guarded-by(_lock)
        # drain-side watermarks (drain thread only; the lock still guards
        # the snapshot reads that feed them)
        self._metrics_tick_wm = 0
        self._metrics_req_wm = 0
        self._span_req_wm = 0
        self._event_tick_wm = 0
        self._event_req_wm = 0

    # -- tick path (engine thread) ---------------------------------------

    def record_tick(self, *, t_start: float, wall_s: float,
                    phases: Dict[str, float], active: int, pending: int,
                    bucket: int, k: int, tokens: int, admitted: int,
                    gap_s: Optional[float]) -> None:
        """One engine tick: phase partition + the decode tick-gap. The
        ONLY thing this does is append to a bounded deque — no metrics,
        no I/O (drained off-thread)."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        rec = {"t": t_start, "wall_s": wall_s,
               "phases": {p: phases.get(p, 0.0) for p in TICK_PHASES
                          if phases.get(p, 0.0) > 0.0},
               "active": active, "pending": pending, "bucket": bucket,
               "k": k, "tokens": tokens, "admitted": admitted}
        if gap_s is not None:
            rec["gap_s"] = gap_s
        with self._lock:
            self._tick_seq += 1
            rec["seq"] = self._tick_seq
            self._ticks.append(rec)
            self._wall_total_s += wall_s
            self._overhead_s += time.perf_counter() - t0
        self._ensure_drainer()

    def request_admitted(self, rid: int, *, t_submit: float, t_admit: float,
                         prompt_tokens: int, cached_tokens: int,
                         prefill_s: float, kv_restore_s: float,
                         slot: int = -1,
                         obs_ctx: Optional[Dict[str, str]] = None) -> None:
        """Lifecycle start: admission produced the first token, so this
        stamp IS the TTFT stamp (queue_wait = admission - submit)."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        rec = {"rid": rid, "t_submit": t_submit, "t_admit": t_admit,
               "t_first": t_admit, "queue_wait_s": max(0.0,
                                                       t_admit - t_submit),
               "prompt_tokens": int(prompt_tokens),
               "cached_tokens": int(cached_tokens),
               "computed_tokens": int(prompt_tokens) - int(cached_tokens),
               "prefill_s": prefill_s, "kv_restore_s": kv_restore_s,
               "slot": slot, "tokens": 1, "decode_ticks": 0,
               "state": "active"}
        if obs_ctx:
            rec["request_id"] = obs_ctx.get("request_id")
            rec["parent_span_id"] = obs_ctx.get("span_id")
        with self._lock:
            self._requests_total += 1
            self._active[rid] = rec
            while len(self._active) > self._done.maxlen:
                self._active.popitem(last=False)  # runaway-leak backstop
            self._overhead_s += time.perf_counter() - t0

    def request_tokens(self, rid: int, n: int, t: float,
                       done: bool = False) -> None:
        """A decode tick delivered ``n`` tokens to request ``rid``."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        with self._lock:
            rec = self._active.get(rid)
            if rec is not None:
                rec["tokens"] += n
                rec["decode_ticks"] += 1
                rec["t_last"] = t
            self._overhead_s += time.perf_counter() - t0
        if done:
            self.request_done(rid, t=t, state="done")

    def request_done(self, rid: int, *, t: float,
                     state: str = "done") -> None:
        """Finalize a lifecycle record: compute TTFT/TPOT, move it to the
        done ring, and enter it into the rolling SLO window."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        with self._lock:
            rec = self._active.pop(rid, None)
            if rec is None:
                self._overhead_s += time.perf_counter() - t0
                return
            rec["state"] = state
            rec["t_done"] = t
            rec["ttft_s"] = max(0.0, rec["t_first"] - rec["t_submit"])
            n = rec["tokens"]
            rec["tpot_s"] = (max(0.0, t - rec["t_first"]) / (n - 1)
                             if n > 1 else 0.0)
            self._req_seq += 1
            rec["seq"] = self._req_seq
            self._done.append(rec)
            if state == "done":
                self._window.append({"t": t, "ttft_s": rec["ttft_s"],
                                     "tpot_s": rec["tpot_s"],
                                     "tokens": n,
                                     "decode_ticks": rec["decode_ticks"]})
            else:
                self._cancelled_total += 1
            self._overhead_s += time.perf_counter() - t0

    def record_swap(self, apply_s: float, drained_reqs: int = 0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._swaps += 1
            # the swap-barrier join: a weight-transfer record can read
            # this back (ship -> fetch -> barrier -> swap)
            self._last_swap = {"t": time.time(),
                               "apply_s": round(apply_s, 6),
                               "drained_reqs": int(drained_reqs)}

    def set_slo(self, *, ttft_slo_s: Optional[float] = None,
                tpot_slo_s: Optional[float] = None) -> None:
        """Retune the SLO targets; attainment is computed against the
        CURRENT targets at summary time, so this applies retroactively
        to the rolling window."""
        if ttft_slo_s is not None:
            self.ttft_slo_s = float(ttft_slo_s)
        if tpot_slo_s is not None:
            self.tpot_slo_s = float(tpot_slo_s)

    # -- derived accounting ----------------------------------------------

    def ticks(self, limit: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ticks)
        return out[-limit:] if limit else out

    def requests(self, limit: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._done)
        return out[-limit:] if limit else out

    def summary(self) -> Dict[str, Any]:
        """The rolling SLO/goodput picture: what the engine's ``stats()``
        and the gauges of the metric sink read."""
        with self._lock:
            ticks = list(self._ticks)
            window = list(self._window)
            active = len(self._active)
            base = {"requests_total": self._requests_total,
                    "cancelled_total": self._cancelled_total,
                    "swaps": self._swaps, "ticks_total": self._tick_seq}
            if self._last_swap is not None:
                base["last_swap"] = dict(self._last_swap)
        out = self._aggregate(ticks, window)
        out.update(base)
        out["name"] = self.name
        out["active"] = active
        out["max_slots"] = self.max_slots
        out["ttft_slo_s"] = self.ttft_slo_s
        out["tpot_slo_s"] = self.tpot_slo_s
        self._overhead_fields(out)
        return out

    def window_summary(self, t0: float, t1: float) -> Dict[str, Any]:
        """Same aggregates restricted to records stamped in [t0, t1): a
        run carves steady/burst/recovery windows with this."""
        with self._lock:
            ticks = [t for t in self._ticks if t0 <= t["t"] < t1]
            window = [{"t": r["t_done"], "ttft_s": r["ttft_s"],
                       "tpot_s": r["tpot_s"], "tokens": r["tokens"],
                       "decode_ticks": r["decode_ticks"]}
                      for r in self._done
                      if r["state"] == "done" and t0 <= r["t_done"] < t1]
        return self._aggregate(ticks, window)

    def _aggregate(self, ticks: List[Dict[str, Any]],
                   window: List[Dict[str, Any]]) -> Dict[str, Any]:
        phase_totals = {p: 0.0 for p in TICK_PHASES}
        wall = 0.0
        gaps: List[float] = []
        cap_tokens = 0
        tokens_emitted = 0
        occ_weighted = 0.0
        decode_wall = 0.0
        for t in ticks:
            wall += t["wall_s"]
            for p, v in t["phases"].items():
                phase_totals[p] = phase_totals.get(p, 0.0) + v
            if "gap_s" in t:
                gaps.append(t["gap_s"])
            d = t["phases"].get("decode_step", 0.0)
            if d > 0.0:
                # capacity this launch paid for: bucket rows × k fused
                # steps would emit bucket*k tokens at full occupancy
                cap_tokens += t["bucket"] * t["k"]
                decode_wall += d
                occ_weighted += d * (t["active"] / self.max_slots)
        tokens_emitted = sum(t["tokens"] for t in ticks)
        gaps.sort()
        phase_sum = sum(phase_totals.values())
        out: Dict[str, Any] = {
            "window_ticks": len(ticks),
            "tick_wall_s": round(wall, 6),
            "phase_s": {p: round(v, 6) for p, v in phase_totals.items()
                        if v > 0.0},
            "phase_sum_ratio": round(phase_sum / wall, 4) if wall > 0
            else 0.0,
            "tick_gap_p50_s": round(_pct(gaps, 0.50), 6),
            "tick_gap_p99_s": round(_pct(gaps, 0.99), 6),
            "tick_gap_max_s": round(gaps[-1], 6) if gaps else 0.0,
            # the "sustained" signal: the last few gaps, newest last (all
            # above a warn threshold = sustained starvation)
            "gap_recent": [round(t["gap_s"], 6) for t in ticks
                           if "gap_s" in t][-8:],
            "tokens": tokens_emitted,
            "decode_wall_s": round(decode_wall, 6),
            "decode_efficiency": round(tokens_emitted / cap_tokens, 4)
            if cap_tokens else 0.0,
            "occupancy": round(occ_weighted / decode_wall, 4)
            if decode_wall > 0 else 0.0,
            "capacity_tok_s": round(cap_tokens / decode_wall, 1)
            if decode_wall > 0 else 0.0,
        }
        n = len(window)
        out["window_completed"] = n
        if n:
            ttft_ok = sum(1 for w in window
                          if w["ttft_s"] <= self.ttft_slo_s)
            # single-token requests have no inter-token interval; they
            # trivially attain TPOT
            tpot_ok = sum(1 for w in window
                          if w["tpot_s"] <= self.tpot_slo_s)
            out["ttft_attainment"] = round(ttft_ok / n, 4)
            out["tpot_attainment"] = round(tpot_ok / n, 4)
            ttfts = sorted(w["ttft_s"] for w in window)
            tpots = sorted(w["tpot_s"] for w in window)
            out["ttft_p50_s"] = round(_pct(ttfts, 0.50), 6)
            out["ttft_p99_s"] = round(_pct(ttfts, 0.99), 6)
            out["tpot_p50_s"] = round(_pct(tpots, 0.50), 6)
            out["tpot_p99_s"] = round(_pct(tpots, 0.99), 6)
            span = max(w["t"] for w in window) - min(w["t"] for w in window)
            good = sum(w["tokens"] for w in window
                       if w["ttft_s"] <= self.ttft_slo_s
                       and w["tpot_s"] <= self.tpot_slo_s)
            total = sum(w["tokens"] for w in window)
            if span > 0:
                out["goodput_tok_s"] = round(good / span, 1)
                out["window_tok_s"] = round(total / span, 1)
            out["goodput_frac"] = round(good / total, 4) if total else 0.0
        return out

    def snapshot(self, ticks_limit: int = 64,
                 requests_limit: int = 64) -> Dict[str, Any]:
        """The ``@engine/`` KV payload: summary + record tails, compact
        enough to push every couple of seconds."""
        out = self._snapshot_header()
        out["summary"] = self.summary()
        out["ticks"] = [self._compact_tick(t)
                        for t in self.ticks(ticks_limit)]
        out["requests"] = [self._compact_req(r)
                           for r in self.requests(requests_limit)]
        return out

    @staticmethod
    def _compact_tick(t: Dict[str, Any]) -> Dict[str, Any]:
        out = {"seq": t["seq"], "t": round(t["t"], 4),
               "wall_ms": round(t["wall_s"] * 1e3, 3),
               "phases_ms": {p: round(v * 1e3, 3)
                             for p, v in t["phases"].items()},
               "active": t["active"], "pending": t["pending"],
               "bucket": t["bucket"], "k": t["k"], "tokens": t["tokens"],
               "admitted": t["admitted"]}
        if "gap_s" in t:
            out["gap_ms"] = round(t["gap_s"] * 1e3, 3)
        return out

    @staticmethod
    def _compact_req(r: Dict[str, Any]) -> Dict[str, Any]:
        out = {"rid": r["rid"], "state": r["state"],
               "queue_wait_ms": round(r["queue_wait_s"] * 1e3, 3),
               "prompt_tokens": r["prompt_tokens"],
               "cached_tokens": r["cached_tokens"],
               "computed_tokens": r["computed_tokens"],
               "tokens": r["tokens"], "decode_ticks": r["decode_ticks"],
               "slot": r["slot"]}
        if "ttft_s" in r:
            out["ttft_ms"] = round(r["ttft_s"] * 1e3, 3)
            out["tpot_ms"] = round(r["tpot_s"] * 1e3, 3)
        if r.get("request_id"):
            out["request_id"] = r["request_id"]
        return out

    # -- off-tick drain (template in recorder_core; hooks below) ----------

    def _pending_since(self, wm_attr: str, ticks: bool) -> List[Dict]:
        with self._lock:
            src = self._ticks if ticks else self._done
            wm = getattr(self, wm_attr)
            return [r for r in src if r.get("seq", 0) > wm]

    def _drain_metrics(self) -> int:
        emit = self.sinks.metric
        if emit is None:
            return 0
        tags = {"engine": self.name}
        new_ticks = self._pending_since("_metrics_tick_wm", ticks=True)
        for t in new_ticks:
            for p, v in t["phases"].items():
                emit(SERIES["phase"], "observe", v,
                     {"engine": self.name, "phase": p})
            if "gap_s" in t:
                emit(SERIES["gap"], "observe", t["gap_s"], tags)
            emit(SERIES["ticks"], "inc", 1.0, tags)
        new_reqs = self._pending_since("_metrics_req_wm", ticks=False)
        for r in new_reqs:
            emit(SERIES["requests"], "inc", 1.0,
                 {"engine": self.name, "state": r["state"]})
            if "ttft_s" in r and r["state"] == "done":
                emit(SERIES["ttft"], "observe", r["ttft_s"], tags)
                if r["tokens"] > 1:
                    emit(SERIES["tpot"], "observe", r["tpot_s"], tags)
        if new_ticks:
            self._metrics_tick_wm = new_ticks[-1]["seq"]
        if new_reqs:
            self._metrics_req_wm = new_reqs[-1]["seq"]
        summ = self.summary()
        if summ.get("window_completed"):
            emit(SERIES["slo"], "set", summ["ttft_attainment"],
                 {"engine": self.name, "slo": "ttft"})
            emit(SERIES["slo"], "set", summ["tpot_attainment"],
                 {"engine": self.name, "slo": "tpot"})
            emit(SERIES["goodput"], "set", summ.get("goodput_tok_s", 0.0),
                 tags)
        if summ.get("window_ticks"):
            emit(SERIES["eff"], "set", summ["decode_efficiency"], tags)
            emit(SERIES["overhead"], "set", summ["overhead_frac"], tags)
        return len(new_ticks) + len(new_reqs)

    def _drain_spans(self) -> int:
        """Completed requests with a serve context become children of
        their serve span, through the span sink."""
        emit_span = self.sinks.span
        if emit_span is None:
            return 0
        pending = self._pending_since("_span_req_wm", ticks=False)
        if not pending:
            return 0
        # advance past everything seen (context-less requests included) so
        # a later pass doesn't re-emit the same spans
        self._span_req_wm = pending[-1]["seq"]
        new_reqs = [r for r in pending if r.get("request_id")]
        if not new_reqs:
            return 0
        n = 0
        for r in new_reqs:
            try:
                span = uuid.uuid4().hex[:16]
                phases = {"queue_wait": r["queue_wait_s"],
                          "prefill": r["prefill_s"]}
                if r["kv_restore_s"] > 0:
                    phases["kv_restore"] = r["kv_restore_s"]
                if "t_done" in r:
                    phases["decode"] = max(0.0, r["t_done"] - r["t_first"])
                emit_span(
                    f"serve:{r['request_id']}:engine:{span[:8]}",
                    f"engine:{self.name}",
                    request_id=r["request_id"], span_id=span,
                    parent_span_id=r.get("parent_span_id"),
                    t_start=r["t_submit"],
                    t_end=r.get("t_done", r["t_first"]),
                    phases=phases,
                    state="FINISHED" if r["state"] == "done"
                    else "CANCELLED")
                n += 1
            except Exception:  # noqa: BLE001 — span plane best-effort
                pass
        return n

    def _build_events(self, node: str, pid: int):
        """Tick + request records as timeline task events; the advance
        closure runs only after the events sink returned."""
        events = []
        new_ticks = self._pending_since("_event_tick_wm", ticks=True)
        for t in new_ticks[-256:]:
            events.append({
                "task_id": f"engtick:{node}:{pid}:{self.name}:{t['seq']}",
                "name": f"tick:{self.name}", "state": "FINISHED",
                "node_id": node,
                "times": {"RUNNING": t["t"],
                          "FINISHED": t["t"] + t["wall_s"]},
                "engine_tick": {**t, "engine": self.name}})
        new_reqs = self._pending_since("_event_req_wm", ticks=False)
        for r in new_reqs[-256:]:
            events.append({
                "task_id": f"engreq:{node}:{pid}:{self.name}:{r['seq']}",
                "name": f"req:{r['rid']}", "state": "FINISHED",
                "node_id": node,
                "times": {"RUNNING": r["t_submit"],
                          "FINISHED": r.get("t_done", r["t_first"])},
                "engine_request": {**{k: v for k, v in r.items()
                                      if not k.startswith("parent_")},
                                   "engine": self.name}})

        def advance() -> None:
            if new_ticks:
                self._event_tick_wm = new_ticks[-1]["seq"]
            if new_reqs:
                self._event_req_wm = new_reqs[-1]["seq"]

        return events, advance


#: the metric series the drain observes, by role; the names and the
#: meaning of each are the JAX package's ``rt_engine_*`` series
SERIES = {
    "phase": "rt_engine_tick_phase_seconds",
    "gap": "rt_engine_tick_gap_seconds",
    "ticks": "rt_engine_ticks_total",
    "requests": "rt_engine_requests_total",
    "ttft": "rt_engine_ttft_seconds",
    "tpot": "rt_engine_tpot_seconds",
    "slo": "rt_engine_slo_attainment",
    "goodput": "rt_engine_goodput_tokens_per_s",
    "eff": "rt_engine_decode_efficiency",
    "overhead": "rt_engine_recorder_overhead_ratio",
}
