"""Training flight recorder: per-launch phase attribution,
data-starvation accounting, and the MFU-gap waterfall for ``StepDriver``
(the port's own copy of ``ray_tpu/util/train_recorder.py``: the same
records, phases, summaries and environment variables).

The STEP-DRIVER THREAD stamps one bounded record per fused-K launch, a
watcher thread turns the launch's CUDA event into an async device-done
stamp, and the drain substrate (``util/recorder_core.py``) hands
``@train/`` snapshots, ``rt_train_*`` observations and timeline launch
events to the caller's :class:`Sinks` off the step path.

What one LAUNCH record holds: a partition of the launch's wall (first
batch fetch to device done) into the phases the loop actually runs:

  data_wait        host wall blocked in ``next(it)`` + the K-batch stack
                   (the loader's share of the gap)
  h2d              the batch's move onto the device
  dispatch         host wall inside the step call (enqueuing the K steps'
                   kernels: the per-launch cost fused-K amortizes)
  device_compute   dispatch-return to device-done, measured by an ASYNC
                   done-hook: ``watch_outputs`` records a CUDA event on
                   the launch's stream right after the launch, and a
                   watcher thread waits for that event. Never a
                   synchronize on the step path; never
                   ``torch.cuda.synchronize()`` in the watcher either
                   (it would also wait for the NEXT launch and book its
                   time as this one's)
  host_tax         ``on_launch`` callback wall merged in late (report
                   handoff + checkpoint snapshot)
  compile          a program's first call (booked instead of dispatch,
                   step-profiler convention)

plus K, tokens, the [K, B, S] batch shape, analytic FLOPs from
``util/flops.py``, and the LAUNCH-GAP: launch N's dispatch start minus
launch N-1's device-done while a stacked batch was already available.
When the loader was genuinely dry (the batch became ready only after the
previous launch finished) the gap is NOT stamped and ``dry_resets``
counts the reset, so starvation is never blamed on the devices.

Joining launches to analytic FLOPs yields the marginal-MFU series and
the MFU-GAP WATERFALL at summary time: ``raw_mfu`` (FLOPs over
device-busy seconds) down to ``achieved_mfu`` (FLOPs over the window's
wall), the difference attributed bucket by bucket to data_wait /
launch_gap / host_tax / compile (scaled onto the measured lost wall, with
an ``uncovered`` residual). ``window_summary(t0, t1)`` carves legs out of
one run.

The step path ONLY appends to bounded deques under a microsecond lock and
enqueues the done-hook; metric observations, snapshots and timeline
events happen on the drain thread. The recorder times itself;
``summary()`` reports overhead as a fraction of recorded launch wall.

Disable with ``RT_TRAIN_RECORDER=0``: every hook then costs one
predicate check per launch.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.util import step_profiler
from ray_tpu_torch.util.recorder_core import (RecorderCore, RecorderRegistry,
                                              Sinks, pct as _pct)
from ray_tpu_torch.util.step_profiler import first_cuda_tensor

_ENABLED_DEFAULT = os.environ.get("RT_TRAIN_RECORDER", "1") \
    not in ("", "0", "false")
_CAP = int(os.environ.get("RT_TRAIN_RECORDER_CAP", "2048"))
_DRAIN_S = float(os.environ.get("RT_TRAIN_DRAIN_S", "2.0"))
_KV_PREFIX = "@train/"

#: canonical launch-phase vocabulary, in launch order (JAX's, so the two
#: packages' records read alike)
LAUNCH_PHASES = ("data_wait", "h2d", "dispatch", "device_compute",
                 "host_tax", "compile")

#: the waterfall's loss buckets, in render order (device_compute and
#: dispatch are the device-busy numerator, not losses)
WATERFALL_BUCKETS = ("data_wait", "launch_gap", "host_tax", "compile")

_REGISTRY = RecorderRegistry()


def live_recorders() -> List["TrainRecorder"]:
    """Every recorder constructed in this process and not yet closed."""
    return _REGISTRY.live()


def _profiler_launch_join() -> Optional[Dict[str, int]]:
    """The step-profiler's registered launch source: launch/step counts
    from THIS instrumentation point, so the profiler's train summary and
    the recorder's can never drift apart. Returns None when no
    fused launch has been recorded (the profiler falls back to its own
    records)."""
    launches = steps = 0
    for r in live_recorders():
        with r._lock:
            launches += r._launches_total
            steps += r._steps_total
    if launches == 0:
        return None
    return {"launches": launches, "steps": steps}


class TrainRecorder(RecorderCore):
    """Bounded flight recorder for one ``StepDriver``.

    The STEP-DRIVER THREAD is the only caller of ``record_launch`` /
    ``add_host_tax`` / ``watch_outputs``; ``finalize_launch`` fires from
    the watcher thread (or directly from tests feeding synthetic
    records). All shared state lives behind one lock held for O(1)
    appends — never across a device call, an RPC, or a metrics
    observation.
    """

    KV_PREFIX = _KV_PREFIX
    DRAIN_S = _DRAIN_S
    THREAD_NAME = "rt-train-rec"
    REGISTRY = _REGISTRY

    def __init__(self, name: str = "train", *, cap: int = _CAP,
                 n_devices: int = 0, peak_flops: Optional[float] = None,
                 enabled: Optional[bool] = None,
                 sinks: Optional[Sinks] = None):
        self.name = name or "train"
        self.enabled = _ENABLED_DEFAULT if enabled is None else bool(enabled)
        # 0 = one device: the port's step runs on one until the mesh is
        # ported
        self.n_devices = int(n_devices)
        self.peak_flops = peak_flops     # None = the H100's bf16 peak
        cap = max(64, int(cap))
        self._launches: "deque[Dict[str, Any]]" = deque(maxlen=cap)  # rt: guarded-by(_lock)
        self._open: Dict[int, Dict[str, Any]] = {}  # rt: guarded-by(_lock)
        self._seq = 0  # rt: guarded-by(_lock)
        self._launches_total = 0  # rt: guarded-by(_lock)
        self._steps_total = 0  # rt: guarded-by(_lock)
        self._prev_done_t: Optional[float] = None  # rt: guarded-by(_lock)
        self._dry_resets = 0  # rt: guarded-by(_lock)
        self._compiles = 0  # rt: guarded-by(_lock)
        self._peak_total_cached: Optional[float] = None
        # done-hook plumbing: the step path enqueues a CUDA event, one
        # watcher thread waits for the events FIFO (launch order), so
        # finalize order is monotone and _prev_done_t never runs backwards
        self._watch_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._watcher: Optional[threading.Thread] = None  # rt: guarded-by(_lock)
        # drain-side watermarks (drain thread only)
        self._metrics_wm = 0
        self._event_wm = 0
        self._init_core(self.name, sinks)   # registers it: fields first
        step_profiler.register_launch_source("train", _profiler_launch_join)

    # -- step path (driver thread) -----------------------------------------

    def record_launch(self, *, t_start: float, data_wait_s: float,
                      h2d_s: float, dispatch_s: float,
                      compile_s: float = 0.0,
                      data_ready_t: Optional[float] = None,
                      t_dispatch_end: Optional[float] = None,
                      k: int = 1, tokens: int = 0,
                      batch_shape: Tuple[int, ...] = (),
                      flops: float = 0.0) -> int:
        """One fused-K launch, stamped right after the compiled call
        returned (the device is still computing — ``watch_outputs``
        finishes the record). Appends to a bounded deque, decides the
        launch-gap, nothing else. Returns the record's seq for the
        done-hook and the host-tax merge.

        ``t_dispatch_end`` is the epoch stamp of the dispatch call's
        RETURN — pass it when you have it (the driver does): deriving it
        from the phase sums undercounts untimed loop wall and that error
        lands in device_compute."""
        if not self.enabled:
            return 0
        t_in = time.perf_counter()
        t_dispatch_start = t_start + data_wait_s + h2d_s
        if t_dispatch_end is None:
            t_dispatch_end = t_dispatch_start + dispatch_s \
                + max(0.0, compile_s)
        rec = {"t": t_start, "k": int(k), "tokens": int(tokens),
               "batch_shape": list(batch_shape),
               "flops": float(flops),
               "phases": {"data_wait": max(0.0, data_wait_s),
                          "h2d": max(0.0, h2d_s),
                          "dispatch": max(0.0, dispatch_s),
                          "host_tax": 0.0,
                          "compile": max(0.0, compile_s)},
               "t_dispatch_end": t_dispatch_end}
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._launches_total += 1
            self._steps_total += max(1, int(k))
            if compile_s > 0.0:
                self._compiles += 1
            prev_done = self._prev_done_t
            if prev_done is not None:
                if data_ready_t is not None and data_ready_t > prev_done:
                    # loader genuinely dry: the stacked batch only became
                    # ready after the devices went idle — that wall is
                    # data_wait's to answer for, not a launch gap
                    self._dry_resets += 1
                else:
                    rec["gap_s"] = max(0.0, t_dispatch_start - prev_done)
            self._launches.append(rec)
            self._open[rec["seq"]] = rec
            while len(self._open) > self._launches.maxlen:
                self._open.pop(next(iter(self._open)))  # leak backstop
            self._overhead_s += time.perf_counter() - t_in
        return rec["seq"]

    def watch_outputs(self, seq: int, outputs: Any) -> None:
        """The async done-hook: record a CUDA event on the stream of the
        launch's outputs (the metrics tree) right after the launch, and
        hand it to the watcher thread, which waits for it off the step
        path and stamps device-done. Outputs on the CPU are done already
        (no event). The step path pays one event record and one queue
        put."""
        if not self.enabled or seq <= 0:
            return
        t_in = time.perf_counter()
        done = None
        out = first_cuda_tensor(outputs)
        if out is not None:
            done = (torch.cuda.Event(), out.device)
            done[0].record(torch.cuda.current_stream(out.device))
        self._watch_q.put((seq, done))
        with self._lock:
            self._overhead_s += time.perf_counter() - t_in
        self._ensure_watcher()
        self._ensure_drainer()

    def add_host_tax(self, seq: int, host_tax_s: float) -> None:
        """Merge the ``on_launch`` callback wall (report drain handoff +
        checkpoint fence) into an already-stamped record — the callback
        runs after the dispatch returned, so the tax arrives late."""
        if not self.enabled or seq <= 0:
            return
        t_in = time.perf_counter()
        with self._lock:
            rec = self._open.get(seq)
            if rec is None:
                for r in reversed(self._launches):
                    if r["seq"] == seq:
                        rec = r
                        break
            if rec is not None:
                rec["phases"]["host_tax"] += max(0.0, host_tax_s)
            self._overhead_s += time.perf_counter() - t_in

    def finalize_launch(self, seq: int, t_done: float) -> None:
        """Device-done: close the record — compute ``device_compute``
        (done minus dispatch-return) and the launch wall. Fired by the
        watcher thread; synthetic tests call it directly."""
        if not self.enabled:
            return
        t_in = time.perf_counter()
        with self._lock:
            rec = self._open.pop(seq, None)
            if rec is None:
                self._overhead_s += time.perf_counter() - t_in
                return
            rec["t_done"] = t_done
            rec["phases"]["device_compute"] = \
                max(0.0, t_done - rec["t_dispatch_end"])
            rec["wall_s"] = max(0.0, t_done - rec["t"])
            self._wall_total_s += rec["wall_s"]
            if self._prev_done_t is None or t_done > self._prev_done_t:
                self._prev_done_t = t_done
            self._overhead_s += time.perf_counter() - t_in

    def loader_dry(self) -> None:
        """Explicit dry-reset hook for loops that can see the iterator
        exhaust (epoch boundary): the next launch must not stamp a gap
        against a device that idled waiting for data."""
        if not self.enabled:
            return
        with self._lock:
            self._prev_done_t = None
            self._dry_resets += 1

    # -- watcher thread ----------------------------------------------------

    def _ensure_watcher(self) -> None:
        if self._watcher is not None and self._watcher.is_alive():
            return
        with self._lock:
            if self._closed or (self._watcher is not None
                                and self._watcher.is_alive()):
                return
            self._watcher = threading.Thread(
                target=self._watch_loop, daemon=True,
                name=f"rt-train-watch:{self.name}")
            self._watcher.start()

    def _watch_loop(self) -> None:
        while True:
            item = self._watch_q.get()
            if item is None:
                return
            seq, done = item
            try:
                self._block_on(done)
            except Exception:  # noqa: BLE001 — a failed wait still gets
                pass           # a done stamp (device_compute ~ 0)
            self.finalize_launch(seq, time.time())

    @staticmethod
    def _block_on(done: Optional[Tuple["torch.cuda.Event", torch.device]]
                  ) -> None:
        """Wait for the launch's (event, device) alone: not
        ``torch.cuda.synchronize()``, which would also wait for work
        queued after it, and not a read of an output on this thread's
        stream. The device is set first, before this thread touches
        CUDA."""
        if done is None:
            return
        event, device = done
        torch.cuda.set_device(device)
        event.synchronize()

    # -- derived accounting ------------------------------------------------

    def launches(self, limit: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._launches)
        return out[-limit:] if limit else out

    def _peak_total(self) -> float:
        """Aggregate peak FLOP/s across the devices this driver feeds."""
        if self._peak_total_cached is None:
            from ray_tpu_torch.util import flops as F

            peak = (F.H100_BF16_PEAK_FLOPS if self.peak_flops is None
                    else self.peak_flops)
            self._peak_total_cached = float(peak) * max(1, self.n_devices)
        return self._peak_total_cached

    def summary(self) -> Dict[str, Any]:
        """The MFU-gap picture: what the gauges and the snapshot
        carry."""
        with self._lock:
            recs = [r for r in self._launches if "t_done" in r]
            base = {"launches_total": self._launches_total,
                    "steps_total": self._steps_total,
                    "compiles": self._compiles,
                    "dry_resets": self._dry_resets,
                    "in_flight": len(self._open)}
        out = self._aggregate(recs)
        out.update(base)
        out["name"] = self.name
        self._overhead_fields(out)
        return out

    def window_summary(self, t0: float, t1: float) -> Dict[str, Any]:
        """Same aggregates restricted to launches that STARTED in
        [t0, t1): carves steady, data-starved or checkpoint-heavy
        windows out of one run."""
        with self._lock:
            recs = [r for r in self._launches
                    if "t_done" in r and t0 <= r["t"] < t1]
        return self._aggregate(recs)

    def _aggregate(self, recs: List[Dict[str, Any]]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"window_launches": len(recs)}
        if not recs:
            return out
        phase_totals = {p: 0.0 for p in LAUNCH_PHASES}
        wall_sum = 0.0
        gaps: List[float] = []
        flops_tot = 0.0
        tokens_tot = 0
        steps_tot = 0
        device_s = 0.0
        mfus: List[float] = []
        peak_total = self._peak_total()
        for r in recs:
            wall_sum += r["wall_s"]
            for p, v in r["phases"].items():
                if v > 0.0:
                    phase_totals[p] = phase_totals.get(p, 0.0) + v
            if "gap_s" in r:
                gaps.append(r["gap_s"])
            flops_tot += r["flops"]
            tokens_tot += r["tokens"]
            steps_tot += r["k"]
            device_s += r["phases"]["dispatch"] \
                + r["phases"]["device_compute"]
            if r["flops"] > 0 and r["wall_s"] > 0:
                mfus.append(r["flops"] / (r["wall_s"] * peak_total))
        gaps.sort()
        phase_sum = sum(phase_totals.values())
        span = max(r["t_done"] for r in recs) - min(r["t"] for r in recs)
        if span <= 0:
            span = wall_sum
        out.update({
            "launch_wall_s": round(wall_sum, 6),
            "span_s": round(span, 6),
            "steps": steps_tot,
            "tokens": tokens_tot,
            "tokens_per_s": round(tokens_tot / span, 1) if span > 0
            else 0.0,
            "phase_s": {p: round(v, 6) for p, v in phase_totals.items()
                        if v > 0.0},
            # the attribution's honesty bar: the stamped phases must explain
            # ≥95% of the launch wall or the attribution is fiction
            "phase_sum_ratio": round(phase_sum / wall_sum, 4)
            if wall_sum > 0 else 0.0,
            "launch_gap_p50_s": round(_pct(gaps, 0.50), 6),
            "launch_gap_p99_s": round(_pct(gaps, 0.99), 6),
            "launch_gap_max_s": round(gaps[-1], 6) if gaps else 0.0,
            # the last few gaps, newest last (all high = sustained
            # starvation)
            "gap_recent": [round(r["gap_s"], 6) for r in recs
                           if "gap_s" in r][-8:],
            "data_wait_frac": round(phase_totals["data_wait"] / span, 4)
            if span > 0 else 0.0,
            "device_s": round(device_s, 6),
        })
        if mfus:
            out["marginal_mfu"] = round(mfus[-1], 6)
            out["marginal_mfu_mean"] = round(sum(mfus) / len(mfus), 6)
            out["marginal_mfu_recent"] = [round(m, 6) for m in mfus[-8:]]
        if flops_tot > 0 and span > 0:
            raw_mfu = flops_tot / (device_s * peak_total) \
                if device_s > 0 else 0.0
            achieved_mfu = flops_tot / (span * peak_total)
            out["raw_mfu"] = round(raw_mfu, 6)
            out["achieved_mfu"] = round(achieved_mfu, 6)
            # clamped at 0: watcher-lag jitter can book achieved a hair
            # above raw on a sync backend, and a negative "gap" is
            # measurement noise, not headroom
            out["mfu_gap_frac"] = round(
                max(0.0, 1.0 - achieved_mfu / raw_mfu), 4) \
                if raw_mfu > 0 else 0.0
            # the waterfall: raw sustained -> achieved, lost wall
            # attributed to the host-side buckets. host_tax can overlap
            # device compute, so attributions are SCALED onto the
            # measured lost wall when they over-explain it; when they
            # under-explain, the residual is surfaced as "uncovered" —
            # never silently stretched
            lost_s = max(0.0, span - device_s)
            raw_buckets = {"data_wait": phase_totals["data_wait"],
                           "launch_gap": sum(gaps),
                           "host_tax": phase_totals["host_tax"],
                           "compile": phase_totals["compile"]}
            attr = sum(raw_buckets.values())
            scale = lost_s / attr if attr > lost_s and attr > 0 else 1.0
            buckets = {b: raw_buckets[b] * scale
                       for b in WATERFALL_BUCKETS}
            uncovered = max(0.0, lost_s - sum(buckets.values()))
            waterfall = {"raw_mfu": round(raw_mfu, 6),
                         "achieved_mfu": round(achieved_mfu, 6),
                         "lost_s": round(lost_s, 6),
                         "buckets_s": {b: round(v, 6)
                                       for b, v in buckets.items()},
                         "uncovered_s": round(uncovered, 6)}
            if span > 0:
                # exact decomposition: achieved = raw * device_s / span,
                # so each bucket's MFU cost is raw_mfu * bucket_s / span
                waterfall["mfu_cost"] = {
                    b: round(raw_mfu * v / span, 6)
                    for b, v in buckets.items()}
                waterfall["mfu_cost"]["uncovered"] = \
                    round(raw_mfu * uncovered / span, 6)
            out["waterfall"] = waterfall
        return out

    def snapshot(self, launches_limit: int = 64) -> Dict[str, Any]:
        """The ``@train/`` KV payload: summary + launch-record tail,
        compact enough to push every couple of seconds (< 64 KB)."""
        out = self._snapshot_header()
        out["summary"] = self.summary()
        out["launches"] = [self._compact_launch(r)
                           for r in self.launches(launches_limit)]
        return out

    @staticmethod
    def _compact_launch(r: Dict[str, Any]) -> Dict[str, Any]:
        out = {"seq": r["seq"], "t": round(r["t"], 4), "k": r["k"],
               "tokens": r["tokens"], "shape": r["batch_shape"],
               "phases_ms": {p: round(v * 1e3, 3)
                             for p, v in r["phases"].items() if v > 0.0},
               "done": "t_done" in r}
        if "wall_s" in r:
            out["wall_ms"] = round(r["wall_s"] * 1e3, 3)
        if "gap_s" in r:
            out["gap_ms"] = round(r["gap_s"] * 1e3, 3)
        return out

    # -- off-step drain (template in recorder_core; hooks below) -----------

    def _pending_since(self, wm_attr: str) -> List[Dict]:
        """Finalized records past the watermark (an open record drains
        after its done-hook fires — the watcher is FIFO, so seqs close
        in order and the watermark never strands one)."""
        with self._lock:
            wm = getattr(self, wm_attr)
            return [r for r in self._launches
                    if "t_done" in r and r.get("seq", 0) > wm]

    def _drain_metrics(self) -> int:
        emit = self.sinks.metric
        if emit is None:
            return 0
        tags = {"driver": self.name}
        new = self._pending_since("_metrics_wm")
        for r in new:
            for p, v in r["phases"].items():
                if v > 0.0:
                    emit(SERIES["phase"], "observe", v,
                         {"driver": self.name, "phase": p})
            if "gap_s" in r:
                emit(SERIES["gap"], "observe", r["gap_s"], tags)
            emit(SERIES["launches"], "inc", 1.0, tags)
        if new:
            self._metrics_wm = new[-1]["seq"]
        summ = self.summary()
        if summ.get("window_launches"):
            if "marginal_mfu" in summ:
                emit(SERIES["mfu"], "set", summ["marginal_mfu"], tags)
            if "mfu_gap_frac" in summ:
                emit(SERIES["mfu_gap"], "set", summ["mfu_gap_frac"], tags)
            emit(SERIES["data_wait"], "set", summ["data_wait_frac"], tags)
            emit(SERIES["toks"], "set", summ.get("tokens_per_s", 0.0), tags)
            emit(SERIES["overhead"], "set", summ["overhead_frac"], tags)
        return len(new)

    def _build_events(self, node: str, pid: int):
        """Launch records as timeline task events, one per fused launch;
        the advance closure runs only after the events sink returned."""
        events = []
        new = self._pending_since("_event_wm")
        for r in new[-256:]:
            events.append({
                "task_id": f"trainlaunch:{node}:{pid}:{self.name}:"
                           f"{r['seq']}",
                "name": f"launch:{self.name}", "state": "FINISHED",
                "node_id": node,
                "times": {"RUNNING": r["t"], "FINISHED": r["t_done"]},
                "train_launch": {**{k: v for k, v in r.items()
                                    if k != "t_dispatch_end"},
                                 "driver": self.name}})

        def advance() -> None:
            if new:
                self._event_wm = new[-1]["seq"]

        return events, advance

    def close(self) -> None:
        """Stop the watcher and drain threads after one final drain.
        Unlike the engine recorder, the ``@train/`` snapshot is NOT
        deleted: the postmortem read of a finished run is the point."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.REGISTRY.unregister(self)
        self._watch_q.put(None)
        try:
            self.drain_now()
        except Exception:  # noqa: BLE001
            pass


#: the series a drain observes, under the JAX package's names
SERIES = {
    "phase": "rt_train_launch_phase_seconds",
    "gap": "rt_train_launch_gap_seconds",
    "launches": "rt_train_launches_total",
    "mfu": "rt_train_marginal_mfu",
    "mfu_gap": "rt_train_mfu_gap_frac",
    "data_wait": "rt_train_data_wait_fraction",
    "toks": "rt_train_tokens_per_s",
    "overhead": "rt_train_recorder_overhead_ratio",
}
