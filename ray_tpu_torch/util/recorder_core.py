"""Shared flight-recorder core (the port's own copy of
``ray_tpu/util/recorder_core.py``).

The same shape as the JAX package's: bounded ring buffers appended under a
microsecond lock, a daemon drain thread shipping derived telemetry off the
hot path on seq-watermarks, a compact snapshot pushed every couple of
seconds and deleted at close, and recorder self-timing against a 2 %
overhead bar.

  RecorderRegistry  per-module registry of live recorders (bounded at
                    64), backing each module's ``live_recorders()``
  RecorderCore      the drain-side template: ``_ensure_drainer`` /
                    ``_drain_loop`` / ``drain_now`` / ``_drain_sinks`` /
                    ``close``, parameterized by class attrs
                    (``KV_PREFIX`` / ``DRAIN_S`` / ``THREAD_NAME`` /
                    ``REGISTRY``) and subclass hooks (``snapshot`` /
                    ``_drain_metrics`` / ``_build_events``; engine-only
                    ``_drain_spans``)
  Sinks             where a drain pass ships its telemetry
  pct               nearest-rank percentile over a pre-sorted list

The one difference from the JAX package: a drain there pushes into the
cluster runtime (the GCS KV store and task-event store, the metrics
registry, the serve span buffer), which the port does not import. Here
the caller passes those pushes in as :class:`Sinks` callbacks. With no
sink a drain pass does nothing and raises nothing, as the JAX drain does
outside an initialized cluster.

Record methods ONLY append to bounded deques under ``_lock`` and add
their own wall to ``_overhead_s``; everything that calls a sink runs on
the drain thread.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple


def pct(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


@dataclasses.dataclass(frozen=True)
class Sinks:
    """The pushes of a drain pass, each optional (None: not pushed).

    - ``metric(series, op, value, tags)``: one observation of a named
      series; ``op`` is ``"observe"`` (histogram), ``"inc"`` (counter) or
      ``"set"`` (gauge), as the JAX package's metric handles take them.
    - ``span(task_id, name, *, request_id, span_id, parent_span_id,
      t_start, t_end, phases, state)``: one finished request span, the
      arguments of the JAX package's ``serve.obs.emit_span``.
    - ``kv_put(key, payload)`` / ``kv_del(key)``: the recorder's JSON
      snapshot (bytes) under its key, and its removal at close.
    - ``events(events)``: timeline task events. The watermark advances
      only when it returns; a sink that raises gets them again next pass.
    """

    metric: Optional[Callable[[str, str, float, Dict[str, str]], None]] = None
    span: Optional[Callable[..., None]] = None
    kv_put: Optional[Callable[[str, bytes], None]] = None
    kv_del: Optional[Callable[[str], None]] = None
    events: Optional[Callable[[List[Dict[str, Any]]], None]] = None


class RecorderRegistry:
    """Per-module registry of live recorders.

    Bounded: a pathological construct loop must not grow an unbounded
    id->recorder dict, so the oldest entry is evicted past ``cap``.
    Eviction only forgets the handle: the evicted recorder keeps
    recording and draining until closed.
    """

    def __init__(self, cap: int = 64):
        self._cap = int(cap)
        self._lock = threading.Lock()
        self._recorders: "OrderedDict[int, Any]" = \
            OrderedDict()  # rt: guarded-by(_lock)

    def register(self, rec: Any) -> None:
        with self._lock:
            self._recorders[id(rec)] = rec
            while len(self._recorders) > self._cap:
                self._recorders.popitem(last=False)

    def unregister(self, rec: Any) -> None:
        with self._lock:
            self._recorders.pop(id(rec), None)

    def live(self) -> List[Any]:
        """Every recorder registered in this process and not yet
        closed."""
        with self._lock:
            return list(self._recorders.values())


class RecorderCore:
    """Drain-side template shared by every flight recorder.

    Subclasses set the class attrs, call ``_init_core(name, sinks)`` from
    ``__init__`` (after their own fields: it registers the recorder), and
    implement:

      snapshot() -> dict                  the KV payload
      _drain_metrics() -> int             new records into the metric sink
      _build_events(node, pid)            (events, advance_fn): timeline
                                          events for new records plus the
                                          watermark advance to run only
                                          after the events sink returned
      _drain_spans() -> Optional[int]     request-span join (engine
                                          only); None = no span plane,
                                          key omitted from drain counts
    """

    KV_PREFIX = "@rec/"
    DRAIN_S = 2.0
    THREAD_NAME = "rtt-rec"
    REGISTRY: RecorderRegistry = RecorderRegistry()

    name: str

    def _init_core(self, name: str, sinks: Optional[Sinks] = None) -> None:
        self.sinks = sinks or Sinks()
        self._lock = threading.Lock()
        self._overhead_s = 0.0  # rt: guarded-by(_lock)
        self._wall_total_s = 0.0  # rt: guarded-by(_lock)
        self._closed = False  # rt: guarded-by(_lock)
        self._drainer: Optional[threading.Thread] = None  # rt: guarded-by(_lock)
        self._kv_key = f"{self.KV_PREFIX}{os.uname().nodename}:" \
                       f"{os.getpid()}:{name}"
        self.REGISTRY.register(self)

    # -- subclass hooks ----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def _drain_metrics(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def _build_events(self, node: str, pid: int
                      ) -> Tuple[List[Dict[str, Any]], Callable[[], None]]:
        return [], lambda: None

    def _drain_spans(self) -> Optional[int]:
        return None

    # -- shared helpers ----------------------------------------------------

    def _snapshot_header(self) -> Dict[str, Any]:
        return {"t": time.time(), "name": self.name,
                "node": os.uname().nodename, "pid": os.getpid()}

    def _overhead_fields(self, out: Dict[str, Any]) -> None:
        """Stamp the self-timing triple every summary reports."""
        with self._lock:
            overhead = self._overhead_s
            wall = self._wall_total_s
        out["overhead_s"] = round(overhead, 6)
        out["recorded_wall_s"] = round(wall, 6)
        out["overhead_frac"] = round(overhead / wall, 6) \
            if wall > 0 else 0.0

    # -- drain side --------------------------------------------------------

    def _ensure_drainer(self) -> None:
        if self._drainer is not None and self._drainer.is_alive():
            return
        with self._lock:
            if self._closed or (self._drainer is not None
                                and self._drainer.is_alive()):
                return
            self._drainer = threading.Thread(
                target=self._drain_loop, daemon=True,
                name=f"{self.THREAD_NAME}:{self.name}")
            self._drainer.start()

    def _drain_loop(self) -> None:
        while True:
            time.sleep(self.DRAIN_S)
            with self._lock:
                if self._closed:
                    return
            try:
                self.drain_now()
            except Exception:  # noqa: BLE001 — observability must never
                pass           # take the instrumented loop down

    def drain_now(self) -> Dict[str, int]:
        """One drain pass (tests call this instead of waiting out the
        interval): metric observations, span emission where the plane
        has one, the snapshot, and record events."""
        counts = {"metrics": self._drain_metrics()}
        spans = self._drain_spans()
        if spans is not None:
            counts["spans"] = spans
        counts.update(self._drain_sinks())
        return counts

    def _drain_sinks(self) -> Dict[str, int]:
        """Snapshot + timeline events, each best-effort and skipped
        without its sink. Event watermarks advance only after the events
        sink returned: a failing sink is sent the events again, never
        loses them."""
        out = {"kv": 0, "events": 0}
        if self.sinks.kv_put is not None:
            try:
                self.sinks.kv_put(self._kv_key,
                                  json.dumps(self.snapshot()).encode())
                out["kv"] = 1
            except Exception:  # noqa: BLE001
                pass
        if self.sinks.events is None:
            return out
        events, advance = self._build_events(os.uname().nodename,
                                             os.getpid())
        if not events:
            return out
        try:
            self.sinks.events(events)
            advance()
            out["events"] = len(events)
        except Exception:  # noqa: BLE001
            pass
        return out

    def close(self) -> None:
        """Stop the drain thread and drop the snapshot (a dead plane's
        numbers must not be graded)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.REGISTRY.unregister(self)
        if self.sinks.kv_del is not None:
            try:
                self.sinks.kv_del(self._kv_key)
            except Exception:  # noqa: BLE001
                pass
