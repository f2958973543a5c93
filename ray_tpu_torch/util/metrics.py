"""User metrics API: Counter / Gauge / Histogram + Prometheus text export.

Reference analogs: ``python/ray/util/metrics.py`` (the user API) and the
metrics pipeline ``src/ray/stats/metric_defs.cc`` -> per-node agent ->
Prometheus (``_private/metrics_agent.py``, ``prometheus_exporter.py``).
Redesign: no per-node agent process — every worker/driver process keeps a
local registry and pushes snapshots to the GCS KV on an interval; scrapers
read one aggregated Prometheus text page from ``rt metrics`` (or the
``metrics_text`` helper).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_PUSH_INTERVAL_S = 5.0
_KV_PREFIX = "@metrics/"

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                    5.0, 10.0)


class _Registry:
    def __init__(self):
        self.metrics: Dict[str, "Metric"] = {}
        self.lock = threading.Lock()
        self._pusher: Optional[threading.Thread] = None

    def register(self, metric: "Metric") -> None:
        with self.lock:
            existing = self.metrics.get(metric.name)
            if existing is not None and type(existing) is not type(metric):
                raise ValueError(
                    f"metric {metric.name!r} already registered as "
                    f"{type(existing).__name__}")
            self.metrics[metric.name] = metric
        self._ensure_pusher()

    def snapshot(self) -> List[Dict]:
        with self.lock:
            return [m.to_dict() for m in self.metrics.values()]

    def _ensure_pusher(self) -> None:
        if self._pusher is not None and self._pusher.is_alive():
            return
        self._pusher = threading.Thread(target=self._push_loop, daemon=True,
                                        name="rt-metrics-push")
        self._pusher.start()

    def _push_loop(self) -> None:
        import os

        import ray_tpu_torch

        key = _KV_PREFIX + f"{os.uname().nodename}:{os.getpid()}"
        while True:
            time.sleep(_PUSH_INTERVAL_S)
            try:
                if not ray_tpu_torch.is_initialized():
                    continue
                backend = ray_tpu_torch.global_worker()._require_backend()
                if not hasattr(backend, "kv_put"):
                    continue
                backend.kv_put(key, json.dumps({
                    "t": time.time(), "metrics": self.snapshot()}).encode())
            except Exception:
                pass  # metrics must never take the workload down


_registry = _Registry()


_GET_OR_CREATE_LOCK = threading.Lock()


def get_or_create(kind: type, name: str, description: str = "",
                  **kwargs) -> "Metric":
    """Idempotent registration: return the live metric when one of the same
    type already holds ``name`` (constructing a fresh object would shadow
    the accumulated samples in the registry). Library instrumentation (the
    step profiler's auto-registered histograms) goes through this so
    re-entry — a second ``enable()``, concurrent first observations from
    two threads, a reimport under tests — is safe. The outer lock makes
    check-then-construct atomic; construction takes the registry lock
    nested inside it (never the reverse), so there is no lock cycle."""
    with _GET_OR_CREATE_LOCK:
        with _registry.lock:
            existing = _registry.metrics.get(name)
        if existing is not None and type(existing) is kind:
            return existing
        return kind(name, description, **kwargs)


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        _registry.register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _tags(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        merged = dict(self._default_tags)
        merged.update(tags or {})
        return merged


class Counter(Metric):
    def __init__(self, name, description="", tag_keys=()):
        self._values: Dict[Tuple, float] = {}
        super().__init__(name, description, tag_keys)

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        key = _label_key(self._tags(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def to_dict(self) -> Dict:
        with self._lock:
            return {"type": "counter", "name": self.name,
                    "help": self.description,
                    "samples": [[dict(k), v] for k, v in self._values.items()]}


class Gauge(Metric):
    def __init__(self, name, description="", tag_keys=()):
        self._values: Dict[Tuple, float] = {}
        super().__init__(name, description, tag_keys)

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_label_key(self._tags(tags))] = float(value)

    def inc(self, value: float = 1.0, tags=None) -> None:
        key = _label_key(self._tags(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def dec(self, value: float = 1.0, tags=None) -> None:
        self.inc(-value, tags)

    def remove(self, tags: Optional[Dict[str, str]] = None) -> None:
        """Drop one labeled sample (e.g. a dead worker's RSS gauge) so
        stale series don't linger on the Prometheus page forever."""
        with self._lock:
            self._values.pop(_label_key(self._tags(tags)), None)

    def to_dict(self) -> Dict:
        with self._lock:
            return {"type": "gauge", "name": self.name,
                    "help": self.description,
                    "samples": [[dict(k), v] for k, v in self._values.items()]}


class Histogram(Metric):
    def __init__(self, name, description="", boundaries: Sequence[float] = (),
                 tag_keys=()):
        self.boundaries = tuple(boundaries) or _DEFAULT_BUCKETS
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(self._tags(tags))
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def to_dict(self) -> Dict:
        with self._lock:
            return {"type": "histogram", "name": self.name,
                    "help": self.description,
                    "boundaries": list(self.boundaries),
                    "samples": [[dict(k), {
                        "counts": list(self._counts[k]),
                        "sum": self._sums[k], "count": self._totals[k]}]
                        for k in self._counts]}


# ---- export -----------------------------------------------------------------

def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def prometheus_text(snapshots: List[Dict]) -> str:
    """Render metric snapshots (from one or many processes) as the
    Prometheus text exposition format, merging same-named series."""
    by_name: Dict[str, List[Dict]] = {}
    for m in snapshots:
        by_name.setdefault(m["name"], []).append(m)
    lines: List[str] = []
    for name, metrics in sorted(by_name.items()):
        kind = metrics[0]["type"]
        lines.append(f"# HELP {name} {metrics[0].get('help', '')}")
        lines.append(f"# TYPE {name} {kind}")
        if kind in ("counter", "gauge"):
            merged: Dict[Tuple, float] = {}
            for m in metrics:
                for labels, v in m["samples"]:
                    key = _label_key(labels)
                    if kind == "counter":
                        merged[key] = merged.get(key, 0.0) + v
                    else:
                        merged[key] = v  # last writer wins for gauges
            for key, v in sorted(merged.items()):
                lines.append(f"{name}{_fmt_labels(dict(key))} {v}")
        else:  # histogram
            for m in metrics:
                bounds = m["boundaries"]
                for labels, h in m["samples"]:
                    cum = 0
                    for b, c in zip(bounds, h["counts"]):
                        cum += c
                        lab = dict(labels)
                        lab["le"] = str(b)
                        lines.append(f"{name}_bucket{_fmt_labels(lab)} {cum}")
                    lab = dict(labels)
                    lab["le"] = "+Inf"
                    lines.append(
                        f"{name}_bucket{_fmt_labels(lab)} {h['count']}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(dict(labels))} {h['sum']}")
                    lines.append(
                        f"{name}_count{_fmt_labels(dict(labels))} {h['count']}")
    return "\n".join(lines) + "\n"


def metrics_text() -> str:
    """Aggregate every process's pushed snapshot from the GCS KV into one
    Prometheus page (what ``rt metrics`` prints / an exporter serves)."""
    import ray_tpu_torch

    backend = ray_tpu_torch.global_worker()._require_backend()
    try:
        flush_now()  # fold this process's live registry into its KV slot
    except Exception:  # noqa: BLE001
        pass
    snapshots: List[Dict] = []
    for key in backend.kv_keys(_KV_PREFIX):
        raw = backend.kv_get(key)
        if raw:
            try:
                snapshots.extend(json.loads(raw)["metrics"])
            except (ValueError, KeyError):
                pass
    return prometheus_text(snapshots)


def flush_now() -> None:
    """Push this process's snapshot immediately (tests; shutdown hooks)."""
    import os

    import ray_tpu_torch

    backend = ray_tpu_torch.global_worker()._require_backend()
    key = _KV_PREFIX + f"{os.uname().nodename}:{os.getpid()}"
    backend.kv_put(key, json.dumps(
        {"t": time.time(), "metrics": _registry.snapshot()}).encode())
