"""Serve request observability: request ids, serve spans, rt_serve_* series.

Reference analogs: the request-context plumbing in
``serve/_private/request_router`` + ``ray.serve.context`` (request id
minted at the proxy, carried on every hop) and the autoscaler metrics
pipeline (``serve/_private/metrics_utils.py``). Redesign for this repo:

  - every ingress (HTTP proxy, gRPC proxy, direct ``DeploymentHandle``
    call) mints a request id; the id doubles as the TRACE id of the
    tracing plane, so the proxy-, handle- and replica-level serve spans
    and the real actor-call task spans all join one tree and
    ``rt trace <request_id>`` prints the full proxy -> route ->
    replica-queue -> execute -> stream path;
  - serve spans are ordinary GCS task events with ``task_id``
    ``serve:<request_id>...`` — they land in their own bounded store
    (``cluster/gcs.py``) via the batched drainer below, so heavy traffic
    cannot evict real task history;
  - the ``rt_serve_*`` Prometheus series are registered lazily in
    whichever process observes them (proxy, replica, controller) and ride
    the standard per-process KV push (``util/metrics.py``).

The ambient request context propagates caller -> pool thread -> replica ->
nested handle calls explicitly (thread pools do not inherit contextvars),
so composition chains keep one request id end to end.
"""

from __future__ import annotations

import collections
import contextvars
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util import metrics as M

REQUEST_ID_HEADER = "x-rt-request-id"

# request context: {"request_id", "app", "deployment", "route", "span_id"}
_request_ctx: "contextvars.ContextVar[Optional[Dict[str, str]]]" = \
    contextvars.ContextVar("rt_serve_request_ctx", default=None)


def mint_request_id() -> str:
    return uuid.uuid4().hex


_RID_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_")


def valid_request_id(rid: str) -> bool:
    """Gate for ADOPTING an upstream ``x-rt-request-id``: bounded length,
    URL/metric-safe charset — the id becomes a GCS span key, a trace id
    and an echoed header, so arbitrary client bytes don't belong."""
    return bool(rid) and len(rid) <= 128 and set(rid) <= _RID_CHARS


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def current_request_context() -> Optional[Dict[str, str]]:
    """The ambient serve request context (None outside a request)."""
    return _request_ctx.get()


def get_serve_request_id() -> Optional[str]:
    """Inside a serve request: the request id every hop shares (user code
    can log it; ``rt trace <id>`` joins it with the span tree)."""
    ctx = _request_ctx.get()
    return ctx.get("request_id") if ctx else None


def activate_request(ctx: Optional[Dict[str, str]]):
    """Make ``ctx`` ambient; returns a token for :func:`deactivate_request`.

    Also activates the matching tracing span context so task/actor calls
    made under this request become children of ``ctx['span_id']`` in the
    trace whose id IS the request id.
    """
    if ctx is None:
        return None
    from ray_tpu_torch.util import tracing

    req_token = _request_ctx.set(ctx)
    trace_token = tracing.activate({"trace_id": ctx["request_id"],
                                    "span_id": ctx["span_id"]})
    return (req_token, trace_token)


def deactivate_request(token) -> None:
    if token is None:
        return
    from ray_tpu_torch.util import tracing

    req_token, trace_token = token
    _request_ctx.reset(req_token)
    tracing.deactivate(trace_token)


# ---------------------------------------------------------------------------
# Metrics (lazy: registered in whichever process first observes them)
# ---------------------------------------------------------------------------

_metrics_lock = threading.Lock()
_metrics: Dict[str, Any] = {}

_REQUEST_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0)
_TOKEN_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                  0.5, 1.0, 2.5)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
_OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def _metric(key: str, factory) -> Any:
    m = _metrics.get(key)
    if m is None:
        with _metrics_lock:
            m = _metrics.get(key)
            if m is None:
                m = factory()
                _metrics[key] = m
    return m


def request_seconds() -> M.Histogram:
    return _metric("request_seconds", lambda: M.get_or_create(
        M.Histogram, "rt_serve_request_seconds",
        "End-to-end serve request latency at the ingress "
        "(streamed requests close at last byte)",
        boundaries=_REQUEST_BUCKETS,
        tag_keys=("app", "deployment", "route", "code")))


def requests_total() -> M.Counter:
    return _metric("requests_total", lambda: M.get_or_create(
        M.Counter, "rt_serve_requests_total",
        "Serve requests by response code at the ingress",
        tag_keys=("app", "code")))


def errors_total() -> M.Counter:
    return _metric("errors_total", lambda: M.get_or_create(
        M.Counter, "rt_serve_errors_total",
        "Serve request errors by kind (replica_died / rejected_timeout / "
        "app_error / http_5xx)",
        tag_keys=("app", "deployment", "kind")))


def queue_wait_seconds() -> M.Histogram:
    return _metric("queue_wait_seconds", lambda: M.get_or_create(
        M.Histogram, "rt_serve_queue_wait_seconds",
        "Replica-side wait between request admission and user-code start",
        boundaries=_TOKEN_BUCKETS,
        tag_keys=("app", "deployment")))


def execute_seconds() -> M.Histogram:
    return _metric("execute_seconds", lambda: M.get_or_create(
        M.Histogram, "rt_serve_execute_seconds",
        "Replica-side user-callable execution time",
        boundaries=_REQUEST_BUCKETS,
        tag_keys=("app", "deployment")))


def ongoing_gauge() -> M.Gauge:
    return _metric("ongoing", lambda: M.get_or_create(
        M.Gauge, "rt_serve_ongoing",
        "In-flight requests per deployment (controller-polled)",
        tag_keys=("app", "deployment")))


def queue_depth_gauge() -> M.Gauge:
    return _metric("queue_depth", lambda: M.get_or_create(
        M.Gauge, "rt_serve_queue_depth",
        "Admitted requests waiting for a replica executor thread, "
        "per deployment (controller-polled)",
        tag_keys=("app", "deployment")))


def ttft_seconds() -> M.Histogram:
    return _metric("ttft", lambda: M.get_or_create(
        M.Histogram, "rt_serve_ttft_seconds",
        "Time to first streamed chunk, request receipt to first byte",
        boundaries=_REQUEST_BUCKETS,
        tag_keys=("app", "deployment")))


def inter_token_seconds() -> M.Histogram:
    return _metric("inter_token", lambda: M.get_or_create(
        M.Histogram, "rt_serve_inter_token_seconds",
        "Gap between consecutive streamed chunks (TPOT)",
        boundaries=_TOKEN_BUCKETS,
        tag_keys=("app", "deployment")))


def tokens_total() -> M.Counter:
    return _metric("tokens_total", lambda: M.get_or_create(
        M.Counter, "rt_serve_tokens_total",
        "Streamed chunks delivered through the serve ingress",
        tag_keys=("app", "deployment")))


def batch_size_hist() -> M.Histogram:
    return _metric("batch_size", lambda: M.get_or_create(
        M.Histogram, "rt_serve_batch_size",
        "@serve.batch fused batch size per flush",
        boundaries=_BATCH_BUCKETS,
        tag_keys=("fn",)))


def batch_occupancy_hist() -> M.Histogram:
    return _metric("batch_occupancy", lambda: M.get_or_create(
        M.Histogram, "rt_serve_batch_occupancy",
        "@serve.batch batch size as a fraction of max_batch_size",
        boundaries=_OCCUPANCY_BUCKETS,
        tag_keys=("fn",)))


def cb_slots_gauge() -> M.Gauge:
    return _metric("cb_slots", lambda: M.get_or_create(
        M.Gauge, "rt_serve_cb_slots_active",
        "Continuous-batching decode slots occupied per engine tick "
        "(serve/llm.py ContinuousLLM)",
        tag_keys=("deployment",)))


def kv_cache_hits() -> M.Counter:
    return _metric("kv_hits", lambda: M.get_or_create(
        M.Counter, "rt_serve_kv_cache_hits",
        "Prefix/KV-cache admission hits (prefill ran only on the "
        "uncached suffix)",
        tag_keys=("deployment",)))


def kv_cache_misses() -> M.Counter:
    return _metric("kv_misses", lambda: M.get_or_create(
        M.Counter, "rt_serve_kv_cache_misses",
        "Prefix/KV-cache admission misses (full cold prefill)",
        tag_keys=("deployment",)))


def kv_cache_evictions() -> M.Counter:
    return _metric("kv_evictions", lambda: M.get_or_create(
        M.Counter, "rt_serve_kv_cache_evictions",
        "Prefix/KV-cache pages evicted by the bytes-budget LRU",
        tag_keys=("deployment",)))


def kv_cache_bytes() -> M.Gauge:
    return _metric("kv_bytes", lambda: M.get_or_create(
        M.Gauge, "rt_serve_kv_cache_bytes",
        "Retained prefix/KV-cache page bytes per engine (LRU budget "
        "from RT_KV_CACHE_BYTES / kv_cache_bytes)",
        tag_keys=("deployment",)))


def proxy_requests_total() -> M.Counter:
    return _metric("proxy_requests", lambda: M.get_or_create(
        M.Counter, "rt_proxy_requests_total",
        "Requests handled per HTTP proxy process (multi-proxy spread)",
        tag_keys=("proxy",)))


def mux_requests_total() -> M.Counter:
    return _metric("mux_requests", lambda: M.get_or_create(
        M.Counter, "rt_serve_mux_requests_total",
        "Multiplexed model lookups by model id and cache outcome "
        "(hit / load)",
        tag_keys=("model_id", "outcome")))


def autoscale_decisions_total() -> M.Counter:
    return _metric("autoscale_decisions", lambda: M.get_or_create(
        M.Counter, "rt_serve_autoscale_decisions_total",
        "Controller scaling decisions applied, by direction "
        "(up / down / deploy)",
        tag_keys=("app", "deployment", "direction")))


# ---------------------------------------------------------------------------
# Serve span emission (batched drain into the GCS serve-event store)
# ---------------------------------------------------------------------------

_SPAN_FLUSH_S = float(os.environ.get("RT_SERVE_SPAN_FLUSH_S", "1.0"))
_SPAN_BUFFER_CAP = 4096

_span_lock = threading.Lock()
# deque: O(1) drop-oldest on overflow — emit_span sits on the request hot
# path, and a GCS outage must not turn every span append into an O(cap)
# list shift inside the lock
_span_buf: "collections.deque[Dict[str, Any]]" = collections.deque(
    maxlen=_SPAN_BUFFER_CAP)
_span_drainer: Optional[threading.Thread] = None
_dropped_spans = 0


def spans_enabled() -> bool:
    return os.environ.get("RT_SERVE_TRACE", "1") not in ("0", "false")


def emit_span(task_id: str, name: str, *, request_id: str, span_id: str,
              parent_span_id: Optional[str], t_start: float, t_end: float,
              phases: Optional[Dict[str, float]] = None,
              state: str = "FINISHED") -> None:
    """Buffer one serve span for the background drain. ``task_id`` must
    start with ``serve:`` so the GCS routes it into the serve store."""
    if not spans_enabled():
        return
    global _dropped_spans
    ev = {
        "task_id": task_id, "name": name, "state": state,
        "node_id": os.uname().nodename,
        "trace": {"trace_id": request_id, "span_id": span_id,
                  "parent_span_id": parent_span_id},
        "times": {"RUNNING": t_start, "FINISHED": t_end},
    }
    if phases:
        ev["phases"] = {k: max(0.0, v) for k, v in phases.items()}
    with _span_lock:
        if len(_span_buf) >= _SPAN_BUFFER_CAP:
            _dropped_spans += 1  # maxlen evicts the oldest on append
        _span_buf.append(ev)
    _ensure_drainer()


def _ensure_drainer() -> None:
    global _span_drainer
    if _span_drainer is not None and _span_drainer.is_alive():
        return
    with _span_lock:
        if _span_drainer is not None and _span_drainer.is_alive():
            return
        _span_drainer = threading.Thread(
            target=_drain_loop, daemon=True, name="rt-serve-span-drain")
        _span_drainer.start()


def _drain_loop() -> None:
    while True:
        time.sleep(_SPAN_FLUSH_S)
        try:
            flush_spans()
        except Exception:  # noqa: BLE001 — observability must never
            pass  # take the serve path down


def flush_spans() -> int:
    """Push buffered serve spans to the GCS in one batched RPC (tests and
    shutdown hooks call this directly). Returns the number shipped."""
    try:
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            return 0
        backend = ray_tpu_torch.global_worker()._require_backend()
        if not hasattr(backend, "_gcs"):
            return 0  # local_mode: no event store
    except Exception:  # noqa: BLE001
        return 0
    with _span_lock:
        if not _span_buf:
            return 0
        pending = list(_span_buf)
        _span_buf.clear()
    try:
        backend.io.run(backend._gcs.call(
            "task_events", {"events": pending}))
    except Exception:  # noqa: BLE001 — requeue for the next interval
        with _span_lock:
            # prepend so ordering holds; extendleft walks reversed input.
            # On overlap the maxlen deque evicts from the right (the
            # newest spans) — only reachable when a full buffer ALSO
            # failed to flush, where dropping some is already the deal
            _span_buf.extendleft(reversed(pending))
        return 0
    return len(pending)
