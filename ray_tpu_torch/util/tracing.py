"""Distributed tracing: trace-context propagation across task/actor calls.

Reference analog: ``ray/util/tracing/tracing_helper.py`` — OpenTelemetry
span injection around submit/execute with context carried in the task spec.
Redesign without the otel dependency: a (trace_id, span_id) pair rides the
task payload; every task/actor call executed while tracing is enabled
becomes a span whose parent is the calling task's span. Spans land in the
GCS task-event store (the same table ``ray_tpu_torch.timeline()`` exports), so a
trace is a filterable view of the timeline: ``get_trace(trace_id)`` returns
the span tree.

Every traced task additionally carries a PER-PHASE latency breakdown
(reference: the task-event phase records behind Ray's State API,
``gcs_task_manager`` + ``task_events.proto``): the driver, raylet, and
executing worker each stamp the phases they own, and the union lands in the
span's GCS event as ``phases`` — a partition of the submit→reply interval:

  submit          driver-side residual: arg serialization + submit RPC + wire
  queue_wait      raylet queue time (enqueue → dispatch claim, including
                  dispatch-loop latency)
  spillback       present only when the task moved nodes: the ORIGIN
                  raylet's wait + routing overhead up to hand-off (the
                  executing node's queue_wait starts after the hop); the
                  span's ``spill_hops`` list names each from→to hop and
                  why the origin was rejected
  worker_acquire  worker checkout (``worker_source`` says spawn vs warm)
  transfer        push RPC + payload marshalling around the worker's span
  arg_fetch       dependency resolution + deserialization in the worker
  execute         the user function
  result_store    return serialization (+ plasma seal for large returns)
  driver_get      post-reply deserialization in the caller's ``get``

Phase stamping rides the span context: a task with no ``trace`` in its
payload pays exactly one predicate check per hop (the step-profiler
discipline). ``format_trace`` renders the span tree with phase tables and
names the critical path — the ``rt trace`` CLI prints it.

Usage::

    from ray_tpu_torch.util import tracing
    tracing.enable()
    ref = my_task.remote(...)      # root span, fresh trace_id
    ...
    spans = tracing.get_trace(tracing.last_trace_id())
    print(tracing.format_trace(spans))
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

_enabled = os.environ.get("RT_TRACING", "") not in ("", "0", "false")
_current: "contextvars.ContextVar[Optional[Dict[str, str]]]" = \
    contextvars.ContextVar("rt_trace_ctx", default=None)
_last_trace_id: Optional[str] = None


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def current_context() -> Optional[Dict[str, str]]:
    """The ambient span context ({trace_id, span_id}) or None."""
    return _current.get()


def context_for_submit() -> Optional[Dict[str, str]]:
    """Called by the core worker at submit time: the child span's wire
    context. A fresh trace starts when no span is ambient (driver root);
    in a worker WITHOUT an ambient span, no context is minted even if a
    previous traced task ran here — only explicit enable() or an inherited
    span starts spans."""
    global _last_trace_id
    parent = _current.get()
    if not _enabled and parent is None:
        return None
    span_id = uuid.uuid4().hex[:16]
    if parent is None:
        trace_id = uuid.uuid4().hex
        _last_trace_id = trace_id
        return {"trace_id": trace_id, "span_id": span_id,
                "parent_span_id": None}
    return {"trace_id": parent["trace_id"], "span_id": span_id,
            "parent_span_id": parent["span_id"]}


def activate(ctx: Optional[Dict[str, str]]):
    """Executor side: make the received context ambient for nested calls
    (grandchildren propagate through the ambient span, NOT a process flag —
    the worker returns to untraced once this task finishes). Returns a
    token for ``deactivate``."""
    if ctx is None:
        return None
    return _current.set({"trace_id": ctx["trace_id"],
                         "span_id": ctx["span_id"]})


def deactivate(token) -> None:
    if token is not None:
        _current.reset(token)


def last_trace_id() -> Optional[str]:
    """Trace id of the most recent root span started by this process."""
    return _last_trace_id


_submit_entry = threading.local()


def mark_submit_entry() -> None:
    """Called at the public submit entry (core/worker.py) so the ``submit``
    phase covers driver-side arg serialization too, not just the RPC.
    One predicate when tracing is off."""
    if _enabled or _current.get() is not None:
        _submit_entry.t = time.perf_counter()


def take_submit_entry() -> Optional[float]:
    """Consume the entry stamp (backend submit path); None when untraced."""
    t = getattr(_submit_entry, "t", None)
    _submit_entry.t = None
    return t


def get_trace(trace_id: str) -> List[Dict[str, Any]]:
    """All spans of one trace, parents before children where possible."""
    import ray_tpu_torch

    backend = ray_tpu_torch.global_worker()._require_backend()
    events = backend.io.run(
        backend._gcs.call("list_tasks",
                          {"limit": 10000, "serve": "include"}))
    spans = [e for e in events
             if (e.get("trace") or {}).get("trace_id") == trace_id]
    by_span = {(s["trace"] or {}).get("span_id"): s for s in spans}

    def depth(s, seen=()):
        parent = (s["trace"] or {}).get("parent_span_id")
        if parent is None or parent not in by_span or parent in seen:
            return 0
        return 1 + depth(by_span[parent],
                         seen + ((s["trace"] or {}).get("span_id"),))

    return sorted(spans, key=depth)


# ---------------------------------------------------------------------------
# Phase records
# ---------------------------------------------------------------------------

# Wall-clock partition of one task's submit→reply interval, in causal order
# (driver_get trails the reply). ``format_trace`` and the dashboard render
# phases in this order; unknown keys sort after.
PHASE_ORDER = ("submit", "queue_wait", "spillback", "worker_acquire",
               "transfer", "arg_fetch", "execute", "result_store",
               "driver_get")

# Serve request spans (serve/obs.py) carry their own phase vocabulary —
# ranked after the task partition, in causal order per hop (proxy:
# route→handle→respond/stream; handle: route→call; replica:
# queue_wait→execute, which reuses the task names above).
SERVE_PHASE_ORDER = ("proxy_route", "handle", "route", "call",
                     "call_stream", "respond", "stream")

# Engine flight-recorder spans (util/engine_recorder.py) — the request
# lifecycle inside ContinuousEngine, in causal order (queue-wait until a
# slot frees, KV restore of the cached prefix, prefill of the suffix,
# then the decode ticks until the last token). Tick records additionally
# use decode_step/token_delivery/swap_barrier.
ENGINE_PHASE_ORDER = ("queue_wait", "kv_restore", "prefill",
                      "decode_step", "decode", "token_delivery",
                      "swap_barrier")


def sorted_phases(phases: Dict[str, float]) -> List[Any]:
    """(name, seconds) pairs in canonical phase order."""
    _all = PHASE_ORDER + SERVE_PHASE_ORDER + tuple(
        p for p in ENGINE_PHASE_ORDER
        if p not in PHASE_ORDER + SERVE_PHASE_ORDER)
    rank = {p: i for i, p in enumerate(_all)}
    n = len(_all)
    return sorted(phases.items(), key=lambda kv: (rank.get(kv[0], n), kv[0]))


def span_tree(spans: List[Dict[str, Any]]) -> List[Any]:
    """Nest spans by parentage: [(span, [children...]), ...] roots first."""
    by_span: Dict[str, Any] = {}
    for s in spans:
        sid = (s.get("trace") or {}).get("span_id")
        if sid is not None:
            by_span[sid] = (s, [])
    roots: List[Any] = []
    for s in spans:
        ctx = s.get("trace") or {}
        sid, parent = ctx.get("span_id"), ctx.get("parent_span_id")
        node = by_span.get(sid) or (s, [])
        if parent is not None and parent in by_span and parent != sid:
            by_span[parent][1].append(node)
        else:
            roots.append(node)
    return roots


def _span_duration(span: Dict[str, Any]) -> float:
    phases = span.get("phases") or {}
    if phases:
        return sum(v for k, v in phases.items() if k != "driver_get")
    times = span.get("times") or {}
    start = times.get("PENDING") or times.get("RUNNING")
    end = times.get("FINISHED") or times.get("FAILED")
    if start is not None and end is not None:
        return max(0.0, end - start)
    return 0.0


def critical_path(spans: List[Dict[str, Any]]) -> List[Any]:
    """The root→leaf chain that dominates end-to-end latency, each hop
    tagged with its heaviest phase: [(span, phase_name, seconds), ...].
    At each level the child with the largest span duration wins (children
    of one parent overlap in wall time; the longest one gates the parent).
    """
    roots = span_tree(spans)
    if not roots:
        return []
    path: List[Any] = []
    node = max(roots, key=lambda n: _span_duration(n[0]))
    while node is not None:
        span, children = node
        phases = span.get("phases") or {}
        if phases:
            name, dur = max(phases.items(), key=lambda kv: kv[1])
        else:
            name, dur = "total", _span_duration(span)
        path.append((span, name, dur))
        node = max(children, key=lambda n: _span_duration(n[0])) \
            if children else None
    return path


def format_trace(spans: List[Dict[str, Any]]) -> str:
    """Human-readable span tree with per-phase tables and the named
    critical path — what ``rt trace`` prints."""
    if not spans:
        return "(no spans)"
    lines: List[str] = []

    def emit(node, indent: int) -> None:
        span, children = node
        dur = _span_duration(span)
        pad = "  " * indent
        lines.append(
            f"{pad}{'└─ ' if indent else ''}{span.get('name') or 'task'}  "
            f"[{span.get('state', '?')}]  {dur * 1e3:.1f} ms  "
            f"task_id={span.get('task_id', '')[:16]}")
        phases = span.get("phases") or {}
        if phases:
            total = sum(phases.values()) or 1.0
            for pname, secs in sorted_phases(phases):
                bar = "#" * max(1, int(20 * secs / total)) if secs > 0 else ""
                extra = ""
                if pname == "worker_acquire" and span.get("worker_source"):
                    extra = f" ({span['worker_source']})"
                elif pname == "spillback" and span.get("spill_hops"):
                    # the hop chain: from-node → to-node (why)
                    extra = " (" + " -> ".join(
                        f"{(h.get('from') or '?')[:8]}→"
                        f"{(h.get('to') or '?')[:8]} {h.get('reason', '')}"
                        for h in span["spill_hops"]) + ")"
                lines.append(f"{pad}     {pname:<15}{secs * 1e3:>10.2f} ms"
                             f"  {bar}{extra}")
        for child in sorted(children,
                            key=lambda n: -_span_duration(n[0])):
            emit(child, indent + 1)

    trace_id = (spans[0].get("trace") or {}).get("trace_id", "?")
    lines.append(f"trace {trace_id} — {len(spans)} span(s)")
    for root in span_tree(spans):
        emit(root, 0)
    cp = critical_path(spans)
    if cp:
        hops = " -> ".join(
            f"{s.get('name') or 'task'}:{phase} ({dur * 1e3:.1f} ms)"
            for s, phase, dur in cp)
        lines.append(f"critical path: {hops}")
    return "\n".join(lines)
