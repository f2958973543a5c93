"""Step profiler: per-step time breakdown over the port's hot paths (the
port's own copy of ``ray_tpu/util/step_profiler.py``: the same records,
fields, summaries and environment variables).

What one record holds, and how it is measured around ONE step
(``profiled_call``):

  wall_s      total host wall time for the step
  compile_s   the first call's time under this step's ``key``. Eager
              PyTorch compiles nothing, but the first call of a program
              pays the kernels' nvcc build (``ops/_build.py``), cuBLAS's
              setup and the caching allocator's growth; it is booked as
              compile, as JAX books its first (compiling) call, and later
              calls as dispatch
  dispatch_s  host time to enqueue the step's kernels (launch overhead:
              the per-step cost ``make_multi_step`` amortizes)
  execute_s   host-sync stall: time blocked in the device fence after
              dispatch returned
  launches    device launches this record covers (1 for a fused step)
  steps       optimizer steps it covers (K for a fused-K launch)
  tokens/flops  analytic accounting from ``util/flops.py``: tokens_per_s
              and MFU against the H100's bf16 peak times the device count

The fence (``_fence``) records a CUDA event on the stream of the step's
outputs after the step and waits for it; a step whose outputs lie on the
CPU has nothing to wait for.

Records land in a bounded per-process ring buffer. ``drain(sinks)`` hands
the records not yet drained to the caller's :class:`Sinks`
(``util/recorder_core.py``): each record as a timeline task event with the
``profile`` payload JAX's event store gets, and its observations of the
``rt_step_*`` series (``metric``). The JAX package pushes the same things
into its GCS and metrics registry, which the port does not import.

Enable with ``enable()`` or ``RT_STEP_PROFILER=1``; when disabled the hot
paths pay one predicate check per step and nothing else.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.util import flops as F
from ray_tpu_torch.util.memory import device_memory_stats
from ray_tpu_torch.util.recorder_core import Sinks

_enabled = os.environ.get("RT_STEP_PROFILER", "") not in ("", "0", "false")
_CAP = int(os.environ.get("RT_STEP_PROFILER_CAP", "4096"))

_lock = threading.Lock()
_records: "deque[StepRecord]" = deque(maxlen=_CAP)
_seen_keys: set = set()
_seq = 0
_drained_seq = 0   # events sink watermark
_metrics_seq = 0   # metric sink watermark
_epoch = 0
_per_kind_step: Dict[str, int] = {}
# per-kind authoritative launch/step counters: a flight recorder that owns
# the instrumentation point registers a source here and summary(kind)
# reads ITS counts, so the two can never drift apart
_launch_sources: Dict[str, Any] = {}  # rt: guarded-by(_lock)

#: the series a drain observes, under the JAX package's names
SERIES = {
    "wall": "rt_step_time_seconds",
    "device": "rt_step_device_time_seconds",
    "mfu": "rt_step_mfu",
    "toks": "rt_step_tokens_per_s",
    "launches": "rt_step_launches_total",
}


def register_launch_source(kind: str, fn: Any) -> None:
    """Register ``fn() -> Optional[{"launches": int, "steps": int}]`` as
    the authoritative launch/step counter for ``kind``. Idempotent; a
    source returning None (nothing recorded yet) defers back to the
    profiler's own records."""
    with _lock:
        _launch_sources[kind] = fn


def is_enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop buffered records and compile-key memory (tests; fresh runs).
    Bumps the drain epoch so a post-reset run's records get fresh event
    ids instead of overwriting the previous run's (seq restarts)."""
    global _seq, _drained_seq, _metrics_seq, _epoch
    with _lock:
        _records.clear()
        _seen_keys.clear()
        _per_kind_step.clear()
        _seq = 0
        _drained_seq = 0
        _metrics_seq = 0
        _epoch += 1


@dataclasses.dataclass
class StepRecord:
    kind: str            # "train" | caller-defined
    name: str            # preset / caller label
    step: int            # per-(process, kind) sequence number
    seq: int             # process-global sequence (drain watermark)
    t_start: float       # epoch seconds (timeline lane placement)
    wall_s: float
    compile_s: float
    dispatch_s: float
    execute_s: float
    launches: int
    tokens: int
    flops: float
    tokens_per_s: float
    mfu: float
    first_call: bool
    meta: Dict[str, Any]
    hbm_peak_bytes: int = 0  # max per-device peak memory (0 = no CUDA)
    # optimizer steps this record covers: a fused-K train launch has
    # launches=1, steps=K
    steps: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---- measurement ------------------------------------------------------------

def first_cuda_tensor(out: Any) -> Optional[torch.Tensor]:
    """The first CUDA tensor in a (nested dict/list/tuple) output, or
    None."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor) and x.is_cuda:
            return x
    return None


def _fence(out: Any) -> None:
    """Prove the step finished on the device: record a CUDA event on the
    current stream of the outputs' device, after the step's work, and
    wait for it. CPU outputs are finished when the call returns."""
    t = first_cuda_tensor(out)
    if t is None:
        return
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    ev.synchronize()


def _peak_total() -> float:
    """Peak FLOP/s of the device a profiled step runs on: the H100's dense
    bf16 rate (the port's steps run on one device until the mesh is
    ported; other visible devices do none of the work)."""
    return F.H100_BF16_PEAK_FLOPS


def _hbm_peak_bytes() -> int:
    """Max per-device peak memory across local CUDA devices (0 without
    CUDA)."""
    try:
        return max((d["peak_bytes_in_use"] for d in device_memory_stats()),
                   default=0)
    except Exception:  # noqa: BLE001 — profiling must never fail the step
        return 0


def record(kind: str, *, name: str = "", t_start: Optional[float] = None,
           wall_s: float, compile_s: float = 0.0, dispatch_s: float = 0.0,
           execute_s: float = 0.0, launches: int = 1, tokens: int = 0,
           flops: float = 0.0, first_call: bool = False,
           steps: int = 1,
           meta: Optional[Dict[str, Any]] = None) -> "StepRecord":
    """Append one step record (hot paths that time themselves call this
    directly; steps go through ``profiled_call``)."""
    global _seq
    tok_s = tokens / wall_s if wall_s > 0 and tokens else 0.0
    mfu = (F.mfu(flops, wall_s, 1, _peak_total())
           if flops > 0 and wall_s > 0 else 0.0)
    hbm_peak = _hbm_peak_bytes()
    with _lock:
        _seq += 1
        step = _per_kind_step.get(kind, 0)
        _per_kind_step[kind] = step + 1
        rec = StepRecord(
            kind=kind, name=name, step=step, seq=_seq,
            t_start=time.time() - wall_s if t_start is None else t_start,
            wall_s=wall_s, compile_s=compile_s, dispatch_s=dispatch_s,
            execute_s=execute_s, launches=launches, tokens=tokens,
            flops=flops, tokens_per_s=tok_s, mfu=mfu,
            first_call=first_call, meta=dict(meta or {}),
            hbm_peak_bytes=hbm_peak, steps=max(1, steps))
        _records.append(rec)
    return rec


def profiled_call(kind: str, fn, args: Tuple = (), kwargs=None, *,
                  key: Any = None, name: str = "", tokens: int = 0,
                  flops: float = 0.0, launches: int = 1, steps: int = 1,
                  meta: Optional[Dict[str, Any]] = None):
    """Run ``fn(*args, **kwargs)`` as one profiled step.

    ``key`` identifies the program: its first call through here books the
    call's host time as ``compile_s``, later calls as ``dispatch_s``. Keys
    must be STABLE program identities (config/shape tuples, or a counter
    minted when the program is built), never ``id()`` of a collectable
    object, which CPython reuses. Disabled: straight call, no fence, no
    record.
    """
    kwargs = kwargs or {}
    if not _enabled:
        return fn(*args, **kwargs)
    first = False
    if key is not None:
        with _lock:
            first = key not in _seen_keys
    t_epoch = time.time()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    t1 = time.perf_counter()
    if first:
        # book the key only on success: a failed first call (OOM, shape
        # error) must not make the retry's first call look like dispatch
        with _lock:
            _seen_keys.add(key)
    _fence(out)
    t2 = time.perf_counter()
    record(kind, name=name, t_start=t_epoch, wall_s=t2 - t0,
           compile_s=(t1 - t0) if first else 0.0,
           dispatch_s=0.0 if first else (t1 - t0),
           execute_s=t2 - t1, launches=launches, tokens=tokens,
           flops=flops, first_call=first, steps=steps, meta=meta)
    return out


# ---- access -----------------------------------------------------------------

def records(kind: Optional[str] = None) -> List[StepRecord]:
    with _lock:
        out = list(_records)
    return [r for r in out if kind is None or r.kind == kind]


def summary(kind: Optional[str] = None) -> Dict[str, Any]:
    """Aggregates: steady-state means exclude first-call (compile) steps
    so one compile doesn't drown N executes."""
    rs = records(kind)
    if not rs:
        return {}
    steady = [r for r in rs if not r.first_call] or rs
    n = len(steady)
    wall = sum(r.wall_s for r in steady)
    launches = sum(r.launches for r in rs)
    steps = sum(r.steps for r in rs)
    launch_source = None
    if kind is not None:
        with _lock:
            src = _launch_sources.get(kind)
        if src is not None:
            try:
                joined = src()
            except Exception:  # noqa: BLE001 — a broken source must not
                joined = None  # take the summary down
            if joined and joined.get("launches"):
                launches = int(joined["launches"])
                steps = int(joined.get("steps", steps))
                launch_source = "recorder"
    return {
        **({"launch_source": launch_source} if launch_source else {}),
        "records": len(rs),
        "compile_s": sum(r.compile_s for r in rs),
        "mean_wall_s": wall / n,
        "mean_dispatch_s": sum(r.dispatch_s for r in steady) / n,
        "mean_execute_s": sum(r.execute_s for r in steady) / n,
        "launches": launches,
        "steps": steps,
        # fused-K attribution: optimizer steps per device launch, and the
        # per-STEP wall once fused (mean_wall_s is per record: one launch)
        "mean_steps_per_launch": steps / max(1, launches),
        "per_step_wall_s": wall / sum(r.steps for r in steady),
        "tokens": sum(r.tokens for r in rs),
        "tokens_per_s": (sum(r.tokens for r in steady) / wall
                         if wall > 0 else 0.0),
        "mean_mfu": sum(r.mfu for r in steady) / n,
        "peak_hbm_bytes": max((r.hbm_peak_bytes for r in rs), default=0),
    }


# ---- drain ------------------------------------------------------------------

def _observations(rec: StepRecord):
    """(series, op, value, tags) of one record, as JAX observes them."""
    tags = {"kind": rec.kind}
    yield SERIES["wall"], "observe", rec.wall_s, tags
    yield SERIES["device"], "observe", rec.execute_s, tags
    if rec.flops > 0:
        yield SERIES["mfu"], "observe", rec.mfu, tags
    if rec.tokens > 0:
        yield SERIES["toks"], "observe", rec.tokens_per_s, tags
    yield SERIES["launches"], "inc", float(rec.launches), tags


def drain(sinks: Sinks) -> int:
    """Hand the records not yet drained to ``sinks``: their metric
    observations to ``sinks.metric`` and one timeline task event each to
    ``sinks.events``. Each sink has its own watermark, which advances
    only after that sink returned, so a sink that raises gets the same
    records again on the next call. Returns the number of events
    shipped."""
    global _drained_seq, _metrics_seq
    with _lock:
        pending_metrics = [r for r in _records if r.seq > _metrics_seq]
        pending = [r for r in _records if r.seq > _drained_seq]
        epoch = _epoch
    if sinks.metric is not None and pending_metrics:
        try:
            for r in pending_metrics:
                for obs in _observations(r):
                    sinks.metric(*obs)
        except Exception:  # noqa: BLE001 — observability must not take
            pass            # the workload down
        else:
            with _lock:
                if _epoch == epoch:
                    _metrics_seq = max(_metrics_seq,
                                       pending_metrics[-1].seq)
    if sinks.events is None or not pending:
        return 0
    node = os.uname().nodename
    pid = os.getpid()
    events = [{
        "task_id": f"step:{node}:{pid}:{epoch}:{r.seq}",
        "name": f"{r.kind}:{r.name}" if r.name else r.kind,
        "state": "FINISHED", "node_id": node,
        "times": {"RUNNING": r.t_start,
                  "FINISHED": r.t_start + r.wall_s},
        "profile": r.to_dict()} for r in pending]
    try:
        sinks.events(events)
    except Exception:  # noqa: BLE001
        return 0
    with _lock:
        if _epoch == epoch:  # a reset() mid-push restarted the seq space
            _drained_seq = max(_drained_seq, pending[-1].seq)
    return len(pending)
