"""Chrome-trace (Perfetto) timeline of the step profiler's records (the
port's copy of the step lanes of ``ray_tpu/util/timeline.py``).

Each step record becomes a ``step`` category span on a ``step:<kind>``
track, with a ``compile`` sub-span at its front (the first call's time)
and a ``sync`` sub-span at its tail (the post-dispatch device stall), as
JAX's ``_step_lanes`` lays them out.

JAX's ``timeline()`` also draws task, phase, memory, failure, engine and
serve lanes from the cluster's task-event store. Those wait for the
runtime's tooling (ROADMAP item R5); here the events come from the caller,
as ``step_profiler.drain`` hands them to ``Sinks.events``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional


def step_lanes(ev: Dict[str, Any], prof: Dict[str, Any]
               ) -> List[Dict[str, Any]]:
    """One step record -> its Perfetto lanes: the full step span plus
    compile (front of the span) and sync (tail: the post-dispatch device
    stall) sub-spans where nonzero."""
    pid = ev.get("node_id") or "node"
    tid = f"step:{prof.get('kind', 'step')}"
    ts = prof["t_start"] * 1e6
    wall = max(0.0, prof.get("wall_s", 0.0)) * 1e6
    out = [{
        "name": ev.get("name") or prof.get("kind", "step"),
        "cat": "step", "ph": "X", "ts": ts, "dur": wall,
        "pid": pid, "tid": tid,
        "args": {"step": prof.get("step"), "tokens": prof.get("tokens"),
                 "tokens_per_s": prof.get("tokens_per_s"),
                 "mfu": prof.get("mfu"),
                 "launches": prof.get("launches")},
    }]
    compile_s = prof.get("compile_s") or 0.0
    if compile_s > 0:
        out.append({"name": "compile", "cat": "compile", "ph": "X",
                    "ts": ts, "dur": compile_s * 1e6,
                    "pid": pid, "tid": tid})
    sync_s = prof.get("execute_s") or 0.0
    if sync_s > 0:
        out.append({"name": "sync", "cat": "sync", "ph": "X",
                    "ts": ts + wall - sync_s * 1e6, "dur": sync_s * 1e6,
                    "pid": pid, "tid": tid})
    return out


def step_timeline(events: Iterable[Dict[str, Any]],
                  filename: Optional[str] = None) -> List[Dict[str, Any]]:
    """The Perfetto events of the step profiler's timeline events (the
    dicts ``step_profiler.drain`` passes to ``Sinks.events``; events
    without a ``profile`` payload are skipped), written as JSON to
    ``filename`` when given."""
    trace: List[Dict[str, Any]] = []
    for ev in events:
        prof = ev.get("profile")
        if prof:
            trace.extend(step_lanes(ev, prof))
    if filename:
        with open(filename, "w", encoding="utf-8") as f:
            json.dump(trace, f)
    return trace
