"""Distributed-safe progress bars over the log plumbing.

Reference analog: ``python/ray/experimental/tqdm_ray.py`` — worker-side
``tqdm`` emits structured magic lines instead of terminal control codes
(which would interleave garbage across the worker->driver log echo);
the driver's log pump recognizes them and renders one compact,
rate-limited progress line per bar.

Worker side::

    from ray_tpu_torch.util.tqdm_rt import tqdm
    for row in tqdm(items, desc="ingest", total=len(items)):
        ...

Bars also work in the driver process directly (rendered locally).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Iterable, Iterator, Optional

MAGIC = "__rt_tqdm__:"
_UPDATE_INTERVAL_S = 0.5


class tqdm:
    """Minimal tqdm-compatible surface: iteration, ``update``, ``close``,
    ``set_description``. State updates ride as ``MAGIC + json`` lines."""

    _next_uid = [0]

    def __init__(self, iterable: Optional[Iterable] = None, *,
                 desc: str = "", total: Optional[int] = None,
                 file=None):
        self._iterable = iterable
        self.desc = desc
        if total is None and iterable is not None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        self.total = total
        self.n = 0
        self._start = time.monotonic()
        self._last_emit = 0.0
        self._file = file or sys.stdout
        self._closed = False
        tqdm._next_uid[0] += 1
        self._uid = tqdm._next_uid[0]

    # -- tqdm surface -----------------------------------------------------

    def __iter__(self) -> Iterator:
        assert self._iterable is not None, "no iterable given"
        completed = False
        try:
            for x in self._iterable:
                yield x
                self.update(1)
            completed = True
        finally:
            # an aborted loop must NOT read as finished in the log stream
            self.close(done=completed)

    def update(self, n: int = 1) -> None:
        self.n += n
        now = time.monotonic()
        if now - self._last_emit >= _UPDATE_INTERVAL_S:
            self._emit(now)

    def set_description(self, desc: str) -> None:
        self.desc = desc

    def close(self, done: bool = True) -> None:
        if not self._closed:
            self._closed = True
            self._emit(time.monotonic(), done=done)

    def __enter__(self) -> "tqdm":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- emission ---------------------------------------------------------

    def _emit(self, now: float, done: bool = False) -> None:
        self._last_emit = now
        state = {"uid": self._uid, "desc": self.desc, "n": self.n,
                 "total": self.total,
                 "rate": round(self.n / max(now - self._start, 1e-9), 1),
                 "done": done}
        if os.environ.get("RT_WORKER_ID"):
            # inside a worker: the magic line rides the log pump to the
            # driver, which renders it compactly
            print(MAGIC + json.dumps(state), file=self._file, flush=True)
        else:
            # driver/standalone process: render directly
            print(render_state(state), file=self._file, flush=True)


def render_state(state: Dict[str, Any]) -> str:
    """One compact text line for a bar state (driver-side display)."""
    desc = state.get("desc") or "progress"
    n, total = state.get("n", 0), state.get("total")
    rate = state.get("rate", 0.0)
    if total:
        pct = 100.0 * n / max(total, 1)
        body = f"{desc}: {n}/{total} ({pct:.0f}%) [{rate}/s]"
    else:
        body = f"{desc}: {n} [{rate}/s]"
    return body + (" done" if state.get("done") else "")


def maybe_render(line: str) -> Optional[str]:
    """If ``line`` is a bar magic line, return its rendered form (None =
    not a progress line; caller prints the raw line as usual)."""
    if not line.startswith(MAGIC):
        return None
    try:
        return render_state(json.loads(line[len(MAGIC):]))
    except ValueError:
        return None
