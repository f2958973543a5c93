"""A fleet of RL workers: actors of the port's runtime, or objects in this
process.

JAX runs its EnvRunners and its ES, ARS and LC0 workers as actors. So
does the port wherever its runtime is initialized (``ray_tpu_torch.init()``,
either backend). Without a runtime (where JAX raises) the workers are
plain objects in this process and a remote call is a method call. A
:class:`Fleet` makes that choice once, when it is built, and every call
to its members goes through it.

On actors a member holds no GPU, so it is built on the CPU (JAX:
"jitted CPU inference") and takes its params as host tensors
(:meth:`Fleet.put`); an actor that cannot be created fails the first
call, and there is no quiet fall back to members in process. In process
the members live on the caller's device, and a member whose call raises
is rebuilt from its constructor arguments while it has restarts left, as
an actor restart would.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rl import models

logger = logging.getLogger(__name__)


class _Call:
    """A call submitted in process: it runs when its value is read."""

    __slots__ = ("i", "method", "args")

    def __init__(self, i: int, method: str, args: tuple):
        self.i, self.method, self.args = i, method, args


class Fleet:
    """One member of ``cls`` for each dict of constructor keywords in
    ``args``, built on ``device`` in process or on the CPU as actors with
    ``num_cpus``, ``runtime_env`` and ``max_restarts``."""

    def __init__(self, cls, args: List[Dict[str, Any]], device: DeviceLike,
                 *, num_cpus: Optional[float] = None,
                 runtime_env: Optional[Dict[str, Any]] = None,
                 max_restarts: int = 0):
        self.on_actors = rt.is_initialized()
        self._cls = cls
        dev = "cpu" if self.on_actors else device
        self._args = [dict(kw, device=dev) for kw in args]
        self.restarts_left = [max_restarts] * len(args)
        if self.on_actors:
            opts: Dict[str, Any] = {"max_restarts": max_restarts}
            if num_cpus is not None:
                opts["num_cpus"] = num_cpus
            if runtime_env is not None:
                opts["runtime_env"] = runtime_env
            actor = rt.remote(cls).options(**opts)
            self.members = [actor.remote(**kw) for kw in self._args]
        else:
            self.members = [cls(**kw) for kw in self._args]
        self._next = 0  # the in-process round robin of ``next_ready``

    def __len__(self) -> int:
        return len(self.members)

    def put(self, tree):
        """``tree`` as the members take it: on actors a reference to one
        stored copy in host tensors, in process the tree itself."""
        return rt.put(models.host_tree(tree)) if self.on_actors else tree

    def submit(self, i: int, method: str, *args):
        """Start ``members[i].method(*args)``: on actors its ref, in
        process a call that runs when :meth:`get` reads it."""
        if self.on_actors:
            return getattr(self.members[i], method).remote(*args)
        return _Call(i, method, args)

    def get(self, pending):
        """The value of a submitted call. In process the call runs here;
        when it raises, the member is rebuilt if it has restarts left and
        the error propagates (the call's result is lost)."""
        if self.on_actors:
            return rt.get(pending)
        i = pending.i
        try:
            return getattr(self.members[i], pending.method)(*pending.args)
        except Exception:
            if self.restarts_left[i] > 0:
                self.restarts_left[i] -= 1
                self.members[i] = self._cls(**self._args[i])
            raise

    def next_ready(self, pending: Dict[int, Any]) -> int:
        """The member of ``pending`` (member index -> submitted call)
        whose value to read next: on actors the first that ``wait``
        gives, in process the next in turn, round robin."""
        if self.on_actors:
            refs = {ref: i for i, ref in pending.items()}
            ready, _ = rt.wait(list(refs), num_returns=1)
            return refs[ready[0]]
        n = len(self.members)
        for k in range(n):
            i = (self._next + k) % n
            if i in pending:
                self._next = (i + 1) % n
                return i
        raise RuntimeError("no call in flight")

    def gather(self, method: str, args: List[tuple]) -> List:
        """``members[i % n].method(*args[i])`` for each ``args[i]``, the
        values in submission order (JAX's ``ray_tpu.get`` of the list);
        on actors every call is submitted before any is read. A failed
        call raises."""
        n = len(self.members)
        pending = [self.submit(i % n, method, *a)
                   for i, a in enumerate(args)]
        if self.on_actors:
            return rt.get(pending)
        return [self.get(p) for p in pending]

    def gather_tolerant(self, method: str, *args) -> List:
        """``method(*args)`` on every member, DROPPING failed results
        instead of failing (reference:
        FaultTolerantActorManager.foreach_worker); raises the last error
        only when every member failed. Every call is submitted before any
        is read; a dead actor restarts in the background
        (``max_restarts``) to serve the next call."""
        pending = [self.submit(i, method, *args)
                   for i in range(len(self.members))]
        out, last_err = [], None
        for i, p in enumerate(pending):
            try:
                out.append(self.get(p))
            except Exception as e:  # noqa: BLE001 — result lost, not fatal
                last_err = e
                logger.warning("%s %d %s failed (%s: %s) — dropping its "
                               "result; it restarts if it has restarts "
                               "left", self._cls.__name__, i, method,
                               type(e).__name__, str(e)[:120])
        if not out and pending:
            raise last_err
        return out

    def kill(self) -> None:
        """Release the members: actors are killed without restarts
        (JAX's); in process a member's ``shutdown`` (an external runner's
        HTTP server) runs where it has one."""
        for m in self.members:
            try:
                if self.on_actors:
                    rt.kill(m, no_restart=True)
                elif hasattr(m, "shutdown"):
                    m.shutdown()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self.members.clear()
