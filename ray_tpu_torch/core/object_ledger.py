"""Ownership/reference ledger: the per-process byte-side twin of tracing.

Reference analog: the core worker's ``ReferenceCounter``
(``core_worker/reference_count.h``) plus the aggregation behind
``ray memory`` / ``memory_summary()``: every process keeps a table of the
objects it owns (or holds refs to) — owner address, size, where the value
lives (memory store / plasma / local store), ref kinds (live local
``ObjectRef``s, uses as submitted-task args, gets served), creation time and
— behind ``RT_RECORD_REF_CREATION_SITES=1`` (Ray parity:
``RAY_record_ref_creation_sites``) — the Python call site that created the
ref.

Local-ref liveness is tracked with ``weakref.finalize`` on the ``ObjectRef``
objects themselves, so a ref dropped by user code decrements the count
without any explicit release call. The table is bounded; dead+freed entries
are evicted first.

Snapshots ride the same push plane as metrics: a daemon thread pushes this
process's ledger to the GCS KV under ``@memobj/<node>:<pid>`` so
``memory_summary()`` in the driver (and ``rt memory`` from outside) can join
owner/call-site info against the raylets' store reports. Everything here is
best-effort: the ledger must never fail or slow the data plane beyond a few
dict operations per ref.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

_KV_PREFIX = "@memobj/"
_PUSH_INTERVAL_S = 5.0
_MAX_ENTRIES = 65536
_SNAPSHOT_CAP = 2000  # largest-first entries per pushed snapshot


class _Entry:
    __slots__ = ("oid", "owner", "size", "where", "created_at", "call_site",
                 "local_refs", "task_arg_uses", "get_count", "last_get_at",
                 "freed")

    def __init__(self, oid: str):
        self.oid = oid
        self.owner: Optional[str] = None
        self.size: int = 0
        self.where: str = "unknown"   # memory | plasma | local | unknown
        self.created_at: float = time.time()
        self.call_site: str = ""
        self.local_refs: int = 0      # live ObjectRef objects in this process
        self.task_arg_uses: int = 0   # times passed as a remote-call argument
        self.get_count: int = 0       # times resolved through get()
        self.last_get_at: float = 0.0
        self.freed: bool = False

    def state(self) -> str:
        if self.freed:
            return "freed"
        return self.where

    def to_dict(self) -> Dict[str, Any]:
        return {"oid": self.oid, "owner": self.owner, "size": self.size,
                "state": self.state(), "created_at": self.created_at,
                "call_site": self.call_site, "local_refs": self.local_refs,
                "task_arg_uses": self.task_arg_uses,
                "get_count": self.get_count,
                "last_get_at": self.last_get_at}


class OwnershipLedger:
    def __init__(self):
        self._entries: Dict[str, _Entry] = {}  # rt: guarded-by(_lock)
        self._lock = threading.Lock()
        self._pusher: Optional[threading.Thread] = None
        self._record_sites: Optional[bool] = None  # lazy config read
        # deref backlog: ``_deref`` runs from weakref finalizers, which the
        # cyclic GC can fire on ANY thread at ANY allocation — including on
        # a thread that is inside one of the ``_lock`` regions below (e.g.
        # ``_entry`` allocating). A finalizer that takes ``_lock`` would
        # self-deadlock that thread and wedge every ObjectRef creation in
        # the process forever (seen live: a chaos kill-storm froze the
        # serve proxy's handle pool for 10+ minutes). Finalizers only
        # append here (deque.append is atomic under the GIL); the backlog
        # drains inside the next locked operation.
        self._pending_derefs: "collections.deque[str]" = collections.deque()

    # ---- config -------------------------------------------------------------
    def _sites_enabled(self) -> bool:
        if self._record_sites is None:
            from ray_tpu_torch._private.config import get_config

            self._record_sites = get_config().record_ref_creation_sites
        return self._record_sites

    @staticmethod
    def _call_site() -> str:
        """First stack frame outside ray_tpu_torch — where user code made the ref."""
        import traceback

        for frame in reversed(traceback.extract_stack(limit=24)):
            fname = frame.filename.replace(os.sep, "/")
            if "/ray_tpu_torch/" not in fname and "object_ledger" not in fname:
                return f"{os.path.basename(frame.filename)}:" \
                       f"{frame.lineno} in {frame.name}"
        return ""

    # ---- recording ----------------------------------------------------------
    def _entry_locked(self, oid_hex: str) -> _Entry:
        e = self._entries.get(oid_hex)
        if e is None:
            if len(self._entries) >= _MAX_ENTRIES:
                self._evict_locked()
            e = self._entries[oid_hex] = _Entry(oid_hex)
        return e

    def _evict_locked(self) -> None:
        """Freed/dead entries first, oldest first; always frees some room."""
        items = sorted(self._entries.values(),
                       key=lambda e: (not (e.freed or e.local_refs == 0),
                                      e.created_at))
        for e in items[:max(1, _MAX_ENTRIES // 8)]:
            self._entries.pop(e.oid, None)

    def record_ref(self, ref) -> None:
        """Called from ObjectRef.__init__ (guarded by the config flag)."""
        try:
            oid_hex = ref.hex()
            site = self._call_site() if self._sites_enabled() else ""
            with self._lock:
                self._drain_derefs_locked()
                e = self._entry_locked(oid_hex)
                e.local_refs += 1
                if ref.owner_address() and not e.owner:
                    e.owner = ref.owner_address()
                if site and not e.call_site:
                    e.call_site = site
            weakref.finalize(ref, self._deref, oid_hex)
        except Exception:  # noqa: BLE001 — bookkeeping must never raise
            pass

    def _deref(self, oid_hex: str) -> None:
        # weakref-finalizer context: NEVER take ``_lock`` here (the GC can
        # fire this mid-allocation on a thread already holding it — see
        # ``_pending_derefs``); just enqueue, the next locked op drains
        self._pending_derefs.append(oid_hex)

    def _drain_derefs_locked(self) -> None:
        while True:
            try:
                oid_hex = self._pending_derefs.popleft()
            except IndexError:
                return
            e = self._entries.get(oid_hex)
            if e is not None and e.local_refs > 0:
                e.local_refs -= 1

    def record_put(self, oid_hex: str, size: int, where: str,
                   owner: Optional[str] = None) -> None:
        with self._lock:
            self._drain_derefs_locked()
            e = self._entry_locked(oid_hex)
            e.size = size
            e.where = where
            if owner:
                e.owner = owner

    def record_task_arg(self, oid_hex: str) -> None:
        with self._lock:
            self._drain_derefs_locked()
            e = self._entries.get(oid_hex)
            if e is not None:
                e.task_arg_uses += 1

    def record_get(self, oid_hex: str) -> None:
        with self._lock:
            self._drain_derefs_locked()
            e = self._entries.get(oid_hex)
            if e is not None:
                e.get_count += 1
                e.last_get_at = time.time()

    def record_freed(self, oid_hex: str) -> None:
        with self._lock:
            self._drain_derefs_locked()
            e = self._entries.get(oid_hex)
            if e is not None:
                e.freed = True

    # ---- access -------------------------------------------------------------
    def snapshot(self, cap: int = _SNAPSHOT_CAP) -> List[Dict[str, Any]]:
        with self._lock:
            self._drain_derefs_locked()
            entries = [e.to_dict() for e in self._entries.values()
                       if not e.freed]
        entries.sort(key=lambda d: -d["size"])
        return entries[:cap]

    def leak_suspects(self, age_s: Optional[float] = None
                      ) -> List[Dict[str, Any]]:
        """Objects older than ``age_s`` whose only references are local refs
        held in this process (never consumed by a task, not freed)."""
        if age_s is None:
            from ray_tpu_torch._private.config import get_config

            age_s = get_config().memory_leak_age_s
        now = time.time()
        with self._lock:
            self._drain_derefs_locked()
            out = []
            for e in self._entries.values():
                if e.freed or e.local_refs <= 0:
                    continue
                if now - e.created_at < age_s:
                    continue
                if e.task_arg_uses == 0 and (
                        e.last_get_at == 0.0
                        or now - e.last_get_at >= age_s):
                    d = e.to_dict()
                    d["age_s"] = now - e.created_at
                    out.append(d)
        out.sort(key=lambda d: -d["size"])
        return out

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    # ---- KV push (same pattern as util/metrics._Registry) -------------------
    def ensure_pusher(self) -> None:
        if self._pusher is not None and self._pusher.is_alive():
            return
        self._pusher = threading.Thread(target=self._push_loop, daemon=True,
                                        name="rt-ledger-push")
        self._pusher.start()

    def kv_key(self) -> str:
        return _KV_PREFIX + f"{os.uname().nodename}:{os.getpid()}"

    def flush_now(self) -> None:
        """Push this process's ledger snapshot immediately (tests; summary)."""
        import ray_tpu_torch

        backend = ray_tpu_torch.global_worker()._require_backend()
        backend.kv_put(self.kv_key(), json.dumps({
            "t": time.time(),
            "owner": getattr(backend, "address", "local"),
            "objects": self.snapshot()}).encode())

    def retract(self, backend) -> None:
        """Delete this process's KV snapshot (shutdown): a dead process's
        ledger must not keep reporting its objects as held."""
        try:
            backend.kv_del(self.kv_key())
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass

    def _push_loop(self) -> None:
        import ray_tpu_torch

        while True:
            time.sleep(_PUSH_INTERVAL_S)
            try:
                if not ray_tpu_torch.is_initialized():
                    continue
                self.flush_now()
            except Exception:  # noqa: BLE001 — observability never takes
                pass  # the workload down


_ledger = OwnershipLedger()


def get_ledger() -> OwnershipLedger:
    return _ledger


_enabled: Optional[bool] = None


def enabled() -> bool:
    """One cached predicate on the hot ObjectRef path."""
    global _enabled
    if _enabled is None:
        try:
            from ray_tpu_torch._private.config import get_config

            _enabled = get_config().object_ledger
        except Exception:  # noqa: BLE001 — config not importable yet
            return False
    return _enabled


def reset_enabled_for_tests() -> None:
    global _enabled
    _enabled = None
    _ledger._record_sites = None
