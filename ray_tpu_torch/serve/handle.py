"""DeploymentHandle: the client-side router for calling a deployment.

Reference analogs: ``serve/handle.py`` (``DeploymentHandle``,
``DeploymentResponse``) and ``serve/_private/router.py:328``
(``PowerOfTwoChoicesReplicaScheduler``). Routing is client-side: each handle
keeps a cached replica set (refreshed from the controller) plus local
in-flight counts, picks the less-loaded of two random replicas, and treats a
replica's REJECTED reply (over ``max_ongoing_requests``) as backpressure —
update the count, try another replica, back off.

Works from sync drivers (`.remote().result()`) and from async contexts —
proxies and replicas — (`await handle.remote(...)`).
"""

from __future__ import annotations

import asyncio
import os
import random
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.cluster import stream as rt_stream
from ray_tpu_torch.cluster.rpc import ChannelBroken
from ray_tpu_torch.exceptions import ActorError
from ray_tpu_torch.serve import obs
from ray_tpu_torch.serve.replica import REJECTED
from ray_tpu_torch.util import prefix_hash as _prefix

_REFRESH_TTL_S = 30.0   # fallback only — the long-poll thread pushes updates
_LONG_POLL_TIMEOUT_S = 10.0
_RETRY_BACKOFF_S = 0.02
_COLD_START_TIMEOUT_S = 60.0
# cache-affinity routing: how much MORE in-flight load the residency-
# preferred replica may carry before the router reverts to load-only —
# affinity is a bias, not an override (a warm replica at its admission
# ceiling still sheds to the cold one; the cold one then warms up)
_AFFINITY_SLACK = int(os.environ.get("RT_KV_AFFINITY_SLACK", "4"))


class _HandleMarker:
    """Placeholder for a DeploymentHandle inside pickled init args — the
    replica substitutes the real handle at construction (composition)."""

    def __init__(self, app_name: str, deployment_name: str):
        self.app_name = app_name
        self.deployment_name = deployment_name

    def __eq__(self, other):
        return (isinstance(other, _HandleMarker)
                and other.app_name == self.app_name
                and other.deployment_name == self.deployment_name)

    def __hash__(self):
        return hash((self.app_name, self.deployment_name))


def _resolve_handle_markers(obj: Any) -> Any:
    if isinstance(obj, _HandleMarker):
        return DeploymentHandle(obj.app_name, obj.deployment_name)
    if isinstance(obj, tuple):
        return tuple(_resolve_handle_markers(x) for x in obj)
    if isinstance(obj, list):
        return [_resolve_handle_markers(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _resolve_handle_markers(v) for k, v in obj.items()}
    return obj


class DeploymentResponse:
    """Future-like result of ``handle.remote()``."""

    def __init__(self, fut: "Future"):
        self._fut = fut

    def result(self, timeout: Optional[float] = None) -> Any:
        return self._fut.result(timeout)

    def __await__(self):
        return asyncio.wrap_future(self._fut).__await__()


class _RouterState:
    """Replica cache + local in-flight counts (shared per handle)."""

    def __init__(self, app: str, deployment: str):
        self.app = app
        self.deployment = deployment
        self.version = -1
        self.replicas: List[Tuple[str, Any]] = []  # (replica_id, actor handle)
        self.counts: Dict[str, int] = {}
        self.model_ids: Dict[str, List[str]] = {}  # replica -> loaded models
        # replica -> warm prefix digests (kv_residency piggybacked on
        # replies, like model_ids) — the cache-affinity routing signal
        self.kv_digests: Dict[str, frozenset] = {}
        self.fetched_at = 0.0
        self.lock = threading.Lock()
        self._poller: Optional[threading.Thread] = None
        self._poller_stop = threading.Event()

    def _controller(self):
        # rt: lint-allow(hot-path) import-cycle break (serve.api imports
        # this module); control-plane lookup, cached on the router state
        from ray_tpu_torch.serve.api import _get_controller

        return _get_controller()

    def _ensure_poller(self) -> None:
        """Long-poll push of the replica set (reference: LongPollClient,
        ``serve/_private/long_poll.py``): ONE outstanding blocked RPC per
        router instead of a 1s TTL poll per call. Locked: concurrent
        refresh() callers must not each start an (unstoppable) duplicate."""
        with self.lock:
            if self._poller is not None and self._poller.is_alive():
                return
            self._poller_stop.clear()
            self._poller = threading.Thread(
                target=self._poll_loop, daemon=True,
                name=f"rt-serve-poll-{self.app}-{self.deployment}")
            self._poller.start()

    def _poll_loop(self) -> None:
        failures = 0
        while not self._poller_stop.is_set():
            try:
                snap = ray_tpu_torch.get(
                    self._controller().get_replicas.remote(
                        self.app, self.deployment, self.version,
                        wait=True, timeout=_LONG_POLL_TIMEOUT_S),
                    timeout=_LONG_POLL_TIMEOUT_S + 10)
                self._apply(snap)
                failures = 0
            except Exception as e:
                msg = str(e)
                if ("serve is not running" in msg
                        or "event loop thread is stopped" in msg):
                    return  # backend/controller torn down: die NOW
                failures += 1
                if failures >= 10:
                    # controller gone (serve.shutdown / cluster teardown):
                    # exit instead of spinning forever; the next refresh()
                    # lazily restarts a poller if serve comes back
                    return
                if self._poller_stop.wait(1.0):
                    return

    def _apply(self, snap: Dict) -> None:
        with self.lock:
            self.fetched_at = time.time()
            if snap["version"] != self.version:
                self.version = snap["version"]
                self.replicas = snap["replicas"]
                self.counts = {rid: self.counts.get(rid, 0)
                               for rid, _ in self.replicas}
                self.model_ids = {
                    rid: self.model_ids.get(rid, [])
                    for rid, _ in self.replicas}
                self.kv_digests = {
                    rid: self.kv_digests.get(rid, frozenset())
                    for rid, _ in self.replicas}

    def refresh(self, force: bool = False) -> None:
        self._ensure_poller()
        now = time.time()
        with self.lock:
            if not force and now - self.fetched_at < _REFRESH_TTL_S:
                return
        snap = ray_tpu_torch.get(self._controller().get_replicas.remote(
            self.app, self.deployment, self.version), timeout=30)
        self._apply(snap)

    def wake_and_wait(self) -> None:
        """Scale-to-zero cold start: ask the controller for capacity and
        wait until a replica appears."""
        deadline = time.time() + _COLD_START_TIMEOUT_S
        ray_tpu_torch.get(self._controller().wake.remote(self.app, self.deployment))
        while time.time() < deadline:
            self.refresh(force=True)
            if self.replicas:
                return
            time.sleep(0.1)
        raise TimeoutError(
            f"no replicas for {self.app}/{self.deployment} after "
            f"{_COLD_START_TIMEOUT_S}s")

    def _kv_score(self, replica_id: str,
                  prefix_digests: Optional[List[str]]) -> int:
        """Residency score: how long a prefix of the request this replica
        holds warm. ``prefix_digests`` is longest-first, so the FIRST
        digest the replica's reported set contains wins; 0 = no known
        residency (unknown replicas fall back to load-only). Caller holds
        the lock."""
        if not prefix_digests:
            return 0
        held = self.kv_digests.get(replica_id)
        if not held:
            return 0
        n = len(prefix_digests)
        for i, d in enumerate(prefix_digests):
            if d in held:
                return n - i
        return 0

    def pick(self, model_id: Optional[str] = None,
             prefix_digests: Optional[List[str]] = None) -> Tuple[str, Any]:
        """Power-of-two-choices by local in-flight count; with a multiplexed
        model id, replicas already holding the model win (reference:
        model-id-aware routing in the handle, ``serve/multiplex.py``).

        Cache-affinity bias: when the request carries prompt-prefix
        digests (the LLM protocol) and the sampled pair's residency
        scores differ, the replica holding the longer warm prefix wins —
        unless it is already ``_AFFINITY_SLACK`` requests busier than the
        alternative, where load-only resumes (Ray's locality-aware
        scheduling idea applied to KV residency at the router)."""
        with self.lock:
            reps = self.replicas
            if not reps:
                raise LookupError("no replicas")
            if model_id:
                holding = [r for r in reps
                           if model_id in self.model_ids.get(r[0], ())]
                if holding:
                    reps = holding
            if len(reps) == 1:
                choice = reps[0]
            else:
                a, b = random.sample(reps, 2)
                ca = self.counts.get(a[0], 0)
                cb = self.counts.get(b[0], 0)
                sa = self._kv_score(a[0], prefix_digests)
                sb = self._kv_score(b[0], prefix_digests)
                if sa != sb:
                    warm, cold = (a, b) if sa > sb else (b, a)
                    cw = ca if warm is a else cb
                    cc = cb if warm is a else ca
                    choice = warm if cw - cc <= _AFFINITY_SLACK else cold
                else:
                    choice = a if ca <= cb else b
            self.counts[choice[0]] = self.counts.get(choice[0], 0) + 1
            return choice

    def complete(self, replica_id: str, rejected_ongoing: Optional[int] = None,
                 model_ids: Optional[List[str]] = None,
                 kv_digests: Optional[List[str]] = None):
        with self.lock:
            if rejected_ongoing is not None:
                # replica told us its real queue depth — adopt it
                self.counts[replica_id] = rejected_ongoing
            else:
                self.counts[replica_id] = max(
                    0, self.counts.get(replica_id, 1) - 1)
            if model_ids is not None:
                self.model_ids[replica_id] = model_ids
            if kv_digests is not None:
                self.kv_digests[replica_id] = frozenset(kv_digests)

    def note_models(self, replica_id: str, model_ids: Optional[List[str]],
                    kv_digests: Optional[List[str]] = None):
        with self.lock:
            if model_ids is not None:
                self.model_ids[replica_id] = model_ids
            if kv_digests is not None:
                self.kv_digests[replica_id] = frozenset(kv_digests)


# one shared pool for all sync-path handle calls in this process
_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _shared_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=32,
                                       thread_name_prefix="rt-serve-handle")
        return _pool


def _reset_pool() -> None:
    """Drop the shared pools on serve shutdown: calls stranded mid-RPC
    against a dead cluster must not occupy slots and starve the next serve
    instance (one bounded pool is shared process-wide)."""
    global _pool, _stream_pool
    with _pool_lock:
        old, _pool = _pool, None
        old_stream, _stream_pool = _stream_pool, None
    if old is not None:
        old.shutdown(wait=False)
    if old_stream is not None:
        old_stream.shutdown(wait=False)


# the PULL path's wide thread pool: each live pulled stream parks
# one thread in a blocking next_chunks RPC. With the push transport this
# pool is the FALLBACK only — it is created lazily the first time a
# stream actually runs pull mode (RT_STREAM_PULL=1, a producer that
# refused the subscription, or a broken push channel), so the default
# push path holds zero stream threads.
_stream_pool: Optional[ThreadPoolExecutor] = None


def _stream_executor() -> ThreadPoolExecutor:
    global _stream_pool
    with _pool_lock:
        if _stream_pool is None:
            _stream_pool = ThreadPoolExecutor(
                max_workers=128, thread_name_prefix="rt-serve-stream")
        return _stream_pool


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment response.

    Default transport is PUSH (cluster/stream.py): one
    ``stream_subscribe`` RPC binds the replica's pump to a one-way frame
    channel on the existing connection, and ``__anext__`` drains a local
    queue — no executor hop, no per-burst actor RPC, O(1) RPCs per
    request regardless of token count. The pull path
    (``next_chunks`` batches through the wide stream pool) remains as
    the fallback: primary under ``RT_STREAM_PULL=1``, automatic when the
    push channel breaks (reconnect) — ``resume_pull`` replays the
    undelivered tail so the switch is token-exact."""

    _END = object()
    _PULL = object()  # transport decided: caller should run the pull path

    def __init__(self, router: "_RouterState", rid: str, actor,
                 stream_id: str):
        self._router = router
        self._rid = rid
        self._actor = actor
        self._stream_id = stream_id
        self._buf: List[Any] = []   # decoded items not yet handed out
        self._wire: List[Any] = []  # raw non-inline frames awaiting decode
        self._done = False
        self._delivered = 0         # items handed to the consumer
        self._rpcs = 1              # the handle_request RPC itself
        self._transport: Optional[str] = None  # push | pull | fallback
        self._channel = None
        self._backend = None
        self._reported = False

    # -- transport ---------------------------------------------------------
    def _backend_ref(self):
        if self._backend is None:
            self._backend = ray_tpu_torch.global_worker()._require_backend()
        return self._backend

    async def _subscribe_on_io(self) -> None:
        """One-time transport decision; runs on the backend io loop."""
        if self._transport is not None:
            return
        if not rt_stream.push_enabled():
            self._transport = "pull"
            return
        backend = self._backend_ref()
        conn = backend._actor_conns.get(self._actor._actor_id.hex())
        addr = getattr(conn, "address", None)
        if addr is None:
            self._transport = "pull"
            return
        try:
            self._rpcs += 1
            ch = await rt_stream.subscribe(backend, addr, self._stream_id)
        except Exception:  # noqa: BLE001 — any transport hiccup: pull
            self._transport = "pull"
            return
        if ch is None:
            self._transport = "pull"
            return
        self._channel = ch
        self._transport = "push"

    async def _take_on_io(self):
        """One blocking channel take, then an opportunistic drain of
        whatever the producer already pushed: returns ``(first, rest)``
        so the caller pays ONE loop hop per burst, not per token (the
        push twin of the pull path's wide next_chunks batches). Also
        ``_END`` or ``_PULL`` (transport decided against push); runs on
        the backend io loop. Raises ChannelBroken to trigger the pull
        fallback."""
        await self._subscribe_on_io()
        if self._transport != "push":
            return self._PULL
        backend = self._backend_ref()
        if self._wire:
            item, _ = await rt_stream.take_decoded_wire(
                backend, self._wire.pop(0))
            return (item, [])
        item, done = await rt_stream.take_decoded(backend, self._channel)
        if done:
            return self._END
        rest, parked = rt_stream.inline_values(
            self._channel.take_available())
        self._wire.extend(parked)
        return (item, rest)

    async def _drain_decoded_on_io(self) -> Tuple[List[Any], bool]:
        """Fallback prologue: decode everything already received locally
        (channel buffer + parked wire frames) so the resume point counts
        every item we physically possess."""
        wire, self._wire = self._wire, []
        return await rt_stream.decode_backlog(self._backend_ref(),
                                              self._channel, wire)

    def _begin_fallback_blocking(self) -> None:
        """The push channel broke: close it, reclaim the undelivered tail
        from the replica (one RPC), and continue on the pull path."""
        self._transport = "fallback"
        backend = self._backend_ref()
        # generous bound: a parked plasma-oid frame may legitimately take
        # up to its 60s resolve inside the drain
        drained, done = asyncio.run_coroutine_threadsafe(
            self._drain_decoded_on_io(), backend.loop).result(120)
        self._buf.extend(drained)
        ch, self._channel = self._channel, None
        if ch is not None:
            ch.close()
        if done:
            self._mark_done()
            return
        possessed = self._delivered + len(self._buf)
        try:
            self._rpcs += 1
            items, done = ray_tpu_torch.get(self._actor.resume_pull.remote(
                self._stream_id, possessed))
        except Exception:
            self._done = True
            self._router.complete(self._rid)
            self._finish_metrics()
            raise
        self._buf.extend(items)
        if done:
            self._mark_done()

    def _mark_done(self) -> None:
        if not self._done:
            self._done = True
            self._router.complete(self._rid)

    def _abort_stream(self) -> None:
        """Stream failed while push was live: the producer settles on a
        closed-credit it will never get (the consumer stops iterating on
        the raised error), so the replica slot must be released
        explicitly — close the channel and cancel the replica stream
        (idempotent against an already-finished stream)."""
        ch, self._channel = self._channel, None
        if ch is not None:
            ch.close()
        try:
            self._actor.cancel_stream.remote(self._stream_id)
        except Exception:  # noqa: BLE001 — actor already gone
            pass

    def _finish_metrics(self) -> None:
        if self._reported:
            return
        self._reported = True
        rt_stream.observe_request_rpcs(self._transport or "pull",
                                       self._rpcs)

    # -- iteration ---------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._buf:
                self._delivered += 1
                return self._buf.pop(0)
            if self._done:
                self._finish_metrics()
                raise StopIteration
            if self._transport in (None, "push"):
                backend = self._backend_ref()
                try:
                    res = asyncio.run_coroutine_threadsafe(
                        self._take_on_io(), backend.loop).result()
                except ChannelBroken:
                    self._begin_fallback_blocking()
                    continue
                except Exception:
                    self._done = True
                    self._router.complete(self._rid)
                    self._abort_stream()
                    self._finish_metrics()
                    raise
                if res is self._PULL:
                    continue
                if res is self._END:
                    self._mark_done()
                    continue
                first, rest = res
                self._buf.extend(rest)
                self._delivered += 1
                return first
            self._pull_once_blocking()

    def _pull_once_blocking(self) -> None:
        try:
            # wide pulls: the replica returns whatever the stream has
            # already produced (blocking only for the first item), so
            # a large max_items batches token bursts into one RPC
            # without delaying a steady trickle
            self._rpcs += 1
            items, done = ray_tpu_torch.get(self._actor.next_chunks.remote(
                self._stream_id, 64))
        except Exception:
            self._done = True
            self._router.complete(self._rid)
            self._finish_metrics()
            raise
        self._buf.extend(items)
        if done:
            self._mark_done()

    def __aiter__(self):
        return self

    def _next_or_end(self):
        # StopIteration cannot cross an executor future (py3.12 turns it
        # into RuntimeError); translate to a sentinel on the worker side
        try:
            return self.__next__()
        except StopIteration:
            return self._END

    async def __anext__(self):
        while True:
            if self._buf:
                # burst fast path: pushed/pulled chunks already buffered —
                # hand them out without a hop per item
                self._delivered += 1
                return self._buf.pop(0)
            if self._done:
                self._finish_metrics()
                raise StopAsyncIteration
            loop = asyncio.get_running_loop()
            if self._transport in (None, "push"):
                backend = self._backend_ref()
                try:
                    if loop is backend.loop:
                        # the proxy hot path: __anext__ runs ON the io
                        # loop — await the channel directly, zero hops
                        res = await self._take_on_io()
                    else:
                        res = await asyncio.wrap_future(
                            asyncio.run_coroutine_threadsafe(
                                self._take_on_io(), backend.loop))
                except ChannelBroken:
                    await loop.run_in_executor(
                        _stream_executor(), self._begin_fallback_blocking)
                    continue
                except Exception:
                    self._done = True
                    self._router.complete(self._rid)
                    self._abort_stream()
                    self._finish_metrics()
                    raise
                if res is self._PULL:
                    continue
                if res is self._END:
                    self._mark_done()
                    continue
                first, rest = res
                self._buf.extend(rest)
                self._delivered += 1
                return first
            item = await loop.run_in_executor(_stream_executor(),
                                              self._next_or_end)
            if item is self._END:
                raise StopAsyncIteration
            return item

    def drain_buffered(self) -> List[Any]:
        """Chunks already received and buffered locally — consumers that
        can write a burst at once (the proxy's stream path) take them
        without per-item awaits. On the push path this drains the
        channel's frame buffer directly (inline values only; rare
        non-inline frames park for the decoding path)."""
        out, self._buf = self._buf, []
        if (self._transport == "push" and self._channel is not None
                and not self._wire):
            values, rest = rt_stream.inline_values(
                self._channel.take_available())
            out.extend(values)
            self._wire.extend(rest)
        self._delivered += len(out)
        return out

    def cancel(self) -> None:
        if not self._done:
            self._done = True
            self._router.complete(self._rid)
            ch, self._channel = self._channel, None
            if ch is not None:
                ch.close()
            self._actor.cancel_stream.remote(self._stream_id)
        self._finish_metrics()

    def __del__(self):
        # abandoned mid-iteration (early break): release the router's
        # in-flight slot and the replica's suspended generator
        try:
            self.cancel()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class DeploymentHandle:
    def __init__(self, app_name: str, deployment_name: str,
                 method_name: str = "__call__",
                 multiplexed_model_id: str = ""):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self._method = method_name
        self._model_id = multiplexed_model_id
        self._router = _RouterState(app_name, deployment_name)

    # composition: handle.other_method.remote(...)
    def options(self, *, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None) -> "DeploymentHandle":
        h = DeploymentHandle(
            self.app_name, self.deployment_name,
            method_name if method_name is not None else self._method,
            multiplexed_model_id if multiplexed_model_id is not None
            else self._model_id)
        h._router = self._router  # share the replica cache + counts
        return h

    def __getattr__(self, item: str) -> "DeploymentHandle":
        if item.startswith("_"):
            raise AttributeError(item)
        return self.options(method_name=item)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        # the pool thread does not inherit contextvars: capture the ambient
        # request context HERE (proxy / enclosing replica), or mint one —
        # a direct handle call is an ingress too, so every request carries
        # an id and a trace from its very first hop
        ctx = obs.current_request_context()
        if ctx is None:
            ctx = {"request_id": obs.mint_request_id(),
                   "app": self.app_name,
                   "deployment": self.deployment_name,
                   "route": "handle", "span_id": None}
        fut = _shared_pool().submit(self._call_blocking, args, kwargs, ctx)
        return DeploymentResponse(fut)

    def _call_blocking(self, args: Tuple, kwargs: Dict,
                       req_ctx: Optional[Dict] = None) -> Any:
        router = self._router
        backoff = _RETRY_BACKOFF_S
        t_entry, t0 = time.time(), time.perf_counter()
        deadline = t_entry + _COLD_START_TIMEOUT_S
        meta: Dict[str, Any] = {}
        if self._model_id:
            meta["model_id"] = self._model_id
        span_id = obs.new_span_id()
        if req_ctx is not None:
            meta["request"] = {"request_id": req_ctx["request_id"],
                               "app": req_ctx.get("app", self.app_name),
                               "route": req_ctx.get("route", "handle"),
                               "span_id": span_id}
        return self._routed_call(router, args, kwargs, meta or None,
                                 req_ctx, span_id, t_entry, t0,
                                 backoff, deadline)

    def _routed_call(self, router, args, kwargs, meta, req_ctx, span_id,
                     t_entry, t0, backoff, deadline) -> Any:
        def emit(t_rpc0: Optional[float], streamed: bool = False) -> None:
            if req_ctx is None:
                return
            t_end = time.perf_counter()
            phases = {"route": (t_rpc0 if t_rpc0 is not None else t_end)
                      - t0}
            if t_rpc0 is not None:
                phases["call" if not streamed else "call_stream"] = \
                    t_end - t_rpc0
            obs.emit_span(
                f"serve:{req_ctx['request_id']}:h:{span_id[:8]}",
                f"route:{self.app_name}/{self.deployment_name}",
                request_id=req_ctx["request_id"], span_id=span_id,
                parent_span_id=req_ctx.get("span_id"),
                t_start=t_entry, t_end=t_entry + (t_end - t0),
                phases=phases)

        # one prefix probe per call (not per retry): LLM-protocol bodies
        # yield their prompt's chunk digests for cache-affinity routing;
        # anything else routes load-only (digests None)
        prefix_digests = _prefix.request_prefix_digests(args, kwargs)
        while True:
            router.refresh()
            if not router.replicas:
                router.wake_and_wait()
            try:
                rid, actor = router.pick(self._model_id or None,
                                         prefix_digests)
            except LookupError:
                continue
            t_rpc0 = time.perf_counter()
            try:
                # activate ONLY around the replica call: the routed actor
                # call becomes a child span of this handle span (trace id
                # == request id) while the router's own control-plane RPCs
                # (get_replicas refresh, wake) stay out of the request
                # trace
                token = obs.activate_request(
                    dict(req_ctx, span_id=span_id)) \
                    if req_ctx is not None else None
                try:
                    ref = actor.handle_request.remote(
                        self._method, args, kwargs, meta)
                finally:
                    obs.deactivate_request(token)
                reply = ray_tpu_torch.get(ref)
            except ActorError:
                # stale cache: drop this replica and re-route (with the same
                # backoff/deadline as rejection — a dead replica stays in the
                # cache until the controller's health check evicts it)
                router.complete(rid)
                obs.errors_total().inc(tags={
                    "app": self.app_name,
                    "deployment": self.deployment_name,
                    "kind": "replica_died"})
                if time.time() > deadline:
                    emit(None)
                    raise TimeoutError(
                        f"{self.app_name}/{self.deployment_name}: replicas "
                        f"kept failing") from None
                time.sleep(backoff)
                backoff = min(backoff * 1.5, 0.25)
                router.refresh(force=True)
                continue
            except Exception:
                # user code raised (TaskError re-raised at get): the pick()
                # slot must not stay in-flight forever — phantom load would
                # make power-of-two routing shun whichever replica happened
                # to serve the failing inputs — and the failed request
                # still gets its route span and error count
                router.complete(rid)
                obs.errors_total().inc(tags={
                    "app": self.app_name,
                    "deployment": self.deployment_name,
                    "kind": "app_error"})
                emit(t_rpc0)
                raise
            status, payload = reply[0], reply[1]
            models = reply[2] if len(reply) > 2 else None
            kv = reply[3] if len(reply) > 3 else None
            if status == REJECTED:
                router.complete(rid, rejected_ongoing=payload)
                if time.time() > deadline:
                    obs.errors_total().inc(tags={
                        "app": self.app_name,
                        "deployment": self.deployment_name,
                        "kind": "rejected_timeout"})
                    emit(None)
                    raise TimeoutError(
                        f"{self.app_name}/{self.deployment_name}: all "
                        f"replicas at max_ongoing_requests")
                time.sleep(backoff)
                backoff = min(backoff * 1.5, 0.25)
                router.refresh(force=backoff > 0.1)
                continue
            if status == "stream":
                # the generator keeps the in-flight slot until it completes
                router.note_models(rid, models, kv)
                emit(t_rpc0, streamed=True)
                return DeploymentResponseGenerator(router, rid, actor, payload)
            router.complete(rid, model_ids=models, kv_digests=kv)
            emit(t_rpc0)
            return payload

    def __reduce__(self):
        return (DeploymentHandle,
                (self.app_name, self.deployment_name, self._method,
                 self._model_id))

    def __repr__(self) -> str:
        return (f"DeploymentHandle({self.app_name}/{self.deployment_name}"
                f".{self._method})")
