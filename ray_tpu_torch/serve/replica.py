"""Replica: the actor that hosts one copy of a deployment's user callable.

Reference analog: ``serve/_private/replica.py:497`` (``RayServeReplica``,
``handle_request :235``). Each replica tracks its ongoing-request count and
REJECTS requests over ``max_ongoing_requests`` — the router treats a
rejection as backpressure and retries elsewhere (the reference's
power-of-two scheduler does the same with queue-length probing).

A replica is where GPUs live (``num_gpus`` in ``ray_actor_options`` pins
whole GPUs through the raylet's ``CUDA_VISIBLE_DEVICES`` isolation), so
replica count == GPU-group count and the autoscaler provisions GPUs.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import inspect
import os
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.cluster import stream as rt_stream
from ray_tpu_torch.serve import obs
from ray_tpu_torch.serve.multiplex import loaded_model_ids
from ray_tpu_torch.util import metrics

REJECTED = "__rt_serve_rejected__"



def _step_profiler():
    """The step profiler where this process has it on, else None. It is
    imported only then (by whoever enabled it, or for
    ``RT_STEP_PROFILER``): it loads torch, which a replica of a deployment
    that does not use torch should not pay for at start."""
    mod = sys.modules.get("ray_tpu_torch.util.step_profiler")
    if mod is None and os.environ.get("RT_STEP_PROFILER", "") not in (
            "", "0", "false"):
        from ray_tpu_torch.util import step_profiler as mod
    return mod if mod is not None and mod.is_enabled() else None

class _AsyncStreamPump:
    """Drains an async generator into a bounded queue from a background
    task, so ``next_chunks`` can return items AS PRODUCED instead of
    awaiting the generator ``max_items`` times per pull (which would hold
    back SSE tokens and websocket frames until a batch filled). The bound
    gives a fast producer backpressure when the consumer lags."""

    _DONE = object()

    def __init__(self, agen, maxsize: int = 256):
        self._agen = agen
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._error: Optional[BaseException] = None
        self._loop = asyncio.get_running_loop()
        self._task = asyncio.ensure_future(self._pump())

    async def _pump(self) -> None:
        try:
            async for item in self._agen:
                await self._queue.put(item)
        except asyncio.CancelledError:
            # close() tearing us down: the consumer is gone, so an awaited
            # put on a full queue would pend forever (a fast producer fills
            # the bound, nothing drains it). Never block — and RE-RAISE so
            # cancellation stays cancellation instead of becoming the
            # stream's "error".
            self._put_done_nowait()
            raise
        except BaseException as e:  # noqa: BLE001 — delivered to consumer
            self._error = e
        # completion/error: an awaited put keeps backpressure honest (a
        # lagging-but-live consumer will drain the queue), but close()
        # cancelling us AT this await must still land the marker
        try:
            await self._queue.put(self._DONE)
        except asyncio.CancelledError:
            self._put_done_nowait()
            raise

    def _put_done_nowait(self) -> None:
        """Enqueue the DONE marker without ever blocking: on a full queue
        drop buffered items (teardown path — nobody will consume them)
        until the marker fits."""
        while True:
            try:
                self._queue.put_nowait(self._DONE)
                return
            except asyncio.QueueFull:
                try:
                    self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    pass

    async def take(self, max_items: int) -> Tuple[List[Any], bool]:
        """Block for one item, then drain opportunistically."""
        items: List[Any] = []
        first = await self._queue.get()
        if first is self._DONE:
            if self._error is not None:
                raise self._error
            return (items, True)
        items.append(first)
        while len(items) < max_items and not self._queue.empty():
            nxt = self._queue.get_nowait()
            if nxt is self._DONE:
                if self._error is not None:
                    # deliver the collected items now; the error travels
                    # as the NEXT pull's failure (contract above)
                    self._queue.put_nowait(self._DONE)
                    return (items, False)
                return (items, True)
            items.append(nxt)
        return (items, False)

    def close(self) -> None:
        """Thread-safe teardown (cancel_stream may run off-loop)."""
        def _do():
            self._task.cancel()
            closer = getattr(self._agen, "aclose", None)
            if closer is not None:
                asyncio.ensure_future(closer())

        self._loop.call_soon_threadsafe(_do)


class _SyncStreamPump:
    """Gives a plain (sync) generator the pump interface (``async take``)
    so the push transport and the pull path share one stream surface;
    pulls run on the replica executor, so a blocking user generator never
    stalls the event loop (same economics as the old next_chunks sync
    branch: items batch up to ``max_items`` per take)."""

    def __init__(self, gen, executor):
        self._gen = gen
        self._exec = executor

    async def take(self, max_items: int) -> Tuple[List[Any], bool]:
        loop = asyncio.get_running_loop()

        def pull():
            out: List[Any] = []
            for _ in range(max_items):
                try:
                    out.append(next(self._gen))
                except StopIteration:
                    return out, True
            return out, False

        return await loop.run_in_executor(self._exec, pull)

    def close(self) -> None:
        closer = getattr(self._gen, "close", None)
        if closer is not None:
            closer()


class _FunctionWrapper:
    """Adapts a plain function deployment to the class-callable protocol.

    Deliberately a plain (sync) __call__: handle_request runs it in the
    replica executor, so a blocking function body occupies an executor
    thread, NOT the worker's event loop. Async fns return a coroutine here,
    which handle_request awaits on the loop."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


@ray_tpu_torch.remote
class ReplicaActor:
    """One replica. Created by the controller with the deployment's body
    (class or function), init args (deployment-handle markers already
    substituted by the controller), and config."""

    def __init__(self, deployment_name: str, app_name: str, replica_id: str,
                 body_ref, init_args: Tuple, init_kwargs: Dict,
                 max_ongoing_requests: int,
                 user_config: Optional[Dict] = None):
        # rt: lint-allow(hot-path) import-cycle break (handle.py imports
        # REJECTED from this module); one lookup per replica boot
        from ray_tpu_torch.serve.handle import _resolve_handle_markers

        self._deployment = deployment_name
        self._app = app_name
        self._replica_id = replica_id
        self._max_ongoing = max_ongoing_requests
        self._ongoing = 0
        self._total_served = 0
        self._started_at = time.time()
        # request observability (serve/obs.py): admitted-but-not-executing
        # count and a bounded window of completed-request latencies — the
        # controller's stats_window poll aggregates these into the
        # per-deployment p50/p99 + QPS the autoscaler and `rt serve
        # status` report
        self._executing = 0
        # executor threads and the event loop both move the counter — a
        # drifted count would misreport queue depth forever
        self._exec_lock = threading.Lock()
        self._lat_window: "deque" = deque(maxlen=512)  # (t_end, wall_s)
        # sync user callables run here, NOT on the worker's event loop — a
        # blocking body (the common case: a jitted forward pass) must not
        # stall the RPC server or sibling requests
        self._exec = ThreadPoolExecutor(
            max_workers=max(1, max_ongoing_requests),
            thread_name_prefix="rt-replica")
        self._streams: Dict[str, Any] = {}  # response streams being consumed
        # pull-fallback error handoff: a pushed stream that failed after a
        # broken channel parks its error here for the next pull to raise
        self._stream_errors: Dict[str, BaseException] = {}
        self._next_stream_id = 0

        body = body_ref
        init_args = _resolve_handle_markers(init_args)
        init_kwargs = _resolve_handle_markers(init_kwargs)
        if isinstance(body, type):
            self._instance = body(*init_args, **init_kwargs)
        else:
            self._instance = _FunctionWrapper(body)
        if user_config is not None:
            self._reconfigure_sync(user_config)

    def _reconfigure_sync(self, user_config: Dict) -> None:
        fn = getattr(self._instance, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    async def handle_request(self, method_name: str, args: Tuple,
                             kwargs: Dict,
                             meta: Optional[Dict] = None) -> Tuple:
        """Returns ("ok", result, loaded_model_ids, kv_residency),
        ("stream", stream_id, loaded_model_ids, kv_residency) for
        generator results, or (REJECTED, ongoing_count)."""
        # websocket inbound frames bypass admission control: the
        # connection's __ws_connect__ stream already holds a slot, and
        # rejecting its own frames would wedge every connection on a
        # replica running at max_ongoing (e.g. max_ongoing_requests=1)
        if (self._ongoing >= self._max_ongoing
                and method_name != "__ws_push__"):
            return (REJECTED, self._ongoing)
        self._ongoing += 1
        try:
            # rt: lint-allow(hot-path) must stay function-local: a
            # module-global ContextVar would ride cloudpickle's by-value
            # capture of this actor class, and ContextVars don't pickle
            from ray_tpu_torch.serve.multiplex import _current_model_id

            target = self._instance
            if method_name != "__call__":
                target = getattr(self._instance, method_name, None)
                if target is None:
                    raise AttributeError(
                        f"deployment {self._deployment} has no method "
                        f"{method_name!r}")
            req = (meta or {}).get("request")
            replica_span = obs.new_span_id() if req else ""
            req_token = None
            if req:
                # nested handle calls made by the user callable must join
                # THIS request's trace: make the context ambient before the
                # contextvars copy below snapshots it
                req_token = obs.activate_request({
                    "request_id": req["request_id"],
                    "app": req.get("app", self._app),
                    "deployment": self._deployment,
                    "route": req.get("route", ""),
                    "span_id": replica_span})
            token = _current_model_id.set((meta or {}).get("model_id", ""))
            t_epoch, t0 = time.time(), time.perf_counter()
            exec_mark = [t0]  # executor thread stamps user-code start
            failed = False
            try:
                # copy AFTER setting so the executor thread sees the model id
                ctx = contextvars.copy_context()
                loop = asyncio.get_running_loop()

                def invoke():
                    # queue-wait ends HERE: the request held an admission
                    # slot but waited for an executor thread (and the
                    # loop's handoff) before user code ran
                    exec_mark[0] = time.perf_counter()
                    with self._exec_lock:
                        self._executing += 1
                    try:
                        return target(*args, **kwargs)
                    finally:
                        with self._exec_lock:
                            self._executing -= 1

                result = await loop.run_in_executor(
                    self._exec, functools.partial(ctx.run, invoke))
                if inspect.isawaitable(result):
                    with self._exec_lock:
                        self._executing += 1
                    try:
                        result = await result
                    finally:
                        with self._exec_lock:
                            self._executing -= 1
            except BaseException:
                failed = True
                raise
            finally:
                _current_model_id.reset(token)
                obs.deactivate_request(req_token)
                # telemetry runs for FAILING requests too: a deployment
                # erroring after a slow forward pass must still feed the
                # latency window (p50/p99/QPS, doctor's p99 warn), the
                # queue/execute histograms and its trace span
                t1 = time.perf_counter()
                if method_name not in ("__ws_push__",):
                    queue_wait_s = max(0.0, exec_mark[0] - t0)
                    execute_s = max(0.0, t1 - exec_mark[0])
                    tags = {"app": self._app,
                            "deployment": self._deployment}
                    obs.queue_wait_seconds().observe(queue_wait_s,
                                                     tags=tags)
                    obs.execute_seconds().observe(execute_s, tags=tags)
                    with self._exec_lock:  # stats_window reads off-loop
                        self._lat_window.append((time.time(), t1 - t0))
                    if req:
                        obs.emit_span(
                            f"serve:{req['request_id']}:x:"
                            f"{replica_span[:8]}",
                            f"replica:{self._deployment}.{method_name}",
                            request_id=req["request_id"],
                            span_id=replica_span,
                            parent_span_id=req.get("span_id"),
                            t_start=t_epoch, t_end=t_epoch + (t1 - t0),
                            phases={"queue_wait": queue_wait_s,
                                    "execute": execute_s},
                            state="FAILED" if failed else "FINISHED")
            step_profiler = _step_profiler()
            if step_profiler is not None:
                # serve is a profiler hot path too: per-request wall time
                # (the user callable's execution — a returned stream's
                # drain is accounted by the generate/decode records it
                # produces, not here)
                step_profiler.record(
                    "serve", name=self._deployment, t_start=t_epoch,
                    wall_s=time.perf_counter() - t0,
                    meta={"method": method_name,
                          "replica_id": self._replica_id})
            self._total_served += 1
            models = loaded_model_ids(self._instance)
            kv = None
            kv_fn = getattr(self._instance, "kv_residency", None)
            if kv_fn is not None:
                # duck-typed like loaded_model_ids: a cache-aware engine
                # reports its warm prefix digests on every reply, so the
                # router's residency view is as fresh as its last call
                # to this replica (no extra RPC, no controller round)
                try:
                    kv = kv_fn()
                except Exception:  # noqa: BLE001 — residency is advisory
                    pass
            if inspect.isgenerator(result) or inspect.isasyncgen(result):
                sid = f"s{self._next_stream_id}"
                self._next_stream_id += 1
                if inspect.isasyncgen(result):
                    # async gens are drained by a pump task into a queue so
                    # take() returns each item AS IT IS PRODUCED — a
                    # batched pull that awaited __anext__ max_items times
                    # would hold back SSE tokens / websocket frames until
                    # the batch filled
                    pump: Any = _AsyncStreamPump(result)
                else:
                    pump = _SyncStreamPump(result, self._exec)
                self._streams[sid] = pump
                # push transport (cluster/stream.py): the consumer's ONE
                # stream_subscribe RPC binds this pump to a push channel;
                # every subsequent token burst is a one-way frame. The
                # pull path below stays as the fallback.
                rt_stream.register_source(
                    sid, pump,
                    on_done=functools.partial(self._finish_stream, sid))
                # the stream HOLDS the in-flight slot until exhausted or
                # cancelled: +1 here cancels the finally's -1, so ongoing
                # counts active streams (admission control, autoscaler
                # metrics, and prepare_shutdown draining all depend on it)
                self._ongoing += 1
                return ("stream", sid, models, kv)
            return ("ok", result, models, kv)
        finally:
            self._ongoing -= 1

    async def next_chunks(self, stream_id: str, max_items: int = 10) -> Tuple:
        """Pull up to max_items from a response stream: (items, done).
        A mid-stream exception travels as the last pull's error.

        Async-gen streams block only for the FIRST item of a pull; the rest
        are taken opportunistically (whatever the pump already produced) —
        incremental streams (SSE, websocket frames) flow with per-item
        latency while bursty producers still batch."""
        err = self._stream_errors.pop(stream_id, None)
        if err is not None:
            self._finish_stream(stream_id)
            raise err
        it = self._streams.get(stream_id)
        if it is None:
            return ([], True)
        try:
            items, done = await it.take(max_items)
        except Exception:
            self._finish_stream(stream_id)
            raise
        rt_stream.count_pull_frames(len(items))
        if done:
            self._finish_stream(stream_id)
        return (items, done)

    async def resume_pull(self, stream_id: str, delivered: int) -> Tuple:
        """Pull-fallback handoff after a broken push channel: detach the
        push binding and return the replayed tail past the consumer's
        ``delivered`` count — token-exact across the transport switch.
        The consumer continues on ``next_chunks`` from here. Async so it
        runs on the event loop the push binding lives on."""
        items, source_done, err = await rt_stream.reclaim(
            stream_id, delivered)
        if err is not None:
            if items:
                # pull-path contract: collected items now, the error as
                # the next pull's failure
                self._stream_errors[stream_id] = err
                return (items, False)
            self._finish_stream(stream_id)
            raise err
        if source_done:
            self._finish_stream(stream_id)
            return (items, True)
        return (items, False)

    def _finish_stream(self, stream_id: str) -> None:
        if self._streams.pop(stream_id, None) is not None:
            self._ongoing -= 1  # release the slot the stream was holding
            self._stream_errors.pop(stream_id, None)
            rt_stream.unregister_source(stream_id)

    def cancel_stream(self, stream_id: str) -> None:
        it = self._streams.get(stream_id)
        self._finish_stream(stream_id)
        closer = getattr(it, "close", None)
        if closer is not None:
            try:
                closer()
            except Exception:  # noqa: BLE001
                pass

    # -- controller-facing ----------------------------------------------------
    def ongoing_count(self) -> int:
        return self._ongoing

    def stats_window(self, window_s: float = 30.0) -> Dict[str, Any]:
        """Windowed request stats for the controller's autoscaler poll:
        ongoing count, executor queue depth, and the recent completed-
        request latencies (the controller merges replicas and computes the
        per-deployment p50/p99 + QPS the decision log records)."""
        now = time.time()
        with self._exec_lock:  # the event loop appends concurrently
            window = list(self._lat_window)
            saturated = len(window) == self._lat_window.maxlen
        lats = [w for t, w in window if now - t <= window_s]
        # a saturated ring evicted completions that were still inside the
        # nominal window: report the span the retained samples actually
        # cover, or the controller's completed/window_s rate math caps at
        # maxlen/window_s qps under exactly the heavy traffic this plane
        # is for
        eff_window_s = window_s
        if saturated and window:
            eff_window_s = min(window_s, max(1e-3, now - window[0][0]))
        out = {"replica_id": self._replica_id,
               "ongoing": self._ongoing,
               "queue_depth": max(0, self._ongoing - self._executing
                                  - len(self._streams)),
               "completed": len(lats),
               "window_s": eff_window_s,
               "latencies": lats[-200:]}
        # duck-typed engine surface (serve/llm.py ContinuousLLM): a
        # continuous-batching instance reports slot occupancy, which the
        # controller aggregates into win_stats / `rt serve status`
        eng_fn = getattr(self._instance, "engine_stats", None)
        if eng_fn is not None:
            try:
                out["engine"] = eng_fn()
            except Exception:  # noqa: BLE001 — stats are advisory
                pass
        return out

    def flush_metrics(self) -> None:
        """Push this replica's metric registry + buffered serve spans now
        (tests/ops — the background pushers run on an interval)."""
        obs.flush_spans()
        metrics.flush_now()

    def stats(self) -> Dict[str, Any]:
        return {"replica_id": self._replica_id, "ongoing": self._ongoing,
                "total_served": self._total_served,
                "uptime_s": time.time() - self._started_at,
                "model_ids": loaded_model_ids(self._instance)}

    async def check_health(self) -> str:
        fn = getattr(self._instance, "check_health", None)
        if fn is not None:
            result = fn()
            if inspect.isawaitable(result):
                await result
        return "ok"

    def reconfigure(self, user_config: Dict) -> None:
        self._reconfigure_sync(user_config)

    async def prepare_shutdown(self, timeout_s: float) -> int:
        """Drain: wait for ongoing requests to finish (bounded)."""
        deadline = time.time() + timeout_s
        while self._ongoing > 0 and time.time() < deadline:
            await asyncio.sleep(0.05)
        return self._ongoing
