"""Dynamic request batching (the port's twin of
``ray_tpu/serve/batching.py``, ``@serve.batch``).

Reference analog: ``serve/batching.py`` (``@serve.batch``). Single requests
arriving within ``batch_wait_timeout_s`` of each other are fused into one
list-call of the wrapped method, so the replica's forward runs one large
batch instead of many tiny ones. The wrapped function takes a list and must
return a list of equal length; each caller awaits its own element. Each
flush's size and occupancy go to the ``rt_serve_batch_*`` histograms
(``serve/obs.py``), as in the JAX package; an ``on_batch`` hook, when
given, is called with the same numbers.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _Batcher:
    """Queue of (item, future) pairs flushed by size or deadline.

    Batch parameters are read from the wrapper per flush, so
    ``set_max_batch_size`` / ``set_batch_wait_timeout_s`` take effect on the
    next batch even after the batcher is live."""

    def __init__(self, fn: Callable, wrapper):
        self._fn = fn
        self._wrapper = wrapper
        self._queue: "asyncio.Queue" = asyncio.Queue()
        self._loop_task: Optional[asyncio.Task] = None

    async def submit(self, item: Any) -> Any:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.ensure_future(self._flush_loop())
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((item, fut))
        return await fut

    async def _flush_loop(self) -> None:
        while True:
            item, fut = await self._queue.get()
            batch = [(item, fut)]
            try:
                max_size = self._wrapper._rt_max_batch_size
                timeout = self._wrapper._rt_batch_wait_timeout_s
                deadline = asyncio.get_running_loop().time() + timeout
                while len(batch) < max_size:
                    remaining = deadline - asyncio.get_running_loop().time()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(
                            self._queue.get(), timeout=remaining))
                    except asyncio.TimeoutError:
                        break
            except asyncio.CancelledError:
                # cancelled mid-COLLECTION (deployment stop): the pairs
                # already dequeued would otherwise hang their callers
                # forever, as in the flush-side handler below
                for _, f in batch:
                    if not f.done():
                        f.cancel()
                raise
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            try:
                from ray_tpu_torch.serve import obs

                # batch-formation telemetry: fused size and occupancy of
                # the configured max — THE continuous-batching yardstick
                tags = {"fn": getattr(self._wrapper, "__name__", "batch")}
                obs.batch_size_hist().observe(len(batch), tags=tags)
                obs.batch_occupancy_hist().observe(
                    len(batch) / max(1, max_size), tags=tags)
                on_batch = self._wrapper._rt_on_batch
                if on_batch is not None:
                    on_batch(tags["fn"], len(batch), max_size)
            except Exception:  # noqa: BLE001 — telemetry must not
                pass  # fail the batch
            try:
                results = await self._fn(items)
                if results is None or len(results) != len(items):
                    raise ValueError(
                        f"@serve.batch function must return a list of "
                        f"length {len(items)}, got "
                        f"{type(results).__name__}")
            except asyncio.CancelledError:
                # the flush task itself was cancelled (deployment stop):
                # fail the collected waiters, then RE-RAISE — swallowing
                # left the loop immortal with cancellation fanned out as
                # an application error (a pump leak)
                for f in futs:
                    if not f.done():
                        f.cancel()
                raise
            except BaseException as e:  # noqa: BLE001 — fan the error out
                for f in futs:
                    if not f.done():
                        f.set_exception(e)
                continue
            for f, r in zip(futs, results):
                if not f.done():
                    f.set_result(r)


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01,
          on_batch: Optional[Callable[[str, int, int], None]] = None):
    """``@serve.batch`` — decorate an async method taking a list of items.

    ``on_batch(fn_name, batch_size, max_batch_size)``, when given, is called
    once per flush beside the histograms; an exception it raises is dropped.

    Call sites pass ONE item and receive its single result::

        @serve.batch(max_batch_size=16, batch_wait_timeout_s=0.005)
        async def predict(self, inputs: List[np.ndarray]) -> List[Any]:
            return self.model(np.stack(inputs))   # one fused call

        async def __call__(self, request):
            return await self.predict(request.array)
    """

    def deco(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async def function")
        attr = f"__rt_batcher_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:  # bound method: (self, item)
                owner, item = args
                batcher = getattr(owner, attr, None)
                if batcher is None:
                    async def call(items: List[Any]):
                        return await fn(owner, items)

                    batcher = _Batcher(call, wrapper)
                    setattr(owner, attr, batcher)
            elif len(args) == 1:  # free function: (item,)
                item = args[0]
                batcher = getattr(wrapper, "_rt_free_batcher", None)
                if batcher is None:
                    batcher = _Batcher(fn, wrapper)
                    wrapper._rt_free_batcher = batcher
            else:
                raise TypeError("@serve.batch methods take exactly one item")
            return await batcher.submit(item)

        wrapper._rt_max_batch_size = max_batch_size
        wrapper._rt_batch_wait_timeout_s = batch_wait_timeout_s
        wrapper._rt_on_batch = on_batch
        wrapper.set_max_batch_size = (
            lambda v: setattr(wrapper, "_rt_max_batch_size", v))
        wrapper.set_batch_wait_timeout_s = (
            lambda v: setattr(wrapper, "_rt_batch_wait_timeout_s", v))
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
