"""Dynamic request batching (the port's copy of ``ray_tpu/serve/batching.py``,
``@serve.batch``).

Single requests arriving within ``batch_wait_timeout_s`` of each other are
fused into one list-call of the wrapped function, so the replica's forward
runs one large batch instead of many tiny ones. The wrapped function takes
a list and must return a list of equal length; each caller awaits its own
element. The JAX package writes each flush's size to its serve metrics;
here the caller passes an ``on_batch`` hook instead.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, Optional


class _Batcher:
    """Queue of (item, future) pairs flushed by size or deadline."""

    def __init__(self, fn: Callable, name: str, max_size: int,
                 timeout: float, on_batch: Optional[Callable]):
        self._fn = fn
        self._name = name
        self._max_size = max_size
        self._timeout = timeout
        self._on_batch = on_batch
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
                deadline = asyncio.get_running_loop().time() + self._timeout
                while len(batch) < self._max_size:
                    remaining = deadline - asyncio.get_running_loop().time()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(
                            self._queue.get(), timeout=remaining))
                    except asyncio.TimeoutError:
                        break
            except asyncio.CancelledError:
                # cancelled mid-collection (deployment stop): the pairs
                # already dequeued would otherwise hang their callers
                for _, f in batch:
                    if not f.done():
                        f.cancel()
                raise
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            if self._on_batch is not None:
                try:
                    # batch-formation telemetry: fused size against the
                    # configured max, the continuous-batching yardstick
                    self._on_batch(self._name, len(batch), self._max_size)
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
                # fail the collected waiters, then re-raise so the loop
                # ends instead of fanning cancellation out as an error
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
    """``@serve.batch`` — wrap an async function taking a list of items.

    ``on_batch(fn_name, batch_size, max_batch_size)``, when given, is
    called once per flush (the JAX package writes the same two numbers
    to its ``rt_serve_batch_*`` histograms); an exception it raises is
    dropped.

    Call sites pass ONE item and receive its single result; a method is
    wrapped bound, once per instance::

        self.predict = batch(max_batch_size=16)(self._predict_many)
        ...
        return await self.predict(request.array)
    """

    def deco(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async def function")
        batcher: Optional[_Batcher] = None

        @functools.wraps(fn)
        async def wrapper(item):
            nonlocal batcher
            if batcher is None:  # its queue is made on the caller's loop
                batcher = _Batcher(fn, fn.__name__, max_batch_size,
                                   batch_wait_timeout_s, on_batch)
            return await batcher.submit(item)

        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
