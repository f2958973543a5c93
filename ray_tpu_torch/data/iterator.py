"""The device feed: stacked, prefetched batches on the card (port of the
feed half of ``ray_tpu/data/iterator.py``).

``iter_device_batches`` is ``DataIterator.iter_jax_batches``' host and
device generators over any iterator of dict-of-numpy batches; the JAX
package's Dataset and block plane belongs to its cluster runtime and is
not ported yet (ROADMAP item R3; pass ``ds.iter_batches(...)`` of it, or
any generator).

On ``cuda`` the device put runs on the prefetch thread, ``prefetch``
batches ahead of the consumer: each leaf is copied into pinned host
memory, then to the card with ``non_blocking=True`` on a side stream, and
a CUDA event is recorded after the copies. The consumer's ``next()``
makes its current stream wait for that event and marks the tensors as
used on it (``record_stream``), so the caching allocator cannot hand
their memory to the side stream while the consumer's work still reads
them. A pinned buffer is kept alive until its copy's event has
completed, so no pinned memory is reused under a copy in flight.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


def prefetched(it: Iterator[Any], depth: int) -> Iterator[Any]:
    """Run the upstream iterator in a thread, `depth` items ahead.

    The producer must not block forever when the consumer abandons the
    iterator early (``break`` mid-epoch): a stop event unwinds it and
    releases its buffered items. An upstream error is raised to the
    consumer once the items before it are consumed.
    """
    if depth <= 0:
        yield from it
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def producer():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised to the consumer
            err.append(e)
        finally:
            # the END sentinel must arrive even when the queue is full —
            # keep trying unless the consumer already stopped
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True,
                         name="rtt-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


class DeviceBatchIterator:
    """Iterator of device batches with ingest-vs-compute accounting (the
    twin of JAX's ``JaxBatchIterator``).

    The time THIS iterator spends producing a batch (pipeline pull + host
    to device put, when the prefetch thread has not done it ahead) is
    **ingest**; the time the consumer holds the batch between ``next()``
    calls (its train step) is **compute**. ``report()`` states which side
    gates the run: *ingest-limited* when the device waits on data,
    *compute-limited* when the pipeline keeps up.

    ``stack`` advertises the K-stacking factor
    (``iter_device_batches(stack=K)`` yields [k, B, ...] leaves, k == K
    except a ragged tail): the StepDriver keys its fused-vs-single
    dispatch off it.
    """

    def __init__(self, inner: Iterator[Any], stack: int = 1):
        self._inner = inner
        self.stack = stack
        self.ingest_s = 0.0
        self.compute_s = 0.0
        # the first pull pays pipeline spin-up (the prefetch thread's
        # start, the first pinned allocations) — booked separately so the
        # verdict describes the steady state
        self.cold_start_s = 0.0
        self.batches = 0
        self._t_resume: Optional[float] = None

    def __iter__(self) -> "DeviceBatchIterator":
        return self

    def __next__(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        if self._t_resume is not None:
            self.compute_s += t0 - self._t_resume
        try:
            item = next(self._inner)
        except StopIteration:
            self._t_resume = None
            raise
        batch = _consume(item)
        if self.batches == 0:
            self.cold_start_s += time.perf_counter() - t0
        else:
            self.ingest_s += time.perf_counter() - t0
        self._t_resume = time.perf_counter()
        self.batches += 1
        return batch

    def report(self) -> Dict[str, Any]:
        total = self.ingest_s + self.compute_s
        verdict = ("ingest-limited" if self.ingest_s > self.compute_s
                   else "compute-limited")
        return {
            "verdict": verdict,
            "ingest_s": round(self.ingest_s, 4),
            "compute_s": round(self.compute_s, 4),
            "cold_start_s": round(self.cold_start_s, 4),
            "ingest_frac": round(self.ingest_s / total, 4) if total else 0.0,
            "batches": self.batches,
            "batches_per_s": (round(self.batches / total, 2)
                              if total else 0.0),
        }

    def verdict(self) -> str:
        r = self.report()
        return (f"{r['verdict']}: ingest {r['ingest_s']:.3f}s vs compute "
                f"{r['compute_s']:.3f}s over {r['batches']} batch(es) "
                f"(ingest fraction {r['ingest_frac']:.0%})")


def _consume(item) -> Dict[str, torch.Tensor]:
    """On the consumer's thread: a CUDA batch's copy event joins the
    consumer's current stream, and its tensors are marked as used there;
    a CPU batch is returned as is."""
    batch, copied = item
    if copied is None:
        return batch
    stream = torch.cuda.current_stream(next(iter(batch.values())).device)
    stream.wait_event(copied)
    for t in batch.values():
        t.record_stream(stream)
    return batch


def _host_batches(batches: Iterable[Dict[str, Any]], stack: int = 1,
                 dtype=None) -> Iterator[Dict[str, np.ndarray]]:
    """``iter_jax_batches``' host generator: numpy leaves (cast to
    ``dtype`` when given), grouped ``stack`` at a time into [K, B, ...]
    leaves. A batch whose shapes differ from the pending group's (a
    ragged last batch) flushes the group and starts its own; the ragged
    tail is [k < K, B, ...]."""
    pend: List[Dict[str, np.ndarray]] = []
    for batch in batches:
        batch = {k: (np.asarray(v) if dtype is None
                     else np.asarray(v).astype(dtype))
                 for k, v in batch.items()}
        if stack <= 1:
            yield batch
            continue
        if pend and any(np.shape(batch[k]) != np.shape(pend[0][k])
                        for k in pend[0]):
            # a ragged-B batch can't stack with full ones — flush the
            # group, let it ride alone
            yield {k: np.stack([b[k] for b in pend]) for k in pend[0]}
            pend = []
        pend.append(batch)
        if len(pend) == stack:
            yield {k: np.stack([b[k] for b in pend]) for k in pend[0]}
            pend = []
    if pend:  # ragged tail: [k < K, B, ...]
        yield {k: np.stack([b[k] for b in pend]) for k in pend[0]}


def _device_puts(host: Iterator[Dict[str, np.ndarray]],
                 device: torch.device) -> Iterator[Any]:
    """(batch on ``device``, the CUDA event after its copies or None).
    Runs on the prefetch thread on ``cuda``."""
    if device.type != "cuda":
        for batch in host:
            yield ({k: torch.as_tensor(v, device=device)
                    for k, v in batch.items()}, None)
        return
    torch.cuda.set_device(device)
    side = torch.cuda.Stream(device)
    in_flight: "deque" = deque()  # (pinned buffers, their copy's event)
    try:
        for batch in host:
            # pinned buffers whose copy completed may go back to the
            # allocator; the rest stay referenced until it completes
            while in_flight and in_flight[0][1].query():
                in_flight.popleft()
            pinned = {k: torch.from_numpy(np.ascontiguousarray(v))
                      .pin_memory() for k, v in batch.items()}
            with torch.cuda.stream(side):
                out = {k: p.to(device, non_blocking=True)
                       for k, p in pinned.items()}
                copied = torch.cuda.Event()
                copied.record(side)
            in_flight.append((pinned, copied))
            yield out, copied
    finally:
        for _, copied in in_flight:
            copied.synchronize()


def iter_device_batches(host_iter: Iterable[Dict[str, Any]], *,
                        stack: int = 1, prefetch_batches: int = 2,
                        dtype=None, device: DeviceLike = None
                        ) -> DeviceBatchIterator:
    """Batches as tensors on ``device`` (``cuda`` unless asked), from any
    iterator of dict-of-numpy batches.

    ``stack=K`` groups K consecutive batches into one [K, B, ...] batch
    (host-side ``np.stack``, then one device put): the fused-K launch
    feed. A ragged tail yields [k < K, B, ...]; the StepDriver
    single-steps it. The device put runs ``prefetch_batches`` ahead on a
    bounded lookahead thread, so at steady state the consumer's
    ``next()`` returns a batch already on the card.

    Returns a ``DeviceBatchIterator``: iterate it, then call
    ``.report()`` / ``.verdict()`` for the ingest-vs-compute breakdown.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        # the caller's current device, fixed here: the prefetch thread's
        # own current device is the process default
        device = torch.device("cuda", torch.cuda.current_device())
    host = _host_batches(host_iter, stack, dtype)
    return DeviceBatchIterator(
        prefetched(_device_puts(host, device), prefetch_batches),
        stack=stack)
