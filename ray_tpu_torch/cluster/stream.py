# rt: hot-module
"""Push-stream plumbing over the rpc layer's one-way frames.

The per-token-RPC killer (ROADMAP item 1; reference: Ray core's streaming
generators pushing results over the worker's persistent connection,
arxiv 1712.05889): a producer process registers a stream *source* here;
the consumer opens a :class:`~ray_tpu_torch.cluster.rpc.StreamChannel` on its
existing pooled connection and sends ONE ``stream_subscribe`` RPC; after
that every token burst rides a one-way ``_PUSH`` frame — no reply slot,
no polling executor thread, no per-burst actor RPC. Credit frames
(cumulative consumed count) bound the producer: at ``window`` unacked
items the pump parks, so a slow consumer backpressures the producer
instead of ballooning memory on either side.

Reliability: every pushed-but-unacked item stays in a replay buffer
(bounded by the window). When the connection drops — or chaos breaks the
channel — the consumer falls back to the pull path: ``resume_pull``
reclaims the replay tail by the consumer's delivered count, so the
stream completes token-exact through the fallback.

Object plane: frame items are inline python values; byte-payloads over
``RT_STREAM_INLINE_MAX`` spill to the node's plasma store and travel as
an oid reference — a same-node consumer mmaps them zero-copy (the
pickle-5 path in ``object_store.py``).
"""

from __future__ import annotations

import asyncio
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.cluster.rpc import (
    CHANNEL_DONE,
    ChannelBroken,
    ConnectionLost,
    ServerConnection,
    StreamChannel,
    current_server_connection,
    spawn_task,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.util import chaos as _chaos
from ray_tpu_torch.util import metrics as M

__all__ = [
    "register_source", "unregister_source", "reclaim", "drain_source",
    "settle_source", "peek_unacked", "push_enabled", "subscribe",
    "take_decoded", "handle_subscribe", "stream_window", "encode_item",
    "free_frames",
    "observe_request_rpcs", "count_pull_frames",
]

_PUMP_BATCH = 64

# frame item kinds on the wire: ("v", value) inline, ("o", descriptor,
# nbytes) plasma reference, ("e", serialized_exception) error transport
_KIND_VAL, _KIND_OID, _KIND_ERR = "v", "o", "e"


def push_enabled() -> bool:
    """Consumer-side default transport. ``RT_STREAM_PULL=1`` keeps the
    pull pool as the primary path (fallback/rescue knob)."""
    return os.environ.get("RT_STREAM_PULL", "") != "1"


def stream_window() -> int:
    return int(os.environ.get("RT_STREAM_WINDOW", "128"))


def inline_max_bytes() -> int:
    """Byte payloads above this spill to plasma and travel by reference
    (same-node consumers mmap them zero-copy)."""
    return int(os.environ.get("RT_STREAM_INLINE_MAX", str(64 * 1024)))


# ---------------------------------------------------------------------------
# metrics (lazy — the registry must not be touched at import time)
# ---------------------------------------------------------------------------

_metrics_lock = threading.Lock()
_metrics: Dict[str, Any] = {}  # rt: guarded-by(_metrics_lock)

_RPC_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def _metric(key: str, factory: Callable[[], Any]) -> Any:
    with _metrics_lock:
        m = _metrics.get(key)
        if m is None:
            m = _metrics[key] = factory()
        return m


def frames_total() -> "M.Counter":
    return _metric("frames", lambda: M.get_or_create(
        M.Counter, "rt_stream_frames_total",
        "Stream frame batches moved, by transport (push = one-way "
        "frames, pull = next_chunks RPC batches)",
        tag_keys=("transport",)))


def bytes_total() -> "M.Counter":
    return _metric("bytes", lambda: M.get_or_create(
        M.Counter, "rt_stream_bytes_total",
        "Wire bytes of pushed stream frames (producer side, serialized "
        "frame size)", tag_keys=("transport",)))


def rpcs_per_request() -> "M.Histogram":
    return _metric("rpcs", lambda: M.get_or_create(
        M.Histogram, "rt_stream_rpcs_per_request",
        "RPCs a consumer issued to drain one response stream "
        "(push path: O(1) per request regardless of token count)",
        tag_keys=("transport",), boundaries=_RPC_BUCKETS))


def observe_request_rpcs(transport: str, n: int) -> None:
    """Consumer-side: one observation per completed/cancelled stream."""
    try:
        rpcs_per_request().observe(n, tags={"transport": transport})
    except Exception:  # noqa: BLE001 — telemetry never fails the stream
        pass


def count_pull_frames(n_items: int) -> None:
    """Producer-side accounting for the pull path (one non-empty
    next_chunks batch == one frame on the ``transport="pull"`` series;
    bytes are measured for push only — pull batches are RPC replies
    whose wire size this layer never sees)."""
    if n_items <= 0:
        return
    try:
        frames_total().inc(1.0, {"transport": "pull"})
    except Exception:  # noqa: BLE001
        pass


# ---------------------------------------------------------------------------
# producer side: source registry + push binding
# ---------------------------------------------------------------------------


class _RegisteredSource:
    """One pushable stream in this process. ``pump`` provides
    ``async take(max_items) -> (items, done)`` and ``close()``;
    ``on_done`` runs when the stream fully completes over push
    (the replica uses it to release the in-flight slot).
    ``free_frames``: the stream's oid frames are freed once settled (its
    consumer frees each frame it decodes, ``take_decoded(free=True)``;
    the producer frees the rest, see ``_PushBinding.frame_oids``)."""

    def __init__(self, sid: str, pump: Any,
                 on_done: Optional[Callable[[], None]],
                 free_frames: bool = False):
        self.sid = sid
        self.pump = pump
        self.on_done = on_done
        self.free_frames = free_frames
        self.binding: Optional[_PushBinding] = None


_reg_lock = threading.Lock()
_sources: Dict[str, _RegisteredSource] = {}  # rt: guarded-by(_reg_lock)


def register_source(sid: str, pump: Any,
                    on_done: Optional[Callable[[], None]] = None,
                    free_frames: bool = False) -> None:
    with _reg_lock:
        _sources[sid] = _RegisteredSource(sid, pump, on_done, free_frames)


def unregister_source(sid: str) -> None:
    """Drop the source (cancel / stream finished via pull). Stops a live
    push pump; does NOT close the pump (the stream owner does that). A
    ``free_frames`` source's pushed frames are freed once its pump has
    stopped."""
    with _reg_lock:
        rs = _sources.pop(sid, None)
    if rs is not None and rs.binding is not None:
        binding = rs.binding
        binding.request_stop()
        if rs.free_frames:
            async def free_when_stopped():
                await binding.wait_finished()
                await free_frames(binding.backend, binding.take_frames(0))
            binding.on_loop(lambda: spawn_task(free_when_stopped()))


async def reclaim(sid: str, delivered: int
                  ) -> Tuple[List[Any], bool, Optional[BaseException]]:
    """Pull-fallback handoff: detach the push binding and return the
    replay tail past the consumer's ``delivered`` count, plus whether the
    source was already exhausted and any pending stream error.
    Runs on the producer's event loop (async actor method).

    Await-the-pump matters: the pump task may be blocked INSIDE
    ``pump.take`` right now — the items that take returns are stashed
    into the replay buffer only when it lands, so snapshotting the
    buffer without waiting would silently drop an in-flight burst
    (observed as a one-token hole at the fallback boundary)."""
    with _reg_lock:
        rs = _sources.get(sid)
    if rs is None or rs.binding is None:
        return ([], False, None)
    binding, rs.binding = rs.binding, None
    binding.request_stop()
    try:
        await asyncio.wait_for(binding.wait_finished(), timeout=60.0)
    except asyncio.TimeoutError:
        pass  # wedged source: serve what the buffer has
    items = [it for seq, it in binding.replay if seq >= delivered]
    # the consumer decoded (and freed) the frames before ``delivered``;
    # the rest are re-encoded for it, so their pushed copies go
    await free_frames(binding.backend, binding.take_frames(delivered))
    err: Optional[BaseException] = None
    if binding.error_payload is not None:
        decoded = binding.backend.serde.deserialize_payload(
            memoryview(binding.error_payload))
        err = (decoded if isinstance(decoded, BaseException)
               else RuntimeError(f"stream failed: {decoded!r}"))
    return (items, binding.source_done, err)


async def drain_source(sid: str, delivered: int
                       ) -> Tuple[List[Any], bool, Optional[BaseException]]:
    """One-shot pull fallback for FINITE sources (weight shipments):
    :func:`reclaim` the pushed-but-undelivered tail, then drain the
    pump to exhaustion and deregister the source. Returns
    ``(items, known, error)`` — ``known`` False when ``sid`` names no
    registered source and nothing was replayed (spent or never
    shipped). Unlike the serve path's resume_pull (which keeps the
    stream open for further next_chunks pulls), this settles the whole
    stream in one reply. Runs on the producer's event loop."""
    items, done, err = await reclaim(sid, delivered)
    if err is not None:
        unregister_source(sid)
        return (items, True, err)
    with _reg_lock:
        rs = _sources.get(sid)
    if rs is None and not items and not done:
        return ([], False, None)
    pump = rs.pump if rs is not None else None
    while pump is not None and not done:
        more, done = await pump.take(_PUMP_BATCH)
        items.extend(more)
    unregister_source(sid)
    return (items, True, None)


async def settle_source(sid: str, grace_s: float = 5.0
                        ) -> Optional[List[Any]]:
    """Producer-side settlement for FINITE pushed streams (the
    streaming-generator path): wait for the pump to land and (briefly)
    for the consumer's final credit. Returns None when the stream
    COMPLETED over push (every item acked — nothing left to do), else
    the unacked tail items to redeliver over the legacy acked path
    (redelivery is idempotent there: the owner stores by index). Always
    deregisters the source on the non-completed path. Runs on the
    producer's event loop."""
    with _reg_lock:
        rs = _sources.get(sid)
    if rs is None:
        return None  # already completed (on_done popped it)
    binding = rs.binding
    if binding is None:
        rt_items = []  # registered but never subscribed: nothing pushed
        unregister_source(sid)
        return rt_items
    await binding.wait_finished()
    deadline = asyncio.get_running_loop().time() + grace_s
    while (not binding.completed and binding.source_done
           and binding.conn.alive and not binding._stop
           and asyncio.get_running_loop().time() < deadline):
        await asyncio.sleep(0.02)
    if binding.completed:
        return None
    tail = [it for seq, it in binding.replay if seq >= binding.acked]
    unregister_source(sid)
    return tail


def peek_unacked(sid: str) -> List[Any]:
    """Producer-THREAD escape hatch for a wedged event loop: a racy
    snapshot of ``sid``'s pushed-but-unacked replay items. The replay
    deque is loop-confined, so reading it off-loop can at worst observe
    a stale acked watermark and over-return — safe for the generator
    path, where redelivery is idempotent by index; dropping a
    pushed-but-unacked item would hole the stream instead."""
    with _reg_lock:
        rs = _sources.get(sid)
    binding = rs.binding if rs is not None else None
    if binding is None:
        return []
    for _ in range(50):
        try:
            acked = binding.acked
            return [it for seq, it in list(binding.replay) if seq >= acked]
        except RuntimeError:
            # deque mutated mid-snapshot (loop overloaded, not dead):
            # retry — raising here would fail the very task this
            # fallback exists to rescue
            time.sleep(0.01)
    return []


class _PushBinding:
    """Producer half of one subscribed channel: the pump task, the
    credit window, and the replay buffer fallback reclaims from.
    All state is confined to the producer's event loop (credits arrive
    on the server read loop, the pump runs as a sibling task)."""

    def __init__(self, backend, rs: _RegisteredSource,
                 conn: ServerConnection, channel_id: str, window: int):
        self.backend = backend
        self.rs = rs
        self.conn = conn
        self.channel_id = channel_id
        self.window = max(2, window)
        self.sent = 0
        self.acked = 0
        self.replay: deque = deque()  # (seq, item) pushed but unacked
        # seq -> descriptor of each oid frame pushed, kept for a
        # ``free_frames`` source until the stream settles
        self.frame_oids: Dict[int, Tuple] = {}
        self.source_done = False      # pump exhausted the source
        self.error_payload: Optional[bytes] = None
        self.completed = False
        self._stop = False
        self._credit_event = asyncio.Event()
        self._finished = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = spawn_task(self._run_pump())

    async def _run_pump(self) -> None:
        try:
            await self._pump()
        finally:
            # reclaim synchronizes on this: the replay buffer is only
            # complete once the pump (and any in-flight take) has landed
            self._finished.set()

    async def wait_finished(self) -> None:
        await self._finished.wait()

    # -- endpoint interface (called from the server read loop) ------------
    def on_credit(self, consumed: int, closed: bool) -> None:
        if consumed > self.acked:
            self.acked = consumed
            while self.replay and self.replay[0][0] < self.acked:
                self.replay.popleft()
        if closed:
            # "stop pushing": completion when everything was consumed,
            # otherwise a fallback/cancel detach — the stream itself is
            # settled by resume_pull or cancel_stream, not by this frame
            self._stop = True
            if self.source_done and self.acked >= self.sent:
                self._complete()
            else:
                self._notify_pump_stop()
        self._credit_event.set()

    def on_disconnect(self) -> None:
        self._stop = True
        self._notify_pump_stop()
        self._credit_event.set()

    def request_stop(self) -> None:
        """Safe from any thread (cancel_stream runs on executor threads):
        the event wakeup is routed to the producer's loop."""
        self._stop = True
        self._notify_pump_stop()
        self.on_loop(self._credit_event.set)

    def on_loop(self, fn: Callable[[], Any]) -> None:
        """``fn()`` on the producer's loop: now when called there, else
        scheduled from this thread."""
        loop = self.backend.loop
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            fn()
        elif not loop.is_closed():
            loop.call_soon_threadsafe(fn)

    def take_frames(self, first_seq: int) -> List[Tuple]:
        """The recorded oid frames from ``first_seq`` on; the record is
        cleared (each frame is freed once)."""
        out = [d for seq, d in self.frame_oids.items() if seq >= first_seq]
        self.frame_oids.clear()
        return out

    def _notify_pump_stop(self) -> None:
        """A detached/broken binding may strand a pump ``take`` parked on
        a quiet source: pumps exposing ``binding_stopped()`` (the
        streaming-generator push pump) are woken so the producer thread
        can settle and fall back. Serve pumps don't define it — their
        settlement runs through reclaim/resume_pull instead."""
        fn = getattr(self.rs.pump, "binding_stopped", None)
        if fn is not None:
            try:
                fn()
            except Exception:  # noqa: BLE001 — wake is best-effort
                pass

    def _complete(self) -> None:
        """The consumer saw the final frame and acked every item: settle
        the stream (release the replica slot) exactly once."""
        if self.completed:
            return
        self.completed = True
        with _reg_lock:
            _sources.pop(self.rs.sid, None)
        if self.frame_oids:
            # the consumer took the final frame after decoding (and so
            # freeing) every other: this frees the copies on this node
            # where the consumer's were on another
            spawn_task(free_frames(self.backend, self.take_frames(0)))
        if self.rs.on_done is not None:
            try:
                self.rs.on_done()
            except Exception:  # noqa: BLE001 — owner callback
                pass

    # -- the pump ---------------------------------------------------------
    async def _pump(self) -> None:
        try:
            while not self._stop:
                # credit window: park until the consumer catches up
                while (self.sent - self.acked >= self.window
                       and not self._stop):
                    self._credit_event.clear()
                    await self._credit_event.wait()
                if self._stop:
                    return
                try:
                    items, done = await self.rs.pump.take(
                        min(_PUMP_BATCH, self.window))
                except asyncio.CancelledError:
                    raise
                except BaseException as e:  # noqa: BLE001 — error transport
                    # the stream's failure travels as a final error frame
                    self.error_payload = \
                        self.backend.serde.serialize(e).to_bytes()
                    self.source_done = True
                    await self._push([(_KIND_ERR, self.error_payload)],
                                     done=True)
                    return
                if self._stop:
                    # stopped while blocked in take(): the taken items
                    # must not vanish — stash them for reclaim
                    for it in items:
                        self.replay.append((self.sent, it))
                        self.sent += 1
                    self.source_done = self.source_done or done
                    return
                wire = []
                try:
                    for it in items:
                        # replay BEFORE encode: a failing plasma spill
                        # (raylet hiccup mid-encode) must leave the item
                        # reclaimable, not silently dropped
                        self.replay.append((self.sent, it))
                        self.sent += 1
                        wire.append(await self._encode(it))
                        if self.rs.free_frames and wire[-1][0] == _KIND_OID:
                            self.frame_oids[self.sent - 1] = wire[-1][1]
                except asyncio.CancelledError:
                    raise
                except ConnectionLost:
                    return
                except Exception as e:  # noqa: BLE001 — error transport
                    # encode infrastructure failed (not the user stream):
                    # the consumer must not hang on a silent pump death —
                    # surface it as the stream's error frame
                    self.error_payload = \
                        self.backend.serde.serialize(e).to_bytes()
                    self.source_done = True
                    await self._push([(_KIND_ERR, self.error_payload)],
                                     done=True)
                    return
                if done:
                    self.source_done = True
                await self._push(wire, done)
                if done:
                    return
        except ConnectionLost:
            # consumer connection died mid-push: keep replay for the
            # pull fallback's resume_pull
            return

    async def _push(self, wire: List[Tuple], done: bool) -> None:
        seq0 = self.sent - len(wire)
        n = await self.conn.push(self.channel_id, seq0, wire, done)
        try:
            frames_total().inc(1.0, {"transport": "push"})
            bytes_total().inc(float(n), {"transport": "push"})
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    async def _encode(self, item: Any) -> Tuple:
        return await encode_item(self.backend, item)


async def encode_item(backend, item: Any) -> Tuple:
    """One item as a wire item: small values inline; large byte payloads
    spilled to plasma so same-node consumers mmap them instead of copying
    through the frame (the object-plane fast path). The payload is
    serialized straight into the store's buffer (one copy of its bytes)
    on an executor thread, so the loop keeps serving credits and frames
    meanwhile. ``take_decoded_wire`` decodes it. Runs on the producer's
    event loop."""
    size = _payload_size(item)
    if size is None or size <= inline_max_bytes():
        return (_KIND_VAL, item)
    oid = global_worker().next_put_id()

    def spill() -> int:
        so = backend.serde.serialize(item)
        n = so.total_bytes()
        so.write_to(backend.plasma.create(oid, n))
        backend.plasma.seal(oid)
        # consumers map the sealed file themselves: this process keeps no
        # map, so the pages go when the object is freed
        backend.plasma.release(oid)
        return n

    n = await asyncio.get_running_loop().run_in_executor(None, spill)
    await backend._raylet.call("seal_object", {"oid": oid.hex(), "size": n})
    ref = ObjectRef(oid, owner=backend.address)
    return (_KIND_OID, ref._descriptor(), n)


async def free_frames(backend, descriptors: List[Tuple]) -> None:
    """Free oid frames' objects: this process's map of each, and the copy
    in this node's store (the raylet's ``free_objects``)."""
    if not descriptors:
        return
    refs = [ObjectRef._rehydrate(d) for d in descriptors]
    for ref in refs:
        backend.plasma.delete(ref.id())
    await backend._raylet.call("free_objects",
                               {"oids": [ref.hex() for ref in refs]})


def _payload_size(item: Any) -> Optional[int]:
    """Cheap size probe for spill decisions: byte-likes and array-likes
    report their payload size; small scalars/objects return None (inline,
    no serialization probe on the per-token hot path)."""
    if isinstance(item, (bytes, bytearray, memoryview)):
        return len(item)
    if isinstance(item, str):
        return len(item)
    nbytes = getattr(item, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    return None


async def handle_subscribe(backend, p: Dict) -> Dict:
    """``stream_subscribe`` RPC handler (registered by ClusterBackend on
    every process): bind the registered source ``sid`` to a push endpoint
    on the connection this RPC arrived on."""
    sid = p.get("sid")
    channel_id = p.get("channel")
    conn = current_server_connection()
    if conn is None or not conn.alive:
        return {"ok": False, "error": "no connection context"}
    with _reg_lock:
        rs = _sources.get(sid)
    if rs is None:
        return {"ok": False, "unknown": True}
    if rs.binding is not None:
        return {"ok": False, "busy": True}
    binding = _PushBinding(backend, rs, conn, channel_id,
                           int(p.get("window") or stream_window()))
    rs.binding = binding
    conn.endpoints[channel_id] = binding
    binding.start()
    return {"ok": True}


# ---------------------------------------------------------------------------
# consumer side
# ---------------------------------------------------------------------------


async def subscribe(backend, address: str, sid: str,
                    window: Optional[int] = None) -> Optional[StreamChannel]:
    """Open a channel to the producer at ``address`` and subscribe it to
    stream ``sid``. Returns None when the producer doesn't serve push
    (unknown sid / already bound) — the caller stays on the pull path."""
    win = window or stream_window()
    client = await backend._pool.get(address)
    ch = client.open_channel(win)
    try:
        reply = await client.call(
            "stream_subscribe",
            {"sid": sid, "channel": ch.id, "window": win}, timeout=30.0)
    except Exception:
        client._channels.pop(ch.id, None)
        raise
    if not reply.get("ok"):
        client._channels.pop(ch.id, None)
        return None
    return ch


async def take_decoded(backend, ch: StreamChannel,
                       free: bool = False) -> Tuple[Any, bool]:
    """Next decoded item from a push channel: ``(item, False)`` or
    ``(None, True)`` at end of stream. Raises ChannelBroken on transport
    loss (the consumer falls back to pull) and re-raises a pushed error
    frame (stream failure transport, matching the pull path's
    next_chunks contract). ``free``: see ``take_decoded_wire``."""
    c = _chaos._STATE
    if c is not None:
        f = _chaos.maybe_fire("rpc.drop", target="stream_push")
        if f is not None:
            raise ChannelBroken("chaos: dropped push stream")
    item = await ch.take()
    if item is CHANNEL_DONE:
        return (None, True)
    return await take_decoded_wire(backend, item, free)


async def take_decoded_wire(backend, wire_item: Tuple,
                            free: bool = False) -> Tuple[Any, bool]:
    """Decode one raw frame item: inline values pass through, oid frames
    resolve through the object plane (same-node: zero-copy mmap), error
    frames re-raise the stream's failure. ``free``: an oid frame's object
    is freed once decoded (a stream whose frames have one reader)."""
    kind = wire_item[0]
    if kind == _KIND_VAL:
        return (wire_item[1], False)
    if kind == _KIND_OID:
        ref = ObjectRef._rehydrate(wire_item[1])
        payload = await backend._resolve_payload(ref, timeout=60.0)
        value = backend.serde.deserialize_payload(payload)
        if free:
            del payload
            await free_frames(backend, [wire_item[1]])
        return (value, False)
    if kind == _KIND_ERR:
        err = backend.serde.deserialize_payload(memoryview(wire_item[1]))
        if isinstance(err, BaseException):
            raise err
        raise RuntimeError(f"stream failed: {err!r}")
    raise RuntimeError(f"unknown stream frame kind {kind!r}")


def inline_values(wire_items: List[Tuple]) -> Tuple[List[Any], List[Tuple]]:
    """(decoded inline-value prefix, undecoded remainder): the proxy's
    zero-await burst path takes the prefix; oid/error frames wait for
    the async decoding path."""
    out: List[Any] = []
    for i, w in enumerate(wire_items):
        if w[0] != _KIND_VAL:
            return out, list(wire_items[i:])
        out.append(w[1])
    return out, []


async def decode_backlog(backend, ch: Optional[StreamChannel],
                         wire: List[Tuple]) -> Tuple[List[Any], bool]:
    """Fallback prologue: decode every frame the consumer physically
    possesses (parked wire items + the channel's remaining buffer) so the
    resume point is exact. Error frames are SKIPPED — the producer's
    binding holds the error and redelivers it through ``reclaim``."""
    if ch is not None:
        wire = list(wire) + ch.take_available()
    out: List[Any] = []
    saw_error = False
    for w in wire:
        if w[0] == _KIND_ERR:
            saw_error = True
            continue
        item, _ = await take_decoded_wire(backend, w)
        out.append(item)
    done = (not saw_error) and ch is not None and ch.is_done()
    return (out, done)
