"""Asyncio TCP RPC: the framework's gRPC-equivalent plumbing.

Fills the role of the reference's ``src/ray/rpc/`` (``GrpcServer``,
``ClientCall`` with connection pooling): every process runs one ``RpcServer``
on its background event-loop thread; ``RpcClient`` multiplexes concurrent
calls over a single connection with correlation ids. ``SyncRpcProxy`` adapts
the async client for synchronous callers (the driver main thread, task code).

Frame format: 4-byte LE length | pickled (kind, msg_id, method, payload).
Payloads are plain picklable values — large tensors never travel here; they
go through the shm object plane.

Push-based streaming (the per-token-RPC killer, reference: Ray's core
streaming generators pushing results over the worker's persistent
connection instead of the caller polling): two ONE-WAY frame kinds ride
the same connections. A server endpoint pushes ``_PUSH`` frames down an
established connection keyed by channel id — no reply slot, no
correlation future — and the client answers with ``_CREDIT`` frames
carrying its cumulative consumed count, which is the backpressure window:
a producer with ``sent - acked >= window`` parks until credit arrives
instead of ballooning either side's buffers. ``StreamChannel`` is the
client half; ``ServerConnection`` (exposed to handlers via
``current_server_connection()``) is the server half. Connection loss
fails every channel on it — consumers fall back to their pull path.
"""

from __future__ import annotations

import asyncio
import contextvars
import pickle
import socket
import struct
import threading
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

_LEN = struct.Struct("<I")
_REQ, _REP, _ERR, _PUSH, _CREDIT = 0, 1, 2, 3, 4

MAX_FRAME = 512 * 1024 * 1024


class RpcError(Exception):
    pass


# Strong references for fire-and-forget tasks. The event loop keeps only
# WEAK references to tasks; a pending task whose await chain isn't rooted in
# a live object is garbage-collected MID-FLIGHT ("Task was destroyed but it
# is pending!"). Observed in the wild: a GC'd GcsServer._schedule_actor left
# its actor PENDING_CREATION forever, and GC'd worker-side handler/consumer
# tasks swallowed delivered actor calls without ever replying. Every
# fire-and-forget in the framework must go through spawn_task().
_BG_TASKS: set = set()


def spawn_task(coro) -> "asyncio.Task":
    t = asyncio.ensure_future(coro)
    _BG_TASKS.add(t)
    t.add_done_callback(_BG_TASKS.discard)
    return t


async def cancel_and_wait(*tasks) -> None:
    """Cancel tasks and await their completion, swallowing every outcome
    (CancelledError is a BaseException, hence the explicit tuple)."""
    live = [t for t in tasks if t is not None and not t.done()]
    for t in live:
        t.cancel()
    for t in live:
        try:
            await t
        except asyncio.CancelledError:
            cur = asyncio.current_task()
            # Task.cancelling() is 3.11+; on 3.10 fall back to swallowing
            # (the pre-cancelling() semantics) rather than crashing every
            # teardown path with AttributeError.
            cancelling = getattr(cur, "cancelling", None)
            if cancelling is not None and cancelling():
                raise  # our caller was cancelled at this await — honor it
        except Exception:  # noqa: BLE001
            pass


class ConnectionLost(RpcError):
    pass


class ChannelBroken(RpcError):
    """The connection carrying a push stream died (or the producer
    vanished). Consumers catch this and fall back to their pull path."""


#: ``StreamChannel.take()`` returns this when the producer pushed its
#: final frame — a sentinel, not an exception: takes cross thread/loop
#: boundaries via run_coroutine_threadsafe, where exception identity blurs.
CHANNEL_DONE = object()

_STREAM_WINDOW_DEFAULT = 128


class StreamChannel:
    """Client half of one push stream: a bounded local buffer fed by
    ``_PUSH`` frames from the server, drained by the consumer with zero
    RPCs. Consuming items sends cumulative ``_CREDIT`` frames (one per
    half-window, not per item) — the producer's backpressure signal.

    Buffer bound: the producer stops at ``window`` unacked items, so the
    deque here never holds more than ``window`` + one in-flight batch.
    Thread-safety: ``_items`` is guarded for ``take_available`` callers on
    foreign threads; the awaiting side (``take``) is affine to the owning
    client's event loop.
    """

    def __init__(self, client: "RpcClient", channel_id: str, window: int):
        self._client = client
        self.id = channel_id
        self.window = max(2, window)
        self._lock = threading.Lock()
        self._items: deque = deque()      # rt: guarded-by(_lock)
        self._done = False                # rt: guarded-by(_lock)
        self._broken: Optional[str] = None  # rt: guarded-by(_lock)
        self._event = asyncio.Event()     # loop-affine wakeup
        self._consumed = 0                # items handed to the consumer
        self._credited = 0                # last cumulative credit sent
        self._closed = False
        self._final_credit_sent = False

    # -- fed from the client read loop (client's event loop) --------------
    def _feed(self, items, done: bool) -> None:
        with self._lock:
            self._items.extend(items)
            if done:
                self._done = True
        self._event.set()

    def _fail(self, reason: str) -> None:
        with self._lock:
            if not self._done:
                self._broken = reason
        self._event.set()

    # -- consumer side ----------------------------------------------------
    async def take(self):
        """Next item, ``CHANNEL_DONE`` when the stream completed, or
        raises :class:`ChannelBroken` when the connection died with the
        stream unfinished. Must run on the owning client's loop."""
        while True:
            got = False
            done_now = False
            send_final = False
            item = None
            send_credit = False
            with self._lock:
                if self._items:
                    item = self._items.popleft()
                    got = True
                    self._consumed += 1
                    if (self._consumed - self._credited
                            >= max(1, self.window // 2)):
                        self._credited = self._consumed
                        send_credit = True
                elif self._done:
                    done_now = True
                    send_final = not self._final_credit_sent
                    self._final_credit_sent = True
                elif self._broken is not None:
                    raise ChannelBroken(self._broken)
                else:
                    self._event.clear()
            if done_now:
                # final cumulative credit, closed: tells the producer
                # every item was consumed so it can settle the stream
                # (release the replica's in-flight slot) NOW instead of
                # at consumer GC time
                if send_final:
                    await self._client._send_credit(
                        self.id, self._consumed, closed=True)
                return CHANNEL_DONE
            if send_credit:
                await self._client._send_credit(self.id, self._credited)
            if got:
                return item
            await self._event.wait()

    def is_done(self) -> bool:
        """True once the final frame arrived AND the local buffer is
        fully drained (thread-safe)."""
        with self._lock:
            return self._done and not self._items

    def take_available(self):
        """Drain everything already buffered, without awaiting — the
        proxy's burst coalescing path. Thread-safe; credits are posted to
        the client loop if a half-window was crossed."""
        with self._lock:
            out = list(self._items)
            self._items.clear()
            self._consumed += len(out)
            send = (self._consumed - self._credited
                    >= max(1, self.window // 2))
            if send:
                credited = self._credited = self._consumed
        if send:
            self._client._spawn_on_loop(
                self._client._send_credit(self.id, credited))
        return out

    def close(self) -> None:
        """Consumer abandons the stream: tell the producer to stop
        (closed credit) and deregister. Safe from any thread."""
        if self._closed:
            return
        self._closed = True
        self._client._channels.pop(self.id, None)
        self._client._spawn_on_loop(
            self._client._send_credit(self.id, self._consumed, closed=True))


class ServerConnection:
    """Server half of one accepted connection: the writer a handler can
    push one-way frames down, plus the endpoint registry ``_CREDIT``
    frames dispatch into. Handlers reach their connection through
    :func:`current_server_connection` — the subscribe RPC that opens a
    push stream binds its producer to exactly the connection it arrived
    on, so frames ride the consumer's existing socket."""

    def __init__(self, writer: asyncio.StreamWriter, lock: asyncio.Lock):
        self._writer = writer
        self._lock = lock
        self.alive = True
        # channel_id -> endpoint with on_credit(consumed, closed) /
        # on_disconnect(); mutated only on the server's event loop
        self.endpoints: Dict[str, Any] = {}

    async def push(self, channel_id: str, seq: int, items, done: bool
                   ) -> int:
        """One-way push of a frame batch; returns the wire size in bytes.
        Raises ConnectionLost when the consumer's connection is gone."""
        if not self.alive:
            raise ConnectionLost("push connection closed")
        try:
            async with self._lock:
                n = _write_frame(self._writer,
                                 (_PUSH, seq, channel_id, (items, done)))
                await self._writer.drain()
            return n
        except (ConnectionResetError, BrokenPipeError, RuntimeError) as e:
            # RuntimeError: writer closed under us mid-drain
            self.alive = False
            raise ConnectionLost(f"push failed: {e!r}") from None

    def _on_credit(self, channel_id: str, consumed: int, closed: bool
                   ) -> None:
        ep = self.endpoints.get(channel_id)
        if ep is not None:
            if closed:
                self.endpoints.pop(channel_id, None)
            ep.on_credit(consumed, closed)

    def _on_disconnect(self) -> None:
        self.alive = False
        eps, self.endpoints = list(self.endpoints.values()), {}
        for ep in eps:
            try:
                ep.on_disconnect()
            except Exception:  # noqa: BLE001 — teardown fanout
                pass


_server_conn_var: "contextvars.ContextVar[Optional[ServerConnection]]" = \
    contextvars.ContextVar("rt_server_conn", default=None)


def current_server_connection() -> Optional[ServerConnection]:
    """The connection the currently-executing RPC handler arrived on
    (None outside a handler). Handler tasks inherit it via the context
    snapshot taken when the per-request task is spawned."""
    return _server_conn_var.get()


# Lazily-bound chaos module (util/chaos.py): the rpc layer stays free of
# top-level ray_tpu_torch imports, and the unarmed fast path is one attribute
# check per call.
_chaos_mod = None


def _chaos():
    global _chaos_mod
    if _chaos_mod is None:
        from ray_tpu_torch.util import chaos

        _chaos_mod = chaos
    return _chaos_mod


_reconnect_counter = None


def _observe_reconnect(outcome: str) -> None:
    """``rt_rpc_reconnects_total{outcome=}``: one tick per reconnect dial
    attempt (ok / error), in the reconnecting process's registry. Never
    raises — reconnect telemetry must not break the reconnect."""
    global _reconnect_counter
    try:
        from ray_tpu_torch.util import metrics as M

        if _reconnect_counter is None:
            _reconnect_counter = M.get_or_create(
                M.Counter, "rt_rpc_reconnects_total",
                "RPC client reconnect dial attempts after a dropped "
                "connection, by outcome", tag_keys=("outcome",))
        _reconnect_counter.inc(1.0, {"outcome": outcome})
    except Exception:  # noqa: BLE001
        pass


def bind_host() -> str:
    """The interface servers bind (config ``bind_host``; default loopback).
    Set RT_BIND_HOST=0.0.0.0 on multi-host clusters."""
    from ray_tpu_torch._private.config import get_config

    return get_config().bind_host or "127.0.0.1"


def advertised_host(bind: str) -> str:
    """The address peers should dial for a server bound to ``bind``:
    a wildcard bind advertises this machine's outbound-interface IP
    (UDP connect probe — no packet is sent)."""
    if bind in ("", "127.0.0.1", "localhost"):
        return "127.0.0.1"
    if bind in ("0.0.0.0", "::"):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
        except OSError:
            try:
                return socket.gethostbyname(socket.gethostname())
            except OSError:
                return "127.0.0.1"
        finally:
            s.close()
    return bind


async def _read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise RpcError(f"frame too large: {n}")
    body = await reader.readexactly(n)
    return pickle.loads(body)


def _write_frame(writer: asyncio.StreamWriter, msg: Any) -> int:
    body = pickle.dumps(msg, protocol=5)
    writer.write(_LEN.pack(len(body)) + body)
    return len(body)


class RpcServer:
    """Dispatches ``method`` to registered async handlers.

    Handlers are ``async def handler(payload) -> reply``. A handler may take
    arbitrarily long; other requests on the same connection are not blocked.
    """

    def __init__(self, loop: asyncio.AbstractEventLoop,
                 host: Optional[str] = None):
        self._loop = loop
        self._host = host if host is not None else bind_host()
        self._advertise = advertised_host(self._host)
        self._handlers: Dict[str, Callable] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._on_disconnect: Optional[Callable] = None
        self._writers: set = set()
        self.port: int = 0

    def register(self, method: str, handler: Callable) -> None:
        self._handlers[method] = handler

    def register_object(self, obj: Any, prefix: str = "") -> None:
        """Register every ``rpc_*`` coroutine method of ``obj``."""
        for name in dir(obj):
            if name.startswith("rpc_"):
                self.register(prefix + name[4:], getattr(obj, name))

    def set_disconnect_handler(self, fn: Callable) -> None:
        """fn(peer_id) called when a connection identified via 'hello' drops."""
        self._on_disconnect = fn

    async def start(self, port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle_conn, self._host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    @property
    def address(self) -> str:
        return f"{self._advertise}:{self.port}"

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        peer_id: Optional[str] = None
        write_lock = asyncio.Lock()
        conn = ServerConnection(writer, write_lock)
        # handler tasks spawned below snapshot this context, so any
        # handler can bind a push endpoint to ITS connection
        _server_conn_var.set(conn)
        self._writers.add(writer)
        try:
            while True:
                kind, msg_id, method, payload = await _read_frame(reader)
                if kind == _CREDIT:
                    # one-way consumer credit: no reply slot, no handler
                    conn._on_credit(method, msg_id,
                                    bool(payload and payload.get("closed")))
                    continue
                if method == "hello":
                    peer_id = payload.get("peer_id")
                handler = self._handlers.get(method)
                if handler is None and method == "hello":
                    async def handler(p):  # default hello ack
                        return {"ok": True}
                spawn_task(
                    self._run_handler(handler, method, msg_id, payload,
                                      writer, write_lock))
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        finally:
            conn._on_disconnect()
            self._writers.discard(writer)
            if peer_id and self._on_disconnect:
                try:
                    res = self._on_disconnect(peer_id)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    pass
            writer.close()

    async def _run_handler(self, handler, method, msg_id, payload, writer, lock):
        try:
            if handler is None:
                raise RpcError(f"no handler for method {method!r}")
            reply = await handler(payload)
            kind, body = _REP, reply
        except asyncio.CancelledError:
            # server teardown cancelling in-flight handlers: cancellation
            # must stay cancellation — pickling it across the wire as the
            # "reply" would make shutdown look like an application error
            # (and write to a closing transport)
            raise
        except BaseException as e:  # noqa: BLE001 — errors cross the wire
            kind, body = _ERR, e
        try:
            async with lock:
                try:
                    _write_frame(writer, (kind, msg_id, method, body))
                except Exception as pickle_err:
                    # Reply (or raised exception) was unpicklable — the caller
                    # must still get a frame or its future waits forever.
                    _write_frame(writer, (_ERR, msg_id, method,
                                          RpcError(f"unserializable reply for "
                                                   f"{method!r}: {pickle_err!r}")))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Force-close live connections; 3.12's wait_closed() would block
            # on our long-lived per-connection read loops.
            for w in list(self._writers):
                try:
                    w.close()
                except Exception:
                    pass
            self._writers.clear()


class RpcClient:
    """One multiplexed connection to a server; safe for concurrent calls.

    ``auto_reconnect=True`` makes ``call`` re-dial a dropped connection
    (single-flight) instead of failing forever — the client half of GCS
    head-restart recovery (reference: ``GcsClient`` auto-reconnect,
    ``_raylet.pyx:2346``): long-lived daemons (raylets, pollers) ride out
    a head crash and their next call lands on the resurrected server.
    In-flight calls at drop time still fail with ConnectionLost — only
    NEW calls reconnect; callers with at-most-once concerns keep their
    retry decisions."""

    def __init__(self, address: str, peer_id: str = "",
                 auto_reconnect: bool = False):
        self.address = address
        self._peer_id = peer_id
        self.auto_reconnect = auto_reconnect
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        # push-stream channels multiplexed on this connection; fed by the
        # read loop, failed as a group when the connection drops
        self._channels: Dict[str, StreamChannel] = {}
        self._next_channel = 0
        self._next_id = 0
        self._lock: Optional[asyncio.Lock] = None
        self._closed = False
        self._explicitly_closed = False
        self._reconnect_lock: Optional[asyncio.Lock] = None
        self._reconnect_failed_at = -1e9  # monotonic stamp of last failure

    async def connect(self) -> None:
        host, port = self.address.rsplit(":", 1)
        self._reader, self._writer = await asyncio.open_connection(host, int(port))
        self._lock = asyncio.Lock()
        self._loop = asyncio.get_running_loop()
        self._closed = False
        self._read_task = asyncio.ensure_future(self._read_loop())
        if self._peer_id:
            await self.call("hello", {"peer_id": self._peer_id})

    async def _reconnect(self) -> None:
        if self._reconnect_lock is None:
            self._reconnect_lock = asyncio.Lock()
        async with self._reconnect_lock:
            if not self._closed:
                return  # another caller won the race
            if self._explicitly_closed:
                raise ConnectionLost(
                    f"connection to {self.address} closed")
            # Capped exponential backoff + jitter across several re-dials
            # (reference: gcs_rpc_client retry pacing): a restarted head
            # takes a moment to rebind its port, and an immediate single
            # re-dial both loses that race and — across a fleet of
            # reconnecting raylets — stampedes the resurrected server.
            from ray_tpu_torch._private.config import get_config
            from ray_tpu_torch.core.failure import backoff_with_jitter

            cfg = get_config()
            # Failure memo: callers queued on the lock behind a cycle that
            # just exhausted its attempts fail FAST instead of each
            # re-dialing the full backoff ladder (K serialized callers
            # would otherwise stack K x the cycle time).
            import time as _time

            if (_time.monotonic() - self._reconnect_failed_at
                    < max(2.0, cfg.rpc_reconnect_max_s)):
                raise ConnectionLost(
                    f"reconnect to {self.address} is failing "
                    f"(recent attempt cycle exhausted; retry suppressed)")
            attempts = max(1, cfg.rpc_reconnect_attempts)
            last_err: Optional[BaseException] = None
            for attempt in range(1, attempts + 1):
                await cancel_and_wait(getattr(self, "_read_task", None))
                if self._writer is not None:
                    # release the dead socket before dialing again — daemons
                    # riding out repeated head crashes must not leak one FD
                    # per reconnect cycle
                    self._writer.close()
                    self._writer = None
                try:
                    # each dial is BOUNDED: a blackholed host (SYN dropped,
                    # no RST) or a server that accepts TCP but never
                    # answers hello must burn one attempt, not wedge every
                    # caller serialized on the reconnect lock
                    await asyncio.wait_for(
                        self.connect(), max(2.0, cfg.rpc_reconnect_max_s))
                    _observe_reconnect("ok")
                    self._reconnect_failed_at = -1e9
                    return
                except (OSError, ConnectionLost, asyncio.TimeoutError) as e:
                    # ConnectionLost too: connect() ends with a hello RPC
                    # that dies mid-handshake when the server is still
                    # going down — that's a retryable dial, not a verdict
                    self._closed = True  # a partial dial is cleaned up at
                    last_err = e         # the top of the next iteration
                    _observe_reconnect("error")
                    if attempt < attempts:
                        await asyncio.sleep(backoff_with_jitter(
                            attempt, cfg.rpc_reconnect_base_s,
                            cfg.rpc_reconnect_max_s))
            self._reconnect_failed_at = _time.monotonic()
            raise ConnectionLost(
                f"reconnect to {self.address} failed after {attempts} "
                f"attempt(s): {last_err}") from None

    def open_channel(self, window: int = _STREAM_WINDOW_DEFAULT
                     ) -> StreamChannel:
        """Allocate a push-stream channel on this connection. The caller
        passes the returned ``channel.id`` to the server (via a normal
        RPC) so the producer knows where to push."""
        self._next_channel += 1
        ch = StreamChannel(self, f"ch{id(self):x}-{self._next_channel}",
                           window)
        self._channels[ch.id] = ch
        return ch

    async def _send_credit(self, channel_id: str, consumed: int,
                           closed: bool = False) -> None:
        """One-way cumulative-consumed credit to the producer; never
        raises — a dropped connection already fails the channel via the
        read loop, and credit for a dead producer is moot."""
        try:
            async with self._lock:
                _write_frame(self._writer,
                             (_CREDIT, consumed, channel_id,
                              {"closed": closed} if closed else None))
                await self._writer.drain()
        except Exception:  # noqa: BLE001 — connection gone; channel fails
            pass

    def _spawn_on_loop(self, coro) -> None:
        """Schedule a coroutine on this client's loop from any thread."""
        loop = getattr(self, "_loop", None)
        if loop is None or loop.is_closed():
            coro.close()
            return
        try:
            if asyncio.get_running_loop() is loop:
                spawn_task(coro)
                return
        except RuntimeError:
            pass
        loop.call_soon_threadsafe(spawn_task, coro)

    async def _read_loop(self) -> None:
        try:
            while True:
                kind, msg_id, method, body = await _read_frame(self._reader)
                if kind == _PUSH:
                    ch = self._channels.get(method)
                    if ch is not None:
                        items, done = body
                        ch._feed(items, done)
                        if done:
                            self._channels.pop(method, None)
                    else:
                        # consumer already closed the channel: tell the
                        # producer to stop pushing into the void
                        spawn_task(self._send_credit(method, msg_id,
                                                     closed=True))
                    continue
                fut = self._pending.pop(msg_id, None)
                if fut is None or fut.done():
                    continue
                if kind == _ERR:
                    fut.set_exception(body if isinstance(body, BaseException)
                                      else RpcError(str(body)))
                else:
                    fut.set_result(body)
        # rt: lint-allow(except-discipline) cancel == connection teardown
        # here; the loop exits via finally, failing every pending future
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError,
                asyncio.CancelledError):
            pass
        finally:
            self._closed = True
            # push channels die with the connection: wake every consumer
            # with ChannelBroken so it can fall back to its pull path
            chans, self._channels = list(self._channels.values()), {}
            for ch in chans:
                ch._fail(f"connection to {self.address} lost")
            for fut in self._pending.values():
                try:
                    if not fut.done():
                        fut.set_exception(
                            ConnectionLost(f"connection to {self.address} lost"))
                        # Mark the exception retrieved: callers abandoned at
                        # teardown (e.g. a timed-out wait_for) never await this
                        # future, and asyncio would spam "Future exception was
                        # never retrieved" at GC. A live awaiter still sees the
                        # ConnectionLost raised from `await fut`.
                        fut.exception()
                except RuntimeError:
                    pass  # loop already closed during interpreter teardown
            self._pending.clear()

    async def call(self, method: str, payload: Any = None,
                   timeout: Optional[float] = None) -> Any:
        c = _chaos()
        # chaos rpc partition sites — a few methods are BELOW the
        # injection plane: 'hello' (dropping the handshake would leave a
        # connected-but-anonymous client whose server-side disconnect
        # tracking never engages, outlasting the partition) and the chaos
        # control loop itself ('heartbeat' carries the plan revision,
        # 'chaos_status' carries the plan, 'chaos_arm' is the worker
        # forward) — an armed plan must never block its own rollout,
        # update, or disarm; heartbeat partitions have their dedicated
        # raylet.heartbeat_drop site
        if c._STATE is not None and method not in (
                "hello", "heartbeat", "chaos_status", "chaos_arm"):
            f = c.maybe_fire("rpc.delay", target=method)
            if f is not None:
                await asyncio.sleep(float(f.get("delay_s", 0.05)))
            f = c.maybe_fire("rpc.drop", target=method)
            if f is not None:
                raise ConnectionLost(
                    f"chaos: dropped rpc {method!r} to {self.address}")
        if self._closed:
            if not self.auto_reconnect or self._explicitly_closed:
                raise ConnectionLost(f"connection to {self.address} closed")
            await self._reconnect()
        fut = asyncio.get_running_loop().create_future()
        async with self._lock:
            msg_id = self._next_id
            self._next_id += 1
            self._pending[msg_id] = fut
            _write_frame(self._writer, (_REQ, msg_id, method, payload))
            await self._writer.drain()
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    async def close(self) -> None:
        self._closed = True
        self._explicitly_closed = True
        if self._writer is not None:
            self._writer.close()
        await cancel_and_wait(getattr(self, "_read_task", None))


class EventLoopThread:
    """A dedicated background asyncio loop — the process's io_service
    (reference: ``instrumented_io_context``)."""

    def __init__(self, name: str = "rt-io"):
        self.loop = asyncio.new_event_loop()
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True, name=name)
        self._thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout: Optional[float] = None):
        """Run a coroutine on the loop from a sync thread; block for result.

        Fails FAST once the loop is stopped: run_coroutine_threadsafe on a
        no-longer-spinning loop returns a future that never resolves, and a
        caller blocked on it forever while holding a lock is a process-wide
        deadlock (stale serve pollers held _controller_lock this way)."""
        if self._stopped or self.loop.is_closed():
            coro.close()
            raise RuntimeError("event loop thread is stopped")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def spawn(self, coro) -> None:
        if self._stopped or self.loop.is_closed():
            coro.close()
            return
        # NOT run_coroutine_threadsafe: its task<->concurrent-future pair is
        # an unreferenced cycle once the caller drops the return value, and
        # the GC can then collect the task mid-flight (see spawn_task).
        self.loop.call_soon_threadsafe(spawn_task, coro)

    def stop(self) -> None:
        self._stopped = True  # run()/spawn() fail fast from here on

        # Cancel and drain outstanding tasks first so the loop doesn't warn
        # "Task was destroyed but it is pending!" at GC time.
        async def _drain():
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            asyncio.run_coroutine_threadsafe(_drain(), self.loop).result(2)
        except Exception:
            pass
        # Tasks that survived the bounded drain would pin _BG_TASKS forever
        # (their done-callback never fires once the loop stops).
        for t in [t for t in _BG_TASKS if t.get_loop() is self.loop]:
            _BG_TASKS.discard(t)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=2)
        if not self._thread.is_alive():
            try:
                self.loop.close()
            except Exception:
                pass


class ConnectionPool:
    """Address -> RpcClient cache (reference: core_worker_client pool)."""

    def __init__(self, peer_id: str = ""):
        self._peer_id = peer_id
        self._clients: Dict[str, RpcClient] = {}
        self._locks: Dict[str, asyncio.Lock] = {}

    async def get(self, address: str) -> RpcClient:
        client = self._clients.get(address)
        if client is not None and not client._closed:
            return client
        lock = self._locks.setdefault(address, asyncio.Lock())
        async with lock:
            client = self._clients.get(address)
            if client is not None and not client._closed:
                return client
            client = RpcClient(address, self._peer_id)
            await client.connect()
            self._clients[address] = client
            return client

    def invalidate(self, address: str) -> None:
        self._clients.pop(address, None)

    async def close_all(self) -> None:
        for c in self._clients.values():
            await c.close()
        self._clients.clear()
