"""ASGI adapter: deploy any ASGI3 app (FastAPI, Starlette, Quart, raw
callables) as a serve deployment, unchanged.

Reference analog: ``serve/_private/http_proxy.py:935`` (``HTTPProxy`` speaks
ASGI natively on uvicorn, and ``@serve.ingress(fastapi_app)`` mounts an app
on a deployment class). This framework's proxy hands replicas a picklable
``ServeRequest`` instead of a live ASGI connection, so the adapter runs the
ASGI protocol *inside the replica*: scope/receive/send are synthesized from
the request, and the app's send events are translated back into either a
buffered :class:`ASGIResponse` or a streamed response (first item an
:class:`ASGIResponseStart`, then body chunks) riding the existing response
stream machinery.

Two ways in:

- ``serve.asgi_app(app_or_factory)`` — wraps a bare ASGI app (or a
  zero-arg factory, for apps that aren't picklable) into a deployment body.
- ``@serve.ingress(app)`` on a deployment class — the class keeps its own
  ``__init__``/methods; HTTP traffic is routed through the app. The app can
  reach the live deployment instance as ``scope["extensions"]
  ["ray_tpu.deployment"]`` (JAX's key, kept so an app runs on both; FastAPI: ``request.scope[...]``) — a redesign
  of the reference's class-based-view binding, which rewrites FastAPI
  dependencies; here the instance is surfaced through the scope instead.

Lifespan: ``lifespan.startup`` runs once before the first request in the
replica; ``lifespan.shutdown`` is best-effort (replica teardown is process
teardown).

WebSockets: the proxy bridges an accepted websocket to the replica
over two legs (reference: the uvicorn proxy speaks WS natively,
``serve/_private/http_proxy.py``): outbound app frames ride a streaming
actor call (``__ws_connect__`` yields accept/text/bytes/close events);
inbound client frames are pushed with per-connection-ordered
``__ws_push__`` calls onto the SAME replica. The ASGI websocket protocol
(connect/receive/disconnect in, accept/send/close out) runs inside the
replica, like the HTTP path.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["ASGIResponse", "ASGIResponseStart", "asgi_app", "ingress"]


class ASGIResponse:
    """Picklable buffered HTTP response produced by the ASGI adapter; the
    proxy maps it 1:1 onto the wire (status/headers/body)."""

    def __init__(self, status: int, headers: List[Tuple[str, str]],
                 body: bytes):
        self.status = status
        self.headers = headers
        self.body = body


class ASGIResponseStart:
    """First item of a streamed ASGI response: status + headers; the
    remaining stream items are body chunks."""

    def __init__(self, status: int, headers: List[Tuple[str, str]]):
        self.status = status
        self.headers = headers


def _build_scope(request, instance,
                 scope_type: str = "http") -> Dict[str, Any]:
    """ServeRequest -> ASGI HTTP/websocket scope. The path is the route-
    prefix-stripped path the proxy computed, so an app mounted at /api
    sees /."""
    from urllib.parse import urlencode

    # raw forms preserve repeated params/headers (?tag=a&tag=b, duplicate
    # Set-Cookie) that the convenience dicts collapse
    raw_headers = getattr(request, "raw_headers", None)
    header_items = raw_headers if raw_headers is not None \
        else (request.headers or {}).items()
    headers = [(k.lower().encode(), v.encode()) for k, v in header_items]
    raw_query = getattr(request, "raw_query", None)
    query_string = raw_query.encode() if raw_query is not None \
        else urlencode(request.query or {}).encode()
    scope = {
        "type": scope_type,
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "scheme": "http" if scope_type == "http" else "ws",
        "path": request.path,
        "raw_path": request.path.encode(),
        "query_string": query_string,
        "root_path": "",
        "headers": headers,
        "client": ("127.0.0.1", 0),
        "server": ("127.0.0.1", 0),
        "extensions": {"ray_tpu.deployment": instance},
    }
    if scope_type == "http":
        scope["method"] = request.method
    else:
        protos = (request.headers or {}).get("Sec-WebSocket-Protocol", "")
        scope["subprotocols"] = [p.strip() for p in protos.split(",")
                                 if p.strip()]
    return scope


async def _run_lifespan_startup(app) -> None:
    """Drive lifespan.startup once. Apps that don't implement lifespan
    (raise on the unknown scope type) are fine — ASGI allows that."""
    startup_done = asyncio.Event()
    failed: List[str] = []
    delivered = False

    async def receive():
        # startup exactly once; then park — the standard lifespan loop
        # calls receive() again waiting for lifespan.shutdown, which never
        # comes (replica teardown is process teardown)
        nonlocal delivered
        if not delivered:
            delivered = True
            return {"type": "lifespan.startup"}
        await asyncio.Event().wait()

    async def send(message):
        if message["type"] == "lifespan.startup.complete":
            startup_done.set()
        elif message["type"] == "lifespan.startup.failed":
            failed.append(message.get("message", ""))
            startup_done.set()

    async def run():
        try:
            await app({"type": "lifespan", "asgi": {"version": "3.0"}},
                      receive, send)
        except BaseException:  # noqa: BLE001 — app opted out of lifespan
            pass
        finally:
            # apps may RETURN from the lifespan scope without sending
            # startup.complete (e.g. `if scope["type"] != "http": return`)
            # — that must not park the first request forever
            startup_done.set()

    task = asyncio.ensure_future(run())
    await startup_done.wait()
    # keep the lifespan task alive for apps that hold state in it; replica
    # teardown is process teardown, so shutdown is implicit
    _lifespan_tasks.append(task)
    if failed:
        raise RuntimeError(f"ASGI lifespan startup failed: {failed[0]}")


_lifespan_tasks: List[asyncio.Task] = []


async def _call_asgi(app, request, instance):
    """Run one HTTP request through the app.

    Returns an :class:`ASGIResponse` when the app finished the body in its
    first write, else an async generator (``ASGIResponseStart`` then body
    chunks) so chunked/SSE/token streams flow incrementally through the
    replica's response-stream machinery.
    """
    scope = _build_scope(request, instance)
    body = request.body or b""
    sent_body = False
    events: asyncio.Queue = asyncio.Queue()
    # Set once the response has been fully delivered; a later receive()
    # then reports http.disconnect so apps polling is_disconnected() (SSE,
    # long-poll) unwind instead of parking their task forever.
    response_complete = asyncio.Event()

    async def receive():
        nonlocal sent_body
        if not sent_body:
            sent_body = True
            return {"type": "http.request", "body": body,
                    "more_body": False}
        await response_complete.wait()
        return {"type": "http.disconnect"}

    async def send(message):
        await events.put(message)

    app_task = asyncio.ensure_future(app(scope, receive, send))
    # retrieve the exception of an app that fails AFTER its response was
    # returned — an unobserved task exception warns at GC otherwise
    app_task.add_done_callback(
        lambda t: t.cancelled() or t.exception())

    async def next_event():
        # drain queued events before consulting the app task: the app may
        # have finished AFTER putting its final body messages
        if not events.empty():
            return events.get_nowait()
        if app_task.done():
            exc = app_task.exception()
            if exc is not None:
                raise exc
            return None  # app returned without completing the response
        getter = asyncio.ensure_future(events.get())
        await asyncio.wait({getter, app_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if getter.done():
            return getter.result()
        getter.cancel()
        if not events.empty():
            return events.get_nowait()
        exc = app_task.exception()
        if exc is not None:
            raise exc
        return None

    try:
        start: Optional[Dict] = None
        while start is None:
            msg = await next_event()
            if msg is None:
                raise RuntimeError("ASGI app returned before response.start")
            if msg["type"] == "http.response.start":
                start = msg
        status = start["status"]
        headers = [(k.decode(), v.decode())
                   for k, v in start.get("headers", [])]

        first = await next_event()
        if first is None or first["type"] != "http.response.body":
            response_complete.set()
            return ASGIResponse(status, headers, b"")
        if not first.get("more_body"):
            if app_task.done() and app_task.exception():
                raise app_task.exception()
            response_complete.set()
            return ASGIResponse(status, headers,
                                bytes(first.get("body", b"")))
    except BaseException:
        response_complete.set()
        app_task.cancel()
        raise

    async def stream():
        try:
            yield ASGIResponseStart(status, headers)
            if first.get("body"):
                yield bytes(first["body"])
            while True:
                msg = await next_event()
                if msg is None:
                    return
                if msg["type"] != "http.response.body":
                    continue
                if msg.get("body"):
                    yield bytes(msg["body"])
                if not msg.get("more_body"):
                    return
        finally:
            # normal end, consumer cancel (GeneratorExit), or app error:
            # unblock the app's next receive() so its task exits
            response_complete.set()

    return stream()


# Per-connection inbound queues for websocket bridging; keyed by the
# proxy-generated connection id. Lives at module level: __ws_push__ actor
# calls and the __ws_connect__ stream land on the same replica process.
_WS_INBOX: Dict[str, asyncio.Queue] = {}


async def _run_ws_asgi(app, request, conn_id: str, instance):
    """Drive one websocket connection through the app; an async generator
    of outbound events for the proxy:

      {"kind": "accept", "subprotocol": ..., "headers": [...]}
      {"kind": "text", "data": str} / {"kind": "bytes", "data": bytes}
      {"kind": "close", "code": int, "reason": str}   (always last)

    Inbound client frames arrive via ``_WS_INBOX[conn_id]`` (pushed by
    ``__ws_push__``) and surface to the app as websocket.receive /
    websocket.disconnect messages."""
    scope = _build_scope(request, instance, scope_type="websocket")
    inbox: asyncio.Queue = asyncio.Queue()
    _WS_INBOX[conn_id] = inbox
    events: asyncio.Queue = asyncio.Queue()
    delivered_connect = False

    async def receive():
        nonlocal delivered_connect
        if not delivered_connect:
            delivered_connect = True
            return {"type": "websocket.connect"}
        msg = await inbox.get()
        kind = msg["kind"]
        if kind == "text":
            return {"type": "websocket.receive", "text": msg["data"]}
        if kind == "bytes":
            return {"type": "websocket.receive", "bytes": msg["data"]}
        return {"type": "websocket.disconnect",
                "code": msg.get("code", 1005)}

    async def send(message):
        await events.put(message)

    app_task = asyncio.ensure_future(app(scope, receive, send))
    app_task.add_done_callback(lambda t: t.cancelled() or t.exception())

    async def next_event():
        if not events.empty():
            return events.get_nowait()
        if app_task.done():
            exc = app_task.exception()
            if exc is not None:
                raise exc
            return None
        getter = asyncio.ensure_future(events.get())
        await asyncio.wait({getter, app_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if getter.done():
            return getter.result()
        getter.cancel()
        if not events.empty():
            return events.get_nowait()
        exc = app_task.exception()
        if exc is not None:
            raise exc
        return None

    try:
        while True:
            msg = await next_event()
            if msg is None:
                # app returned without an explicit close
                yield {"kind": "close", "code": 1000, "reason": ""}
                return
            t = msg["type"]
            if t == "websocket.accept":
                yield {"kind": "accept",
                       "subprotocol": msg.get("subprotocol"),
                       "headers": [(k.decode(), v.decode()) for k, v in
                                   msg.get("headers", [])]}
            elif t == "websocket.send":
                if msg.get("text") is not None:
                    yield {"kind": "text", "data": msg["text"]}
                else:
                    yield {"kind": "bytes",
                           "data": bytes(msg.get("bytes", b""))}
            elif t == "websocket.close":
                yield {"kind": "close", "code": msg.get("code", 1000),
                       "reason": msg.get("reason", "")}
                return
    except (asyncio.CancelledError, GeneratorExit):
        # consumer torn down mid-stream: yielding a close frame from here
        # would raise "async generator ignored GeneratorExit" — cleanup
        # happens in finally, cancellation stays cancellation
        raise
    except BaseException as e:  # noqa: BLE001 — app error -> 1011 close
        yield {"kind": "close", "code": 1011, "reason": str(e)[:120]}
        return
    finally:
        _WS_INBOX.pop(conn_id, None)
        if not app_task.done():
            # unblock a receive()-parked app so its task can unwind
            inbox.put_nowait({"kind": "disconnect", "code": 1001})
            await asyncio.sleep(0)
            app_task.cancel()


class _ASGIAdapter:
    """Mixin driving requests through ``self._asgi_app``."""

    _asgi_app = None
    _asgi_startup: Optional[asyncio.Future] = None

    def _resolve_asgi_app(self):
        app = self._asgi_app
        if app is None:
            raise RuntimeError("no ASGI app bound")
        return app

    async def _ensure_startup(self):
        app = self._resolve_asgi_app()
        # one shared startup task: concurrent first requests all await the
        # SAME lifespan completion (not run the app pre-startup), and a
        # failed startup re-raises for every subsequent request
        if self._asgi_startup is None:
            self._asgi_startup = asyncio.ensure_future(
                _run_lifespan_startup(app))
        await asyncio.shield(self._asgi_startup)
        return app

    async def __call__(self, request):
        app = await self._ensure_startup()
        return await _call_asgi(app, request, self)

    async def __ws_connect__(self, request, conn_id: str):
        """Streaming entry for one websocket connection (called by the
        proxy); yields outbound events."""
        app = await self._ensure_startup()
        async for ev in _run_ws_asgi(app, request, conn_id, self):
            yield ev

    async def __ws_push__(self, conn_id: str, kind: str, data=None,
                          code: int = 1005) -> bool:
        """Inbound client frame (or disconnect) for a live connection.
        Returns False when the connection is already gone."""
        q = _WS_INBOX.get(conn_id)
        if q is None:
            return False
        q.put_nowait({"kind": kind, "data": data, "code": code})
        return True


def asgi_app(app_or_factory: Any) -> type:
    """Wrap an ASGI3 app — or a zero-arg factory returning one, for apps
    that don't cloudpickle — into a deployment body class.

    >>> serve.run(serve.deployment(serve.asgi_app(fastapi_app)))
    """

    class ASGIDeployment(_ASGIAdapter):
        def __init__(self):
            app = app_or_factory
            # a factory is a callable that is NOT itself an ASGI app; ASGI
            # apps take 3 args (scope, receive, send)
            if callable(app) and not _looks_like_asgi(app):
                app = app()
            self._asgi_app = app

    ASGIDeployment.__name__ = getattr(
        app_or_factory, "__name__", type(app_or_factory).__name__)
    return ASGIDeployment


def ingress(app: Any) -> Callable[[type], type]:
    """Class decorator mounting an ASGI app on a deployment class
    (reference: ``serve.ingress(fastapi_app)``). The class's ``__init__``
    and methods are untouched; HTTP requests route through ``app``, which
    can reach the instance via ``scope["extensions"]["ray_tpu.deployment"]``.
    """

    def wrap(cls: type) -> type:
        ns = {"_asgi_app_static": app}

        class Ingress(cls, _ASGIAdapter):  # type: ignore[misc, valid-type]
            def _resolve_asgi_app(self):
                return ns["_asgi_app_static"]

            async def __call__(self, request):
                return await _ASGIAdapter.__call__(self, request)

        Ingress.__name__ = cls.__name__
        Ingress.__qualname__ = cls.__qualname__
        return Ingress

    return wrap


def _looks_like_asgi(obj: Any) -> bool:
    """ASGI apps are callables taking (scope, receive, send); factories
    take zero args. Class instances (FastAPI, Starlette) are ASGI."""
    import inspect

    if not inspect.isfunction(obj) and not inspect.ismethod(obj):
        return True  # app objects (FastAPI etc.) — callable instances
    try:
        params = [
            p for p in inspect.signature(obj).parameters.values()
            if p.default is p.empty
            and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ]
        return len(params) >= 3
    except (TypeError, ValueError):
        return True
