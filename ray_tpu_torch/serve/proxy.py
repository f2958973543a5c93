"""HTTP proxy: the ingress that turns HTTP requests into handle calls.

Reference analog: ``serve/_private/http_proxy.py:935`` (``HTTPProxy`` on
uvicorn/ASGI). Here the proxy is one actor running an aiohttp server on the
worker's event loop. Routing: longest-matching ``route_prefix`` from the
controller's routing table (refreshed on a short TTL), then a
``DeploymentHandle`` call on the app's ingress deployment — so the proxy
shares the power-of-two replica routing and backpressure path with every
other caller.

The request crosses process boundaries, so the replica receives a picklable
``ServeRequest`` (method/path/headers/body), not an ASGI scope.
"""

from __future__ import annotations

import asyncio
import json as _json
import os
import time
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.serve import obs
from ray_tpu_torch.serve.asgi import ASGIResponse, ASGIResponseStart
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponseGenerator
from ray_tpu_torch.serve.replica import REJECTED as REJECTED_STATUS
from ray_tpu_torch.util import metrics

# aiohttp is the serve-ingress dependency; the module must stay importable
# without it (start() raises the actionable error), but the web/multidict
# lookups must not run per request
try:
    from aiohttp import WSMsgType, web
    from multidict import CIMultiDict
except ImportError:  # surfaced at start(); handlers never run without it
    WSMsgType = web = CIMultiDict = None

_ROUTE_TTL_S = 1.0


class ServeRequest:
    """Picklable HTTP request surface handed to ingress deployments.

    ``query``/``headers`` are convenience dicts (last value wins for
    repeats); ``raw_query`` and ``raw_headers`` preserve the wire form —
    repeated query params (``?tag=a&tag=b``) and duplicate headers — which
    the ASGI adapter needs to hand FastAPI/Starlette an unmodified scope.
    """

    def __init__(self, method: str, path: str, query: Dict[str, str],
                 headers: Dict[str, str], body: bytes,
                 raw_query: Optional[str] = None,
                 raw_headers: Optional[list] = None):
        self.method = method
        self.path = path  # path with the app's route_prefix stripped
        self.query = query
        self.headers = headers
        self.body = body
        self.raw_query = raw_query
        self.raw_headers = raw_headers  # [(name, value), ...] with repeats

    def json(self) -> Any:
        return _json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode()


def _to_response(result: Any):
    """Map a deployment's return value onto (status, content_type, bytes)."""
    status = 200
    if (isinstance(result, tuple) and len(result) == 2
            and isinstance(result[0], int)):
        status, result = result
    if result is None:
        return status if status != 200 else 204, "text/plain", b""
    if isinstance(result, bytes):
        return status, "application/octet-stream", result
    if isinstance(result, str):
        return status, "text/plain; charset=utf-8", result.encode()
    try:
        if isinstance(result, np.ndarray):
            result = result.tolist()
        payload = _json.dumps(result, default=_np_default).encode()
        return status, "application/json", payload
    except TypeError:
        return status, "text/plain; charset=utf-8", str(result).encode()


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


@ray_tpu_torch.remote
class ProxyActor:
    def __init__(self):
        self._routes: Dict[str, Tuple[str, str]] = {}
        self._routes_version = -1
        self._routes_fetched = 0.0
        self._handles: Dict[Tuple[str, str], Any] = {}
        self._runner = None
        self._site = None
        self._port: Optional[int] = None
        self._requests_served = 0
        self._proxy_id = "proxy-0"
        self._poller_started = False
        self._stopped = False
        # healthz honesty: a load balancer must see a proxy whose route
        # table went stale (controller unreachable) as unhealthy
        self._started_at = time.time()
        self._last_route_ok = 0.0   # last successful routing-table fetch
        self._poll_ok = True        # did the last fetch attempt succeed?
        self._route_stale_s = float(
            os.environ.get("RT_SERVE_ROUTE_STALE_S", "30"))

    async def start(self, host: str, port: int,
                    proxy_id: str = "proxy-0") -> int:
        self._proxy_id = proxy_id
        if web is None:
            raise ImportError("aiohttp is required for the serve HTTP "
                              "proxy (pip install aiohttp)")
        app = web.Application(client_max_size=64 * 1024 * 1024)
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        self._site = web.TCPSite(self._runner, host, port)
        await self._site.start()
        self._port = self._site._server.sockets[0].getsockname()[1]
        return self._port

    async def stop(self) -> None:
        self._stopped = True
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    def _controller(self):
        # rt: lint-allow(hot-path) import-cycle break (serve.api imports
        # this module); resolved once then cached on self
        from ray_tpu_torch.serve.api import _get_controller

        return _get_controller()

    async def _refresh_routes(self) -> None:
        # long-poll push (reference: LongPollClient in the proxy): one
        # blocked executor thread tracks the table; requests read the cache
        if not self._poller_started:
            self._poller_started = True
            loop = asyncio.get_running_loop()
            loop.run_in_executor(None, self._route_poll_loop)
        if self._routes_fetched == 0.0:
            # first request: fetch synchronously so routing is never empty
            loop = asyncio.get_running_loop()
            table = await loop.run_in_executor(
                None, self._fetch_routes_blocking, False)
            self._apply_routes(table)

    def _apply_routes(self, table: Dict[str, Any]) -> None:
        self._routes = table["routes"]
        self._routes_version = table["version"]
        self._routes_fetched = time.time()
        self._last_route_ok = self._routes_fetched
        self._poll_ok = True

    def _route_poll_loop(self) -> None:
        while not self._stopped:
            try:
                self._apply_routes(self._fetch_routes_blocking(True))
            except Exception:
                self._poll_ok = False
                time.sleep(1.0)

    def _fetch_routes_blocking(self, wait: bool) -> Dict[str, Any]:
        return ray_tpu_torch.get(self._controller().get_routing_table.remote(
            self._routes_version if wait else -1, wait, 10.0))

    def _match(self, path: str) -> Optional[Tuple[str, str, str, str]]:
        """Longest-prefix route match ->
        (app, ingress, stripped_path, route_prefix)."""
        best = None
        for prefix, (app, ingress) in self._routes.items():
            norm = prefix.rstrip("/") or ""
            if path == norm or path.startswith(norm + "/") or norm == "":
                if best is None or len(norm) > len(best[0]):
                    best = (norm, app, ingress)
        if best is None:
            return None
        stripped = path[len(best[0]):] or "/"
        return best[1], best[2], stripped, best[0] or "/"

    async def _healthz(self, request):
        """Honest health: include route-table age and controller
        reachability; 503 past the staleness threshold so a load balancer
        drains a proxy whose controller went away. ``?verbose=1`` returns
        the JSON body on 200 too; ``?stale_after=`` overrides the
        threshold (tests / per-LB tuning)."""
        # probe on demand: an idle proxy must not go stale merely because
        # no request has started the poller yet
        if self._last_route_ok == 0.0:
            try:
                await self._refresh_routes()
            except Exception:  # noqa: BLE001 — controller unreachable
                self._poll_ok = False
        now = time.time()
        age = now - (self._last_route_ok or self._started_at)
        try:
            stale_after = float(request.rel_url.query.get(
                "stale_after", self._route_stale_s))
        except (TypeError, ValueError):
            stale_after = self._route_stale_s
        degraded = age > stale_after
        payload = {"status": "degraded" if degraded else "ok",
                   "route_table_age_s": round(age, 3),
                   "stale_after_s": stale_after,
                   "controller_reachable": self._poll_ok,
                   "routes_version": self._routes_version}
        if degraded:
            return web.json_response(payload, status=503)
        if request.rel_url.query.get("verbose"):
            return web.json_response(payload)
        return web.Response(text="ok")

    def _observe_request(self, app: str, deployment: str, route: str,
                         code: int, seconds: float) -> None:
        obs.request_seconds().observe(seconds, tags={
            "app": app, "deployment": deployment, "route": route,
            "code": str(code)})
        obs.requests_total().inc(tags={"app": app, "code": str(code)})
        # per-process spread check for multi-proxy front doors
        obs.proxy_requests_total().inc(tags={"proxy": self._proxy_id})
        if code >= 500:
            obs.errors_total().inc(tags={
                "app": app, "deployment": deployment, "kind": "http_5xx"})

    async def _handle(self, request):
        path = "/" + request.match_info["tail"]
        if path == "/-/healthz":
            return await self._healthz(request)
        if path == "/-/routes":
            await self._refresh_routes()
            return web.json_response(
                {p: f"{a}:{i}" for p, (a, i) in self._routes.items()})
        t_epoch, t0 = time.time(), time.perf_counter()
        # ingress: mint (or adopt a well-formed upstream's) request id — it
        # is the TRACE id every downstream hop joins
        upstream_rid = request.headers.get(obs.REQUEST_ID_HEADER, "")
        request_id = (upstream_rid if obs.valid_request_id(upstream_rid)
                      else obs.mint_request_id())
        rid_hdr = {obs.REQUEST_ID_HEADER: request_id}
        await self._refresh_routes()
        m = self._match(path)
        if m is None:
            self._observe_request("", "", "_unmatched", 404,
                                  time.perf_counter() - t0)
            return web.Response(status=404, text=f"no app at {path}",
                                headers=rid_hdr)
        app_name, ingress, stripped, route = m
        key = (app_name, ingress)
        handle = self._handles.get(key)
        if handle is None:
            handle = DeploymentHandle(app_name, ingress)
            self._handles[key] = handle
        req_ctx = {"request_id": request_id, "app": app_name,
                   "deployment": ingress, "route": route,
                   "span_id": obs.new_span_id()}
        if (request.headers.get("Upgrade", "").lower() == "websocket"
                and request.method == "GET"):
            # websockets are ingress traffic too: count the connection and
            # give the trace its root span (101 = a completed WS session;
            # error paths return plain responses with their own codes)
            try:
                resp = await self._handle_websocket(request, handle,
                                                    stripped, req_ctx)
                ws_code = getattr(resp, "status", 200)
            except Exception:
                ws_code = 500
                raise
            finally:
                t_end = time.perf_counter()
                self._observe_request(app_name, ingress, route, ws_code,
                                      t_end - t0)
                obs.emit_span(
                    f"serve:{request_id}:p:{req_ctx['span_id'][:8]}",
                    f"proxy:WS {route}",
                    request_id=request_id, span_id=req_ctx["span_id"],
                    parent_span_id=None, t_start=t_epoch,
                    t_end=t_epoch + (t_end - t0),
                    phases={"stream": t_end - t0})
            try:
                resp.headers.setdefault(obs.REQUEST_ID_HEADER, request_id)
            except Exception:  # noqa: BLE001 — headers already sent
                pass
            return resp
        sreq = ServeRequest(
            method=request.method, path=stripped,
            query=dict(request.rel_url.query),
            headers=dict(request.headers), body=await request.read(),
            raw_query=request.rel_url.raw_query_string,
            raw_headers=[(k, v) for k, v in request.headers.items()])
        t_route = time.perf_counter()

        def finish(code: int, t_handle: float,
                   extra_phases: Optional[Dict[str, float]] = None) -> None:
            t_end = time.perf_counter()
            phases = {"proxy_route": t_route - t0,
                      "handle": t_handle - t_route}
            phases.update(extra_phases or
                          {"respond": t_end - t_handle})
            self._observe_request(app_name, ingress, route, code,
                                  t_end - t0)
            obs.emit_span(
                # unique store key per ATTEMPT: a client retrying with the
                # same adopted request id must not clobber the first
                # attempt's proxy span (rt trace joins on trace_id)
                f"serve:{request_id}:p:{req_ctx['span_id'][:8]}",
                f"proxy:{request.method} {route}",
                request_id=request_id, span_id=req_ctx["span_id"],
                parent_span_id=None, t_start=t_epoch,
                t_end=t_epoch + (t_end - t0), phases=phases)

        # activate while SUBMITTING: handle.remote captures the ambient
        # request context synchronously; the await happens outside it
        token = obs.activate_request(req_ctx)
        try:
            pending = handle.remote(sreq)
        finally:
            obs.deactivate_request(token)
        try:
            result = await pending
        except TimeoutError as e:
            finish(503, time.perf_counter())
            return web.Response(status=503, text=f"overloaded: {e}",
                                headers=rid_hdr)
        except Exception as e:  # noqa: BLE001 — user code raised
            finish(500, time.perf_counter())
            return web.Response(status=500, text=f"{type(e).__name__}: {e}",
                                headers=rid_hdr)
        t_handle = time.perf_counter()
        self._requests_served += 1
        if isinstance(result, DeploymentResponseGenerator):
            return await self._stream_response(
                request, result, req_ctx=req_ctx, t0=t0,
                t_handle=t_handle, finish=finish)
        if isinstance(result, ASGIResponse):
            # ASGI deployments control the full response surface; a
            # multidict preserves duplicate headers (Set-Cookie x2)
            headers = CIMultiDict(result.headers)
            headers.setdefault(obs.REQUEST_ID_HEADER, request_id)
            finish(result.status, t_handle)
            return web.Response(status=result.status, headers=headers,
                                body=result.body)
        status, ctype, payload = _to_response(result)
        finish(status, t_handle)
        return web.Response(status=status, content_type=ctype.split(";")[0],
                            body=payload, headers=rid_hdr)

    async def _handle_websocket(self, request, handle, stripped: str,
                                req_ctx: Optional[Dict[str, str]] = None):
        """Bridge an aiohttp websocket to an ASGI deployment (reference:
        the uvicorn proxy's native WS path, ``serve/_private/http_proxy.py``).

        Outbound: one streaming actor call (``__ws_connect__``) yields
        accept/text/bytes/close events. Inbound: each client frame is an
        ordered ``__ws_push__`` call PINNED to the same replica (the
        generator's actor), so the per-caller actor FIFO preserves frame
        order. The 101 handshake is deferred until the app accepts; a
        close-before-accept surfaces as HTTP 403 (ASGI denial semantics)."""
        conn_id = uuid.uuid4().hex
        sreq = ServeRequest(
            method="GET", path=stripped,
            query=dict(request.rel_url.query),
            headers=dict(request.headers), body=b"",
            raw_query=request.rel_url.raw_query_string,
            raw_headers=[(k, v) for k, v in request.headers.items()])
        token = obs.activate_request(req_ctx)
        try:
            pending = handle.options(
                method_name="__ws_connect__").remote(sreq, conn_id)
        finally:
            obs.deactivate_request(token)
        try:
            gen = await pending
        except TimeoutError as e:
            return web.Response(status=503, text=f"overloaded: {e}")
        except Exception as e:  # noqa: BLE001
            return web.Response(status=500,
                                text=f"{type(e).__name__}: {e}")
        if not isinstance(gen, DeploymentResponseGenerator):
            return web.Response(
                status=426, text="deployment is not websocket-capable "
                                 "(no ASGI app bound)")
        actor = gen._actor
        it = gen.__aiter__()
        loop = asyncio.get_running_loop()

        async def push(kind: str, data=None, code: int = 1005) -> None:
            # ordered, awaited pushes: per-caller FIFO on the pinned
            # replica keeps frame order. __ws_push__ bypasses admission
            # control on the replica (the connection's stream holds the
            # slot); a REJECTED here is therefore unexpected — fail loudly
            # rather than silently dropping a frame
            ref = actor.handle_request.remote(
                "__ws_push__", (conn_id, kind, data, code), {}, None)
            reply = await loop.run_in_executor(None, ray_tpu_torch.get, ref)
            if reply[0] == REJECTED_STATUS:
                raise RuntimeError("websocket frame rejected by replica")

        try:
            first = await it.__anext__()
        except (StopAsyncIteration, Exception) as e:  # noqa: B014
            gen.cancel()
            return web.Response(status=500,
                                text=f"websocket app failed: {e}")
        if first.get("kind") == "close":
            gen.cancel()
            if first.get("code") == 1011:
                # app CRASHED before accepting (asgi.py translates app
                # errors to a 1011 close) — that's a server error, not an
                # auth-style denial
                return web.Response(
                    status=500,
                    text=f"websocket app failed: {first.get('reason', '')}")
            return web.Response(status=403, text="websocket rejected")
        ws = web.WebSocketResponse(
            protocols=[first["subprotocol"]] if first.get("subprotocol")
            else ())
        await ws.prepare(request)
        self._requests_served += 1

        async def inbound():
            try:
                async for msg in ws:
                    if msg.type == WSMsgType.TEXT:
                        await push("text", msg.data)
                    elif msg.type == WSMsgType.BINARY:
                        await push("bytes", msg.data)
                    elif msg.type == WSMsgType.ERROR:
                        break
            finally:
                await push("disconnect",
                           code=ws.close_code or 1005)

        in_task = asyncio.ensure_future(inbound())
        try:
            async for ev in it:
                kind = ev.get("kind")
                if kind == "text":
                    await ws.send_str(ev["data"])
                elif kind == "bytes":
                    await ws.send_bytes(ev["data"])
                elif kind == "close":
                    await ws.close(code=ev.get("code", 1000),
                                   message=ev.get("reason", "").encode())
                    break
        except Exception:  # noqa: BLE001 — replica died mid-connection
            pass
        finally:
            gen.cancel()
            if not ws.closed:
                await ws.close(code=1011)
            in_task.cancel()
            try:
                await in_task
            except (asyncio.CancelledError, Exception):  # noqa: B014
                pass
        return ws

    async def _stream_response(self, request, gen, req_ctx=None, t0=None,
                               t_handle=None, finish=None):
        """Chunked transfer of a streaming deployment response (reference:
        ``serve/_private/replica.py:346`` streamed ASGI messages). str/bytes
        chunks pass through; other values are JSON-encoded, one per line.
        An ASGI deployment's stream leads with ``ASGIResponseStart``, which
        sets the response status/headers before the first body byte.

        Token-streaming telemetry (the series continuous batching and
        spec-decode are judged against): TTFT is request receipt to the
        first body chunk, every inter-chunk gap lands in the TPOT
        histogram, and chunks count into ``rt_serve_tokens_total``."""
        tok_tags = ({"app": req_ctx["app"],
                     "deployment": req_ctx["deployment"]}
                    if req_ctx else None)
        it = gen.__aiter__()
        status = 200
        headers = CIMultiDict({"Content-Type": "application/octet-stream"})
        if req_ctx:
            headers.setdefault(obs.REQUEST_ID_HEADER, req_ctx["request_id"])
        _NO_CHUNK = object()  # a literal None chunk is a valid stream item
        pending_first = _NO_CHUNK
        try:
            first = await it.__anext__()
            if isinstance(first, ASGIResponseStart):
                status, headers = first.status, CIMultiDict(first.headers)
                if req_ctx:
                    headers.setdefault(obs.REQUEST_ID_HEADER,
                                       req_ctx["request_id"])
            else:
                pending_first = first
        except StopAsyncIteration:
            pass
        except Exception:  # noqa: BLE001 — failed before first chunk
            gen.cancel()
            if finish is not None:
                finish(500, time.perf_counter())
            return web.Response(status=500, text="stream failed")
        resp = web.StreamResponse(status=status, headers=headers)
        try:
            await resp.prepare(request)
        except Exception:
            # client gone before the first byte: release the replica
            # stream and the router's in-flight slot, and account the
            # aborted request (499: client closed) before propagating
            gen.cancel()
            if finish is not None:
                finish(499, time.perf_counter())
            raise

        def encode(chunk):
            if isinstance(chunk, str):
                return chunk.encode()
            if not isinstance(chunk, (bytes, bytearray)):
                return _json.dumps(chunk, default=_np_default).encode() + b"\n"
            return chunk

        n_chunks = 0
        t_prev: Optional[float] = None

        def note_chunk() -> None:
            nonlocal n_chunks, t_prev
            now = time.perf_counter()
            if tok_tags is not None:
                if n_chunks == 0 and t0 is not None:
                    obs.ttft_seconds().observe(now - t0, tags=tok_tags)
                elif t_prev is not None:
                    obs.inter_token_seconds().observe(now - t_prev,
                                                      tags=tok_tags)
                obs.tokens_total().inc(tags=tok_tags)
            n_chunks += 1
            t_prev = now

        drain = getattr(it, "drain_buffered", None)
        try:
            if pending_first is not _NO_CHUNK:
                await resp.write(encode(pending_first))
                note_chunk()
            async for chunk in it:
                payload = encode(chunk)
                note_chunk()
                if drain is not None:
                    # write coalescing: a continuous-batching engine
                    # emits token BURSTS (one per fused decode tick) —
                    # ship what is already buffered in ONE write instead
                    # of a chunked-transfer frame + syscall per token
                    for extra in drain():
                        payload += encode(extra)
                        note_chunk()
                await resp.write(payload)
        except Exception:  # noqa: BLE001 — mid-stream failure: cut the body
            gen.cancel()
        finally:
            try:
                await resp.write_eof()
            except Exception:  # noqa: BLE001 — client gone mid-stream;
                pass           # the aborted stream still gets accounted
            if finish is not None:
                t_end = time.perf_counter()
                finish(status, t_handle if t_handle is not None else t_end,
                       {"stream": t_end - (t_handle or t_end)})
        return resp

    def flush_metrics(self) -> None:
        """Push this proxy's metric registry + buffered serve spans now
        (tests/ops — the background pushers run on an interval)."""
        obs.flush_spans()
        metrics.flush_now()

    def stats(self) -> Dict[str, Any]:
        return {"port": self._port, "proxy_id": self._proxy_id,
                "requests_served": self._requests_served,
                "route_table_age_s": time.time() - (self._last_route_ok
                                                    or self._started_at),
                "controller_reachable": self._poll_ok}
