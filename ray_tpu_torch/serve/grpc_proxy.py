"""gRPC ingress: method-routed handle calls over a generic gRPC service.

Reference analog: ``serve/_private/http_proxy.py:636`` (``gRPCProxy``
subclassing ``GenericProxy``) + ``serve/_private/grpc_util.py``. Redesign
without protoc codegen: one ``grpc.aio`` server with a generic RPC handler
accepting any unary method of the form ``/rt.serve/<app>`` (or
``/rt.serve/<app>.<method>``); request bytes are a cloudpickled
``(args, kwargs)`` pair, response bytes the cloudpickled return value —
the same picklable surface handle calls use internally. Clients use
``grpc_request()`` below or any gRPC stack speaking the same frames.
"""

from __future__ import annotations

import time
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any, Dict, Optional, Tuple

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve import obs

SERVICE = "rt.serve"


def _parse_method(full_name: str) -> Optional[Tuple[str, str]]:
    # "/rt.serve/<app>" or "/rt.serve/<app>.<method>"
    parts = full_name.strip("/").split("/")
    if len(parts) != 2 or parts[0] != SERVICE:
        return None
    app, _, method = parts[1].partition(".")
    return app, method or "__call__"


@ray_tpu_torch.remote
class GrpcProxyActor:
    """One gRPC ingress actor (reference: the gRPC proxy actor per node)."""

    def __init__(self, host: str, port: int):
        self._host = host
        self._port = port
        self._handles: Dict[Tuple[str, str], Any] = {}
        self._server = None
        self._started = False

    async def ready(self) -> int:
        if self._started:
            return self._port
        import grpc

        proxy = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                target = _parse_method(handler_call_details.method)
                if target is None:
                    return None

                async def unary(request_bytes, context):
                    return await proxy._call(target, request_bytes, context)

                return grpc.unary_unary_rpc_method_handler(
                    unary,
                    request_deserializer=None,   # raw bytes in
                    response_serializer=None)    # raw bytes out

        # Trust boundary: requests are cloudpickle payloads, and unpickling
        # executes arbitrary code by construction — the ingress must only be
        # reachable by trusted clients. The default loopback bind enforces
        # that; binding wider is the operator widening the boundary.
        if self._host not in ("127.0.0.1", "localhost", "::1"):
            import logging

            logging.getLogger("ray_tpu_torch.serve").warning(
                "serve gRPC ingress binding to %s: requests are pickle-"
                "deserialized, so ANY client that can reach this port can "
                "execute code in the proxy. Only bind beyond loopback on a "
                "trusted network.", self._host)
        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((_Generic(),))
        self._port = self._server.add_insecure_port(
            f"{self._host}:{self._port}")
        await self._server.start()
        self._started = True
        return self._port

    async def _call(self, target: Tuple[str, str], request_bytes: bytes,
                    context) -> bytes:
        # The handle/controller APIs are SYNC (they block on io.run); calling
        # them from this worker's own event loop would deadlock it — run the
        # whole request on an executor thread.
        import asyncio

        import grpc

        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(
                None, self._call_sync, target, request_bytes)
        except LookupError as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except Exception as e:  # noqa: BLE001 — surface as gRPC error
            await context.abort(grpc.StatusCode.INTERNAL, repr(e))

    def _resolve_handle(self, target: Tuple[str, str]):
        from ray_tpu_torch.serve.api import _get_controller
        from ray_tpu_torch.serve.handle import DeploymentHandle

        app, method = target
        try:
            ingress = ray_tpu_torch.get(
                _get_controller().get_ingress.remote(app), timeout=15)
        except Exception:  # noqa: BLE001
            ingress = None
        if ingress is None:
            raise LookupError(f"no serve application {app!r}")
        handle = DeploymentHandle(app, ingress, method_name=method)
        self._handles[target] = handle
        return handle

    def _call_sync(self, target: Tuple[str, str],
                   request_bytes: bytes) -> bytes:
        from ray_tpu_torch.exceptions import ActorError

        handle = self._handles.get(target) or self._resolve_handle(target)
        args, kwargs = cloudpickle.loads(request_bytes) \
            if request_bytes else ((), {})
        # gRPC is an ingress too: mint the request id / trace root here so
        # `rt trace <request_id>` covers gRPC-originated requests as well
        app, method = target
        route = f"/{SERVICE}/{app}"
        req_ctx = {"request_id": obs.mint_request_id(), "app": app,
                   "deployment": handle.deployment_name, "route": route,
                   "span_id": obs.new_span_id()}
        t_epoch, t0 = time.time(), time.perf_counter()
        code = "OK"
        token = obs.activate_request(req_ctx)
        try:
            try:
                result = handle.remote(*args, **kwargs).result(timeout=120)
            except ActorError:
                # Dead/redeployed ingress ONLY: re-resolve and retry once.
                # Neither app exceptions (TaskError) nor timeouts retry —
                # the first request may still be EXECUTING, and a retry
                # would run user side effects twice.
                self._handles.pop(target, None)
                handle = self._resolve_handle(target)
                result = handle.remote(*args, **kwargs).result(timeout=120)
        except _FuturesTimeout:
            # the 120 s ingress budget fired with the handle call still
            # in-flight (a wedged replica): nothing was counted yet —
            # this is the one timeout this layer must record
            # (py3.10: futures' timeout is NOT the builtin TimeoutError)
            code = "DEADLINE_EXCEEDED"
            obs.errors_total().inc(tags={
                "app": app, "deployment": handle.deployment_name,
                "kind": "rejected_timeout"})
            raise
        except TimeoutError:
            # handle-layer deadline: _routed_call already counted
            # rejected_timeout / replica_died for it
            code = "DEADLINE_EXCEEDED"
            raise
        except Exception:
            # kinds are counted once, at the handle layer (_routed_call
            # stamps app_error / replica_died / rejected_timeout) — only
            # the gRPC status code is this ingress's to record
            code = "INTERNAL"
            raise
        finally:
            obs.deactivate_request(token)
            seconds = time.perf_counter() - t0
            obs.request_seconds().observe(seconds, tags={
                "app": app, "deployment": handle.deployment_name,
                "route": route, "code": code})
            obs.requests_total().inc(tags={"app": app, "code": code})
            obs.emit_span(
                f"serve:{req_ctx['request_id']}:g:{req_ctx['span_id'][:8]}",
                f"grpc:{app}.{method}",
                request_id=req_ctx["request_id"],
                span_id=req_ctx["span_id"], parent_span_id=None,
                t_start=t_epoch, t_end=t_epoch + seconds,
                phases={"handle": seconds})
        return cloudpickle.dumps(result)

    async def shutdown(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)


def grpc_request(address: str, app: str, *args, method: str = "__call__",
                 timeout: float = 30.0, **kwargs) -> Any:
    """Convenience client: one unary call to a served application."""
    import grpc

    suffix = app if method == "__call__" else f"{app}.{method}"
    with grpc.insecure_channel(address) as channel:
        fn = channel.unary_unary(
            f"/{SERVICE}/{suffix}",
            request_serializer=None,
            response_deserializer=None)
        payload = cloudpickle.dumps((args, kwargs))
        return cloudpickle.loads(fn(payload, timeout=timeout))
