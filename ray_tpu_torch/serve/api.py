"""Public serve API: ``@serve.deployment``, ``serve.run``, handles.

Reference analogs: ``serve/api.py`` (``deployment :320``, ``run :480``),
``serve/deployment.py`` (``Deployment``, ``Application``). An app is a DAG
of deployments composed by ``.bind()``: binding an ``Application`` as an
init arg gives the parent a ``DeploymentHandle`` to the child at replica
construction time (the reference's model-composition pattern).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                  HTTPOptions)
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle, _HandleMarker

_controller_lock = threading.Lock()
_controller = None


def _get_controller(create: bool = False):
    """The singleton controller actor (named, discovered via get_actor).

    RPCs run OUTSIDE _controller_lock: a caller blocked in get_actor (e.g.
    a stale router poller racing a shutdown) must never wedge every other
    serve call behind the lock."""
    global _controller
    with _controller_lock:
        if _controller is not None:
            return _controller
    try:
        found = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001 — not created yet
        if not create:
            raise RuntimeError(
                "serve is not running (no controller); call serve.run() "
                "or serve.start() first") from None
        # long-poll calls (get_replicas/get_routing_table wait=True)
        # each hold an actor thread — size the pool for many routers
        found = ServeController.options(
            name=CONTROLLER_NAME, max_concurrency=256,
            num_cpus=0, get_if_exists=True).remote()
    with _controller_lock:
        if _controller is None:
            _controller = found
        return _controller


def _forget_controller() -> None:
    global _controller
    with _controller_lock:
        _controller = None
    from ray_tpu_torch.serve.handle import _reset_pool

    _reset_pool()


class Application:
    """A deployment bound with init args — the unit passed to serve.run."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self._deployment = deployment
        self._args = args
        self._kwargs = kwargs


class Deployment:
    """The product of ``@serve.deployment`` — immutable; ``options`` copies."""

    def __init__(self, body: Union[type, Callable], name: str,
                 config: DeploymentConfig):
        self._body = body
        self.name = name
        self._config = config

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[Union[int, str]] = None,
                max_ongoing_requests: Optional[int] = None,
                autoscaling_config: Optional[Union[Dict, AutoscalingConfig]] = None,
                user_config: Optional[Dict] = None,
                ray_actor_options: Optional[Dict] = None,
                health_check_period_s: Optional[float] = None,
                graceful_shutdown_timeout_s: Optional[float] = None,
                ) -> "Deployment":
        import dataclasses

        cfg = dataclasses.replace(self._config)
        if num_replicas == "auto":
            autoscaling_config = autoscaling_config or AutoscalingConfig()
            num_replicas = None
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if user_config is not None:
            cfg.user_config = user_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        return Deployment(self._body, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def __repr__(self) -> str:
        return f"Deployment({self.name})"


def deployment(_body=None, *, name: Optional[str] = None,
               num_replicas: Union[int, str, None] = None,
               max_ongoing_requests: Optional[int] = None,
               autoscaling_config: Optional[Union[Dict, AutoscalingConfig]] = None,
               user_config: Optional[Dict] = None,
               ray_actor_options: Optional[Dict] = None,
               health_check_period_s: Optional[float] = None,
               graceful_shutdown_timeout_s: Optional[float] = None):
    """``@serve.deployment`` on a class (or function) makes it deployable::

        @serve.deployment(num_replicas=2, ray_actor_options={"num_gpus": 1})
        class Model:
            def __call__(self, request): ...
    """

    def make(body):
        base = Deployment(body, getattr(body, "__name__", "deployment"),
                          DeploymentConfig())
        return base.options(
            name=name, num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling_config, user_config=user_config,
            ray_actor_options=ray_actor_options,
            health_check_period_s=health_check_period_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s)

    if _body is not None:
        return make(_body)
    return make


def _collect_graph(app: Application, app_name: str,
                   out: List[Dict]) -> str:
    """DFS the bind graph; child Applications in args become handle markers.
    Returns this app node's deployment name."""

    def convert(obj):
        if isinstance(obj, Application):
            child = _collect_graph(obj, app_name, out)
            return _HandleMarker(app_name, child)
        if isinstance(obj, tuple):
            return tuple(convert(x) for x in obj)
        if isinstance(obj, list):
            return [convert(x) for x in obj]
        if isinstance(obj, dict):
            return {k: convert(v) for k, v in obj.items()}
        return obj

    dep = app._deployment
    entry = {"name": dep.name, "body": dep._body,
             "init_args": convert(app._args),
             "init_kwargs": convert(app._kwargs),
             "config": dep._config}
    existing = next((d for d in out if d["name"] == dep.name), None)
    if existing is None:
        out.append(entry)
    elif (existing["body"] is not dep._body
          or existing["init_args"] != entry["init_args"]
          or existing["init_kwargs"] != entry["init_kwargs"]
          or existing["config"] != dep._config):
        raise ValueError(
            f"deployment name {dep.name!r} bound twice with different "
            f"code/args/config — rename one with "
            f".options(name=...) (each name maps to ONE replica set)")
    return dep.name


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/",
        _blocking: bool = True,
        http_options: Optional[HTTPOptions] = None) -> DeploymentHandle:
    """Deploy an application; returns a handle to its ingress deployment."""
    if not isinstance(app, Application):
        raise TypeError("serve.run() takes an Application "
                        "(deployment.bind(...))")
    controller = _get_controller(create=True)
    deployments: List[Dict] = []
    ingress = _collect_graph(app, name, deployments)
    ray_tpu_torch.get(controller.deploy_application.remote(
        name, route_prefix or "/", ingress, deployments))
    if route_prefix is not None:
        opts = http_options or HTTPOptions()
        ray_tpu_torch.get(controller.ensure_proxy.remote(
            opts.host, opts.port, opts.num_proxies))
    if _blocking:
        ray_tpu_torch.get(controller.wait_healthy.remote(name), timeout=120)
    return DeploymentHandle(name, ingress)


def start(http_options: Optional[HTTPOptions] = None) -> None:
    """Start the controller (and proxy fleet) without deploying anything."""
    controller = _get_controller(create=True)
    opts = http_options or HTTPOptions()
    ray_tpu_torch.get(controller.ensure_proxy.remote(
        opts.host, opts.port, opts.num_proxies))


def start_grpc(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start the gRPC ingress (reference: ``gRPCProxy``); returns the bound
    port. Callers hit ``/rt.serve/<app>[.<method>]`` with cloudpickled
    (args, kwargs) — see ``serve.grpc_proxy.grpc_request``."""
    controller = _get_controller(create=True)
    return ray_tpu_torch.get(controller.ensure_grpc_proxy.remote(host, port))


def http_port() -> int:
    """The bound port of the (first) HTTP proxy (after serve.run/start)."""
    controller = _get_controller()
    return ray_tpu_torch.get(controller.ensure_proxy.remote("127.0.0.1", 0))


def proxy_ports() -> List[int]:
    """Every bound HTTP proxy port, registry order (multi-proxy front
    doors — point a load balancer at all of them)."""
    controller = _get_controller()
    return ray_tpu_torch.get(controller.proxy_ports.remote())


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = _get_controller()
    apps = ray_tpu_torch.get(controller.list_applications.remote())
    if name not in apps:
        raise KeyError(f"no application named {name!r}")
    return DeploymentHandle(name, apps[name]["ingress"])


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(app_name, deployment_name)


def status() -> Dict[str, Any]:
    controller = _get_controller()
    return ray_tpu_torch.get(controller.list_applications.remote())


def detailed_status(decision_limit: int = 50) -> Dict[str, Any]:
    """Applications + per-deployment windowed stats (p50/p99/QPS/queue
    depth) + the autoscaler decision-log tail — what `rt serve status
    --verbose` and the dashboard Serve tab render."""
    controller = _get_controller()
    return ray_tpu_torch.get(controller.serve_status.remote(decision_limit))


def delete(name: str) -> None:
    controller = _get_controller()
    ray_tpu_torch.get(controller.delete_application.remote(name))


def shutdown() -> None:
    global _controller
    try:
        controller = _get_controller()
    except RuntimeError:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except Exception:  # noqa: BLE001 — already gone
        pass
    _forget_controller()
