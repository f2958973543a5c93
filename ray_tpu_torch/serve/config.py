"""Serve configuration objects (the port's twin of
``ray_tpu/serve/config.py``).

Reference analogs: ``serve/config.py`` (``AutoscalingConfig``,
``DeploymentConfig``) and ``serve/schema.py``. Replicas carry ``num_gpus``
through ``ray_actor_options`` so a deployment pins whole GPUs (the raylet
sets the worker's ``CUDA_VISIBLE_DEVICES``), and ``max_ongoing_requests``
defaults low because a GPU replica saturates with a few concurrent batched
calls, not hundreds of tiny ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

DEFAULT_MAX_ONGOING_REQUESTS = 8
DEFAULT_HTTP_PORT = 8123


@dataclasses.dataclass
class AutoscalingConfig:
    """Metrics-driven autoscaling.

    Base policy (``serve/_private/autoscaling_policy.py:12``):
    desired = ceil(total_ongoing_requests / target_ongoing_requests),
    clamped to [min_replicas, max_replicas], with hysteresis delays.
    ``min_replicas=0`` enables scale-to-zero (a cold request wakes the
    deployment through the router's wake RPC).

    The optional signals below layer onto the windowed per-replica stats
    the controller already polls (queue depth, latency percentiles, QPS
    — the serve observability plane); when several are set the autoscaler
    takes the MAX desired count and the decision log records which
    signal drove it:

      - ``target_queue_depth``: admitted-but-waiting requests one
        replica should carry; desired >= ceil(total_queue / target).
      - ``max_p99_s``: sustained request p99 above this (at qps > 0)
        asks for one replica more than current — a latency backstop for
        load shapes ongoing-counts under-report (few, slow requests).
      - ``target_qps_per_replica``: completed requests/s one replica
        should serve; desired >= ceil(qps / target).
    """

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0
    metrics_interval_s: float = 0.5
    look_back_period_s: float = 5.0
    target_queue_depth: Optional[float] = None
    max_p99_s: Optional[float] = None
    target_qps_per_replica: Optional[float] = None

    def validate(self) -> None:
        if self.min_replicas < 0 or self.max_replicas < 1:
            raise ValueError("min_replicas >= 0 and max_replicas >= 1 required")
        if self.min_replicas > self.max_replicas:
            raise ValueError("min_replicas must be <= max_replicas")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be positive")
        for name in ("target_queue_depth", "max_p99_s",
                     "target_qps_per_replica"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive when set")


@dataclasses.dataclass
class DeploymentConfig:
    """Per-deployment settings (reference ``DeploymentConfig``)."""

    num_replicas: int = 1
    max_ongoing_requests: int = DEFAULT_MAX_ONGOING_REQUESTS
    autoscaling_config: Optional[AutoscalingConfig] = None
    user_config: Optional[Dict[str, Any]] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0
    ray_actor_options: Optional[Dict[str, Any]] = None

    def validate(self) -> None:
        if self.num_replicas < 0:
            raise ValueError("num_replicas must be >= 0")
        if self.max_ongoing_requests < 1:
            raise ValueError("max_ongoing_requests must be >= 1")
        if self.autoscaling_config is not None:
            if isinstance(self.autoscaling_config, dict):
                self.autoscaling_config = AutoscalingConfig(
                    **self.autoscaling_config)
            self.autoscaling_config.validate()


@dataclasses.dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = DEFAULT_HTTP_PORT
    request_timeout_s: float = 60.0
    # front-door scale-out: N independent proxy processes (the
    # first binds ``port``, the rest bind ephemeral ports) — every proxy
    # registers in the GCS registry so an external LB can front them and
    # one event loop stops being the ingress ceiling
    num_proxies: int = 1
