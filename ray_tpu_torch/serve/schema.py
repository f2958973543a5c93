"""Declarative Serve config: YAML/dict -> running applications.

Reference analogs: ``serve/schema.py`` (``ServeDeploySchema``,
``ServeApplicationSchema``) and the ``serve deploy`` / ``serve status`` /
``serve shutdown`` CLI (``serve/scripts.py``). Shape::

    applications:
      - name: my_app
        route_prefix: /api          # null = no HTTP route
        import_path: my_module:app  # Application or factory fn
        args: {...}                 # passed to a factory fn
        deployments:                # per-deployment overrides
          - name: Model
            num_replicas: 3
            max_ongoing_requests: 16
http_options:
  host: 127.0.0.1
  port: 8000
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.api import Application, HTTPOptions


def _import_attr(import_path: str) -> Any:
    if ":" in import_path:
        module_name, attr = import_path.split(":", 1)
    else:
        module_name, attr = import_path.rsplit(".", 1)
    obj = importlib.import_module(module_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


_OVERRIDE_FIELDS = ("num_replicas", "max_ongoing_requests",
                    "autoscaling_config", "user_config", "ray_actor_options",
                    "health_check_period_s", "graceful_shutdown_timeout_s")


def _apply_overrides(app: Application, overrides: List[Dict]) -> None:
    """Re-bind each overridden deployment through ``Deployment.options()``
    so the normal validation/normalization runs (``num_replicas: auto``,
    dict autoscaling configs) and the SHARED module-level Deployment object
    is never mutated — two applications importing one deployment must not
    leak overrides into each other."""
    by_name = {d["name"]: d for d in overrides}
    seen: set = set()

    def walk(a: Application) -> None:
        if id(a) in seen:
            return
        seen.add(id(a))
        o = by_name.get(a._deployment.name)
        if o:
            kwargs = {f: o[f] for f in _OVERRIDE_FIELDS if f in o}
            if kwargs:
                a._deployment = a._deployment.options(**kwargs)
        for arg in list(a._args) + list(a._kwargs.values()):
            if isinstance(arg, Application):
                walk(arg)

    walk(app)


def build_application(app_cfg: Dict) -> Application:
    target = _import_attr(app_cfg["import_path"])
    if isinstance(target, Application):
        app = target
    elif callable(target):
        app = target(**(app_cfg.get("args") or {}))
    else:
        raise TypeError(
            f"{app_cfg['import_path']} is neither an Application nor a "
            f"factory callable")
    if not isinstance(app, Application):
        raise TypeError(
            f"factory {app_cfg['import_path']} returned {type(app)}, "
            f"expected an Application")
    _apply_overrides(app, app_cfg.get("deployments") or [])
    return app


def deploy_config(config: Dict, *, blocking: bool = True) -> List[str]:
    """Deploy every application in a parsed config dict; returns app names."""
    from ray_tpu_torch import serve

    http = config.get("http_options") or {}
    http_options = HTTPOptions(host=http.get("host", "127.0.0.1"),
                               port=http.get("port", 8000))
    names = []
    for app_cfg in config.get("applications", []):
        name = app_cfg.get("name") or "default"
        serve.run(build_application(app_cfg), name=name,
                  route_prefix=app_cfg.get("route_prefix", "/"),
                  _blocking=blocking, http_options=http_options)
        names.append(name)
    return names


def load_config_file(path: str) -> Dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
