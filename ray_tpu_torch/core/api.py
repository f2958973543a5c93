"""The ``@remote`` surface: RemoteFunction and the decorator itself.

Equivalent of the reference's ``python/ray/remote_function.py``
(``RemoteFunction :40``, ``_remote :257``) plus the decorator plumbing in
``python/ray/__init__.py``. A decorated function is exported to the function
table once (lazily) and invoked via small TaskSpecs thereafter.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict

from ray_tpu_torch.core.actor import ActorClass
from ray_tpu_torch.core.task_spec import validate_options


class RemoteFunction:
    def __init__(self, fn: Callable, default_options: Dict[str, Any]):
        self._fn = fn
        self._default_options = validate_options(dict(default_options), for_actor=False)
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__name__} cannot be called directly; "
            f"use {self._fn.__name__}.remote()."
        )

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._default_options)
        merged.update(validate_options(opts, for_actor=False))
        return RemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.worker import global_worker

        return global_worker().submit_task(self._fn, self._default_options, args, kwargs)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)

    @property
    def underlying_function(self) -> Callable:
        return self._fn


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_gpus=1, ...)`` for functions and classes."""

    def make(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        if callable(target):
            return RemoteFunction(target, kwargs)
        raise TypeError(f"@remote target must be a function or class, got {target!r}")

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return make(args[0])
    if args:
        raise TypeError("@remote accepts only keyword options, e.g. @remote(num_gpus=1)")
    return make
