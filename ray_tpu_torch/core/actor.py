"""Actor API objects: ActorClass, ActorHandle, ActorMethod.

Equivalent of the reference's ``python/ray/actor.py`` (``ActorClass :384``,
``ActorHandle :1025``, ``ActorMethod :98``): a decorated class becomes an
ActorClass whose ``.remote()`` registers the actor with the control plane and
returns a handle; method calls on the handle submit ordered actor tasks
directly to the actor's worker. Handles are serializable and can be passed to
other tasks/actors.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch.core.task_spec import validate_options


class ActorMethod:
    """Bound method wrapper exposing ``.remote()`` / ``.options()``."""

    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        return self._handle._submit(self._method_name, args, kwargs,
                                    num_returns=self._num_returns)

    def options(self, **opts):
        validate_options(opts, for_actor=False)
        for k in ("deadline_s", "on_overload"):
            if opts.get(k) is not None:
                raise ValueError(
                    f"option {k!r} is not supported on actor method "
                    "calls: actor tasks go straight to the actor's "
                    "worker and never sit in the raylet queue")
        handle, name = self._handle, self._method_name

        class _Opted:
            def remote(self, *args, **kwargs):
                return handle._submit(name, args, kwargs,
                                      num_returns=opts.get("num_returns", 1),
                                      name=opts.get("name"))

        return _Opted()

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag.dag_node import ClassMethodNode

        return ClassMethodNode(self._handle, self._method_name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor methods cannot be called directly; use "
            f"actor.{self._method_name}.remote()."
        )


class ActorHandle:
    """A reference to a live actor; submits ordered tasks to it."""

    def __init__(self, actor_id: ActorID, class_name: str,
                 method_meta: Dict[str, int], original_handle: bool = False):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_meta = method_meta  # method name -> default num_returns
        self._original_handle = original_handle

    @property
    def _actor_id_hex(self) -> str:
        return self._actor_id.hex()

    def _submit(self, method_name: str, args: Tuple, kwargs: Dict,
                num_returns: int = 1, name: Optional[str] = None):
        from ray_tpu_torch.core.worker import global_worker

        return global_worker().submit_actor_task(
            self._actor_id, method_name, args, kwargs, num_returns=num_returns)

    def __getattr__(self, item: str) -> ActorMethod:
        if item.startswith("_"):
            raise AttributeError(item)
        if self._method_meta and item not in self._method_meta:
            raise AttributeError(
                f"actor {self._class_name} has no method {item!r}")
        return ActorMethod(self, item, (self._method_meta or {}).get(item, 1))

    # -- serialization -------------------------------------------------------
    def _descriptor(self):
        return (self._actor_id.binary(), self._class_name, tuple(self._method_meta.items()))

    @classmethod
    def _rehydrate(cls, desc) -> "ActorHandle":
        return cls(ActorID(desc[0]), desc[1], dict(desc[2]))

    def __reduce__(self):
        return (ActorHandle._rehydrate, (self._descriptor(),))

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"


def _method_metadata(cls: type) -> Dict[str, int]:
    meta: Dict[str, int] = {}
    for name, member in inspect.getmembers(cls, predicate=callable):
        if name.startswith("__") and name != "__call__":
            continue
        meta[name] = getattr(member, "_num_returns", 1)
    return meta


class ActorClass:
    """The product of ``@remote`` on a class."""

    def __init__(self, cls: type, default_options: Dict[str, Any]):
        self._cls = cls
        self._default_options = validate_options(dict(default_options), for_actor=True)
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._default_options)
        merged.update(validate_options(opts, for_actor=True))
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.core.worker import global_worker

        return global_worker().create_actor(
            self._cls, self._default_options, args, kwargs,
            method_meta=_method_metadata(self._cls))

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag.dag_node import ClassNode

        return ClassNode(self, args, kwargs)

    @property
    def underlying_class(self) -> type:
        return self._cls


def method(*, num_returns: int = 1,
           concurrency_group: Optional[str] = None):
    """Per-method options decorator (reference: ``ray.method``).
    ``concurrency_group`` names one of the actor's declared
    ``concurrency_groups`` pools (reference: ConcurrencyGroupManager)."""

    def deco(fn):
        fn._num_returns = num_returns
        if concurrency_group is not None:
            fn._concurrency_group = concurrency_group
        return fn

    return deco
