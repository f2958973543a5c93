"""Model multiplexing: many models share a replica pool via per-replica LRU.

Reference analog: ``python/ray/serve/multiplex.py`` (``@serve.multiplexed``
+ ``serve.get_multiplexed_model_id``): a decorated async loader caches up to
``max_num_models_per_replica`` models per replica; the handle routes a
request tagged with ``multiplexed_model_id`` to a replica that already holds
that model when one is known (falling back to power-of-two).
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
from collections import OrderedDict
from typing import Any, Callable, Optional

_current_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "rt_serve_multiplexed_model_id", default="")

_CACHE_ATTR = "__rt_mux_cache__"


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id the caller tagged it with
    (``handle.options(multiplexed_model_id=...)``)."""
    return _current_model_id.get()


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorate a model-loader method ``def get_model(self, model_id)``.

    The wrapper memoizes per (instance, model_id) with LRU eviction at
    ``max_num_models_per_replica``; the replica reports its loaded ids so
    the handle can route model-affine.
    """

    def deco(fn: Callable):
        is_async = inspect.iscoroutinefunction(fn)

        def _cache(instance) -> OrderedDict:
            cache = getattr(instance, _CACHE_ATTR, None)
            if cache is None:
                cache = OrderedDict()
                setattr(instance, _CACHE_ATTR, cache)
            return cache

        def _evict(cache: OrderedDict) -> None:
            while len(cache) > max_num_models_per_replica:
                # drop the reference: refcounting finalizes (calling __del__
                # explicitly would double-finalize at GC); models that need
                # eager teardown expose an ``unload()`` hook
                _, old = cache.popitem(last=False)
                unload = getattr(old, "unload", None)
                if callable(unload):
                    try:
                        unload()
                    except Exception:  # noqa: BLE001 — eviction best-effort
                        pass

        def _count(model_id: str, outcome: str) -> None:
            # model id as a metric label: per-model traffic + cache
            # hit/load split for the replica-pool LRU
            try:
                from ray_tpu_torch.serve import obs

                obs.mux_requests_total().inc(tags={
                    "model_id": model_id or "_default",
                    "outcome": outcome})
            except Exception:  # noqa: BLE001 — telemetry best-effort
                pass

        if is_async:
            async def wrapper(self, model_id: Optional[str] = None):
                model_id = model_id or get_multiplexed_model_id()
                cache = _cache(self)
                if model_id in cache:
                    cache.move_to_end(model_id)
                    _count(model_id, "hit")
                    return cache[model_id]
                model = await fn(self, model_id)
                cache[model_id] = model
                _evict(cache)
                _count(model_id, "load")
                return model
        else:
            def wrapper(self, model_id: Optional[str] = None):
                model_id = model_id or get_multiplexed_model_id()
                cache = _cache(self)
                if model_id in cache:
                    cache.move_to_end(model_id)
                    _count(model_id, "hit")
                    return cache[model_id]
                model = fn(self, model_id)
                cache[model_id] = model
                _evict(cache)
                _count(model_id, "load")
                return model

        wrapper.__name__ = getattr(fn, "__name__", "get_model")
        wrapper.__rt_multiplexed__ = True
        return wrapper

    if func is not None:
        return deco(func)
    return deco


def loaded_model_ids(instance: Any) -> list:
    cache = getattr(instance, _CACHE_ATTR, None)
    return list(cache.keys()) if cache else []
