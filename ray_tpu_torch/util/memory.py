"""Device memory of this process's CUDA devices (the step profiler's peak
memory column, and the ``rt_hbm_used_bytes`` gauges).

The JAX package's ``util/memory.py`` walks the cluster's nodes and reads
each JAX device's ``memory_stats()``; the port reads the caching
allocator of each local CUDA device. Serve replicas push their retained KV
pages to the cluster's KV (``publish_kv_snapshot``), as JAX's do; the
cluster-wide ``memory_summary`` that reads them waits for the runtime's
tooling (ROADMAP item R5).
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

import torch


def device_memory_stats() -> List[Dict[str, Any]]:
    """One dict per local CUDA device: ``device`` (its index),
    ``bytes_in_use`` (allocated by tensors now), ``peak_bytes_in_use``
    (``torch.cuda.max_memory_allocated``: the most since the last
    ``reset_peak_memory_stats``) and ``bytes_limit`` (the card's memory).
    Empty without CUDA."""
    if not torch.cuda.is_available():
        return []
    return [{"device": i,
             "bytes_in_use": torch.cuda.memory_allocated(i),
             "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
             "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
            for i in range(torch.cuda.device_count())]


#: JAX's gauge: live device bytes by device
HBM_GAUGE = "rt_hbm_used_bytes"


def publish_hbm_gauges(sink: Callable[[str, str, float, Dict[str, str]],
                                      None],
                       stats: Optional[List[Dict[str, Any]]] = None
                       ) -> None:
    """Hand ``rt_hbm_used_bytes{device=}`` of each device in ``stats``
    (default ``device_memory_stats()``) to ``sink(series, "set", value,
    tags)``, a ``Sinks.metric``. JAX sets the same gauge in its metrics
    registry, tagged ``<platform>:<id>``; here the tag is ``cuda:<index>``.
    Observability never fails the caller: a sink that raises ends the
    pass quietly, as JAX's does."""
    try:
        stats = device_memory_stats() if stats is None else stats
        for d in stats:
            if d.get("bytes_in_use") is None:
                continue
            sink(HBM_GAUGE, "set", float(d["bytes_in_use"]),
                 {"device": f"cuda:{d['device']}"})
    except Exception:  # noqa: BLE001 — observability never fails the caller
        pass


#: the cluster-KV prefix of each process's retained KV-cache snapshot
_KVCACHE_KV_PREFIX = "@memkv/"


def publish_kv_snapshot(backend) -> None:
    """Push this process's live prefix/KV-cache stats to the cluster's KV
    (``@memkv/<address>``), as JAX's serve replicas do on a throttle."""
    from ray_tpu_torch.models import serving

    caches = serving.live_kv_cache_stats()
    if not caches:
        return
    owner = getattr(backend, "address", "local")
    try:
        backend.kv_put(f"{_KVCACHE_KV_PREFIX}{owner}",
                       json.dumps({"t": time.time(), "owner": owner,
                                   "caches": caches}))
    except Exception:  # noqa: BLE001 — KV unavailable (local backend)
        pass
