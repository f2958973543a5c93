"""Device memory of this process's CUDA devices (the step profiler's peak
memory column).

The JAX package's ``util/memory.py`` walks the cluster's nodes and reads
each JAX device's ``memory_stats()``; the port reads the caching
allocator of each local CUDA device and nothing else.
"""

from __future__ import annotations

from typing import Any, Dict, List

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
