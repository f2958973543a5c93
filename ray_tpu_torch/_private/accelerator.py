"""GPU autodetection for node resource defaults (port of
``ray_tpu/_private/accelerator.py``, which counts TPU chips).

Equivalent of the reference's ``python/ray/_private/accelerator.py``
(``_autodetect_num_gpus``). The count comes from the ``/dev/nvidia<N>``
device nodes this process may open, so detecting GPUs never initialises
CUDA (the raylet and the driver's control plane must not hold a CUDA
context); a ``CUDA_VISIBLE_DEVICES`` in the environment narrows it, and
``RT_NUM_GPUS`` overrides it, as JAX's ``RT_NUM_TPUS`` does for chips.

A worker process that holds GPUs is pinned to them through
``CUDA_VISIBLE_DEVICES`` (JAX: ``TPU_VISIBLE_CHIPS``), set only for
workers that hold some.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

NUM_GPUS_ENV = "RT_NUM_GPUS"
VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"


def _visible_ids() -> Optional[List[str]]:
    """The entries of this process's ``CUDA_VISIBLE_DEVICES`` up to the
    first one that names no device (CUDA ignores the rest), or None when
    it is unset."""
    raw = os.environ.get(VISIBLE_DEVICES_ENV)
    if raw is None:
        return None
    ids: List[str] = []
    for item in raw.split(","):
        item = item.strip()
        if not item or item.startswith("-"):
            break
        ids.append(item)
    return ids


def _usable(device_node: str) -> bool:
    """Whether this process may open the device node: a container can
    show nodes of cards it is not allowed to use (its device cgroup
    refuses the open). Opening the file does not initialise CUDA."""
    try:
        os.close(os.open(device_node, os.O_RDWR))
        return True
    except OSError:
        return False


def autodetect_num_gpus() -> int:
    if NUM_GPUS_ENV in os.environ:
        return int(os.environ[NUM_GPUS_ENV])
    n = sum(_usable(p) for p in glob.glob("/dev/nvidia[0-9]*"))
    visible = _visible_ids()
    if visible is not None:
        n = min(n, len(visible))
    return n


def set_visible_gpus(gpu_indices, env: Optional[dict] = None) -> None:
    """Pin a worker process to the node's GPU instances ``gpu_indices``
    (reference: ``CUDA_VISIBLE_DEVICES`` handling, ``worker.py:430``).
    Instance ``i`` is the node's ``i``-th visible device: where this
    process itself sees a ``CUDA_VISIBLE_DEVICES`` list, its ``i``-th
    entry."""
    visible = _visible_ids()
    target = env if env is not None else os.environ
    target[VISIBLE_DEVICES_ENV] = ",".join(
        visible[i] if visible is not None and i < len(visible) else str(i)
        for i in gpu_indices)
