"""Process-group bootstrap (port of ``ray_tpu/collective/rendezvous.py``).

JAX's ``bootstrap_torch_distributed`` publishes rank 0's coordinator
address through the cluster runtime's KV store, which the port may not
import; here the caller names the rendezvous (``init_method``:
``tcp://host:port`` or ``file:///path``), and every call passes a
timeout, so a rank whose peers never come fails instead of waiting
forever. ``bootstrap_jax_distributed`` has no counterpart.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import torch

# group name -> the init_method its bootstrap used (clear_rendezvous)
_RENDEZVOUS: Dict[str, str] = {}


def bootstrap_torch_distributed(world_size: int, rank: int,
                                group_name: str = "train",
                                backend_name: str = "nccl",
                                timeout_s: float = 60.0, *,
                                init_method: Optional[str] = None) -> None:
    """Join the default process group as ``rank`` of ``world_size``, from
    every member of a gang, through ``init_method``. ``nccl`` (the
    default) needs a CUDA device and binds the rank to device ``rank %
    device_count``; the CPU takes ``backend_name="gloo"``. Unlike JAX's, a
    gang of one initialises too: a mesh needs the default group even on
    one device."""
    import torch.distributed as dist

    if backend_name == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on cuda by default and no CUDA device is "
            "available; pass backend_name='gloo' to run on the CPU")
    if init_method is None:
        raise ValueError(
            f"torch rendezvous {group_name!r} needs an init_method "
            f"(tcp://host:port or file:///path shared by the gang)")
    if not 0 <= rank < world_size:
        raise ValueError(
            f"rank {rank} out of range for world_size {world_size}")
    if backend_name == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend_name, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _RENDEZVOUS[group_name] = init_method


def clear_rendezvous(group_name: str = "train") -> None:
    """Tear down what ``bootstrap_torch_distributed`` set up for
    ``group_name``: the default process group, and a ``file://`` store,
    which a later gang must not find (it would read this gang's keys), as
    JAX's deletes the published coordinator key."""
    import torch.distributed as dist

    method = _RENDEZVOUS.pop(group_name, None)
    if method is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    if method.startswith("file://"):
        try:
            os.unlink(method[len("file://"):])
        except FileNotFoundError:
            pass
