"""Process-group bootstrap (port of ``ray_tpu/collective/rendezvous.py``).

Two rendezvous. A gang started by the port's runtime (``TorchTrainer``'s
workers) meets through the GCS key-value store, as JAX's does: rank 0
publishes ``host:port`` under a key of the group, the other ranks poll it,
and every rank joins ``tcp://host:port``. Outside the runtime the caller
names the rendezvous (``init_method``: ``tcp://host:port`` or
``file:///path``). Every call passes a timeout, so a rank whose peers never
come fails instead of waiting forever. ``bootstrap_jax_distributed`` has
no counterpart.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Dict, Optional

import torch

# group name -> the init_method its bootstrap used (clear_rendezvous)
_RENDEZVOUS: Dict[str, str] = {}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _kv_key(group_name: str) -> str:
    return f"@rendezvous/torch/{group_name}/coordinator"


def _kv_init_method(backend, group_name: str, rank: int,
                    timeout_s: float) -> str:
    """Rank 0 publishes ``host:port`` under the group's key; the other
    ranks poll it (JAX's ``_publish_or_await_coordinator``)."""
    key = _kv_key(group_name)
    if rank == 0:
        ip = socket.gethostbyname(socket.gethostname())
        address = f"{ip}:{_free_port()}"
        backend.kv_put(key, address.encode())
        return f"tcp://{address}"
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        raw = backend.kv_get(key)
        if raw:
            return f"tcp://{raw.decode()}"
        time.sleep(0.1)
    raise TimeoutError(
        f"torch rendezvous {group_name!r}: coordinator address not "
        f"published within {timeout_s}s")


def _runtime_backend():
    from ray_tpu_torch.core.worker import global_worker

    w = global_worker()
    return w.backend if w.connected else None


def bootstrap_torch_distributed(world_size: int, rank: int,
                                group_name: str = "train",
                                backend_name: str = "nccl",
                                timeout_s: float = 60.0, *,
                                init_method: Optional[str] = None) -> None:
    """Join the default process group as ``rank`` of ``world_size``, from
    every member of a gang, through ``init_method``, or, without one, in a
    process of the port's runtime, through the GCS key-value store under
    ``group_name``. ``nccl`` (the default) needs a CUDA device and binds
    the rank to device ``rank % device_count``; the CPU takes
    ``backend_name="gloo"``. Unlike JAX's, a gang of one initialises too:
    a mesh needs the default group even on one device."""
    import torch.distributed as dist

    if backend_name == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on cuda by default and no CUDA device is "
            "available; pass backend_name='gloo' to run on the CPU")
    if not 0 <= rank < world_size:
        raise ValueError(
            f"rank {rank} out of range for world_size {world_size}")
    kv = None
    if init_method is None:
        kv = _runtime_backend()
        if kv is None:
            raise ValueError(
                f"torch rendezvous {group_name!r} needs an init_method "
                f"(tcp://host:port or file:///path shared by the gang) "
                f"outside the port's runtime")
        init_method = _kv_init_method(kv, group_name, rank, timeout_s)
    if backend_name == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend_name, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _RENDEZVOUS[group_name] = init_method
    if kv is not None and rank == 0:
        # init_process_group returns once every rank has connected, so all
        # have read the key: clear it, as JAX's does
        try:
            kv.kv_del(_kv_key(group_name))
        except Exception:  # noqa: BLE001 — the next gang's name is fresh
            pass


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
