"""Named collective groups over ``torch.distributed`` (port of the group
API in ``ray_tpu/collective/collective.py:196-419``).

Members join a named group with (world_size, rank) and then issue the
group's collectives in the same program order, as JAX's host plane (and
NCCL) require. A group is a ``torch.distributed`` subgroup of the default
process group (``bootstrap_torch_distributed``): its members publish their
global ranks in the default group's store under the group's name and
create the subgroup among themselves, so ranks outside it need not call
anything. Its ranks follow the default group's order (rank ``r`` of the
group is its ``r``-th member by global rank).

JAX's semantics are kept: every op returns a new tensor (the input is not
changed); a group of one returns a copy; ``reducescatter`` returns the
rank's ``np.array_split`` chunk of the reduced tensor, which may be
uneven (padded to even chunks for the backend, which needs them, and
trimmed); ``send`` is buffered, so it returns before the matching
``recv`` runs; sending to oneself raises ``ValueError``. Tensors go to
the group's device (``cuda`` for nccl) and come back there; numpy arrays
are accepted. Unlike JAX's ring, ``allgather`` and ``broadcast`` need the
same shape and dtype on every rank, as the backends do.

``create_collective_group`` (a runtime actor), ``ship_params``,
``fetch_params``, ``cancel_shipment`` and ``shipment_receipt`` ride the
cluster runtime's object and stream planes and are not ported yet
(ROADMAP item R4).
"""

from __future__ import annotations

import collections
import datetime
from typing import Dict, List

import numpy as np
import torch

_PREFIX = "rt_collective"


class _Group:
    def __init__(self, name: str, world_size: int, rank: int,
                 members: List[int], group, device: torch.device):
        self.name, self.world_size, self.rank = name, world_size, rank
        self.members, self.group, self.device = members, group, device
        self.calls: Dict[str, int] = collections.Counter()
        self.pending: list = []     # (work, buffer) of buffered sends

    def settle(self) -> None:
        """Forget the sends the backend has completed."""
        self.pending = [(w, b) for w, b in self.pending
                        if not w.is_completed()]


_GROUPS: Dict[str, _Group] = {}


def _reduce_op(op: str):
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
           "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"unknown reduce op {op!r}; one of {sorted(ops)}")
    return ops[op]


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default", backend: str = None,
                          timeout_s: float = 60.0) -> None:
    """Join ``group_name`` as its ``rank`` of ``world_size``. ``backend``
    defaults to the default group's (nccl or gloo)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    if not 0 <= rank < world_size:
        raise ValueError(
            f"rank {rank} out of range for world_size {world_size}")
    if not dist.is_initialized():
        raise RuntimeError("collective groups need the default process "
                           "group: call bootstrap_torch_distributed first")
    backend = backend or dist.get_backend()
    store = c10d._get_default_store()
    me = dist.get_rank()
    store.set(f"{_PREFIX}/{group_name}/{rank}", str(me))
    keys = [f"{_PREFIX}/{group_name}/{r}" for r in range(world_size)]
    store.wait(keys, datetime.timedelta(seconds=timeout_s))
    members = [int(store.get(k)) for k in keys]
    if members != sorted(members) or len(set(members)) != world_size:
        raise ValueError(
            f"group {group_name!r} ranks must follow the default group's "
            f"order, got global ranks {members}")
    group = dist.new_group(members, backend=backend,
                           use_local_synchronization=True) \
        if world_size > 1 else None
    device = (torch.device("cuda", torch.cuda.current_device())
              if backend == "nccl" else torch.device("cpu"))
    _GROUPS[group_name] = _Group(group_name, world_size, rank, members,
                                 group, device)


def _handle(group_name: str) -> _Group:
    h = _GROUPS.get(group_name)
    if h is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            f"process; call init_collective_group(world_size, rank) first")
    return h


def _copy(h: _Group, tensor, op: str) -> torch.Tensor:
    """A copy of ``tensor`` on the group's device; counts the call."""
    h.calls[op] += 1
    h.settle()
    return torch.as_tensor(tensor).to(h.device, copy=True)


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    h = _handle(group_name)
    out = _copy(h, tensor, "allreduce")
    reduce_op = _reduce_op(op)
    if h.world_size > 1:
        import torch.distributed as dist

        dist.all_reduce(out, op=reduce_op, group=h.group)
    return out


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    """The rank's ``np.array_split`` chunk (along dim 0) of the reduced
    tensor: chunks of ceil(n / W) rows first, then one shorter."""
    h = _handle(group_name)
    x = _copy(h, tensor, "reducescatter")
    reduce_op = _reduce_op(op)
    if h.world_size == 1:
        return x
    import torch.distributed as dist

    W = h.world_size
    sizes = [len(c) for c in np.array_split(np.arange(x.shape[0]), W)]
    c = max(sizes)
    padded = x.new_zeros((W * c,) + tuple(x.shape[1:]))
    start = 0
    for r, n in enumerate(sizes):
        padded[r * c:r * c + n] = x[start:start + n]
        start += n
    out = x.new_empty((c,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, padded, op=reduce_op, group=h.group)
    return out[:sizes[h.rank]]


def allgather(tensor, group_name: str = "default") -> List[torch.Tensor]:
    """Every rank's tensor, in group rank order."""
    h = _handle(group_name)
    x = _copy(h, tensor, "allgather")
    if h.world_size == 1:
        return [x]
    import torch.distributed as dist

    outs = [torch.empty_like(x) for _ in range(h.world_size)]
    dist.all_gather(outs, x, group=h.group)
    return outs


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    h = _handle(group_name)
    out = _copy(h, tensor, "broadcast")
    if h.world_size > 1:
        import torch.distributed as dist

        dist.broadcast(out, src=h.members[src_rank], group=h.group)
    return out


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send, buffered: it returns once the backend holds a
    copy, and the matching ``recv`` may run later."""
    h = _handle(group_name)
    if dst_rank == h.rank:
        raise ValueError("cannot send to self")
    import torch.distributed as dist

    buf = _copy(h, tensor, "send")
    work = dist.isend(buf, dst=h.members[dst_rank], group=h.group)
    h.pending.append((work, buf))


def recv(tensor, src_rank: int, group_name: str = "default"):
    """Point-to-point receive into ``tensor`` (in place where it is a
    tensor on the group's device, else into a copy copied back into a
    writeable numpy array); returns the received tensor."""
    h = _handle(group_name)
    if src_rank == h.rank:
        raise ValueError("cannot recv from self")
    import torch.distributed as dist

    h.calls["recv"] += 1
    inplace = isinstance(tensor, torch.Tensor) and tensor.device == h.device
    buf = tensor if inplace else torch.as_tensor(tensor).to(h.device,
                                                            copy=True)
    dist.recv(buf, src=h.members[src_rank], group=h.group)
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable:
        np.copyto(tensor, buf.cpu().numpy())   # mismatch raises
    return buf


def barrier(group_name: str = "default") -> None:
    h = _handle(group_name)
    h.calls["barrier"] += 1
    if h.world_size > 1:
        import torch.distributed as dist

        ids = [h.device.index] if h.device.type == "cuda" else None
        dist.barrier(group=h.group, device_ids=ids)


def group_stats(group_name: str = "default") -> Dict[str, object]:
    """The group's size, this member's rank, its members' global ranks
    and the calls it made, by op."""
    h = _handle(group_name)
    return {"world_size": h.world_size, "rank": h.rank,
            "members": list(h.members), "calls": dict(h.calls)}


def destroy_collective_group(group_name: str = "default") -> None:
    """Wait for this member's buffered sends, then leave the group."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    h = _GROUPS.pop(group_name, None)
    if h is None:
        return
    for work, _ in h.pending:
        work.wait()
    if h.group is not None:
        dist.destroy_process_group(h.group)
    c10d._get_default_store().delete_key(
        f"{_PREFIX}/{group_name}/{h.rank}")
