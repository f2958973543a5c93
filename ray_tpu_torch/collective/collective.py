"""Named collective groups and weight shipments (port of
``ray_tpu/collective/collective.py``).

Members join a named group with (world_size, rank) and then issue the
group's collectives in the same program order, as JAX's host plane (and
NCCL) require. A group meets in one of three ways:

- a ``torch.distributed`` subgroup of the default process group, where
  the process has one (``bootstrap_torch_distributed``: a gang or a
  ``TorchTrainer`` worker): its members publish their global ranks in the
  default group's store under the group's name and create the subgroup
  among themselves, so ranks outside it need not call anything. Its ranks
  follow the default group's order, and its backend defaults to the
  default group's (nccl or gloo);
- a group DECLARED on the port's runtime (``create_collective_group``,
  JAX's named rendezvous actor ``cg:<name>``, which holds membership
  only): on the cluster backend each member is a process of its own, and
  the members build a gloo process group of their own, met through a
  TCP store that rank 0 opens and announces through the actor. This is
  JAX's host plane: tensors are reduced as CPU copies (NCCL would refuse
  two ranks on one card);
- on the local backend the members are threads of one process, which
  ``torch.distributed`` cannot hold as two ranks: an in-process plane
  (JAX's ``_ThreadPlane``) exchanges the members' tensors in memory and
  reduces them in rank order, which for two members is gloo's result.

JAX's semantics are kept: every op returns a new tensor (the input is not
changed); a group of one returns a copy; ``reducescatter`` returns the
rank's ``np.array_split`` chunk of the reduced tensor, which may be
uneven; ``send`` is buffered, so it returns before the matching ``recv``
runs; sending to oneself raises ``ValueError``. Tensors go to the group's
device (``cuda`` for nccl, else the CPU) and come back there; numpy
arrays are accepted. Unlike JAX's ring, ``allgather`` and ``broadcast``
need the same shape and dtype on every rank, as the backends do.

``ship_params`` / ``fetch_params`` move one params tree (the port's
nested dicts and lists of tensors or arrays) between two processes of the
cluster backend over ``cluster/stream.py``: the producer registers the
shipment as a stream source (a meta frame, then one frame per leaf;
leaves above ``inline_max_bytes`` travel through the node's object store
as oid frames) and the consumer subscribes and drains the pushed frames.
A leaf keeps its dtype (bfloat16 included); a CUDA leaf lands on the
consumer's current CUDA device. When the channel breaks mid-shipment
(chaos ``rpc.drop`` on ``stream_push``), the consumer falls back to ONE
``coll_param_reclaim`` RPC that replays the undelivered tail and drains
the rest, leaf-exact. A ticket is redeemed once. The leaves are read as
the pump takes them, so the producer must not change them until the
ticket is redeemed or cancelled (JAX's arrays are immutable; the RLHF
learner ships a fresh copy).
"""

from __future__ import annotations

import asyncio
import collections
import datetime
import itertools
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_PREFIX = "rt_collective"
_NAMESPACE = "_rt_collective"


def _reduce_op(op: str):
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
           "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"unknown reduce op {op!r}; one of {sorted(ops)}")
    return ops[op]


class _Done:
    """A send that completed when it was posted (the in-process plane)."""

    def is_completed(self) -> bool:
        return True

    def wait(self) -> None:
        pass


class _DistPlane:
    """A subgroup of the default process group."""

    def __init__(self, group, members: List[int]):
        self.group, self.members = group, members

    def allreduce(self, out: torch.Tensor, op: str) -> None:
        import torch.distributed as dist

        dist.all_reduce(out, op=_reduce_op(op), group=self.group)

    def broadcast(self, out: torch.Tensor, src: int) -> None:
        import torch.distributed as dist

        dist.broadcast(out, src=self.members[src], group=self.group)

    def allgather(self, x: torch.Tensor) -> List[torch.Tensor]:
        import torch.distributed as dist

        outs = [torch.empty_like(x) for _ in self.members]
        dist.all_gather(outs, x, group=self.group)
        return outs

    def reduce_scatter(self, out, padded, op: str) -> None:
        import torch.distributed as dist

        dist.reduce_scatter_tensor(out, padded, op=_reduce_op(op),
                                   group=self.group)

    def isend(self, buf: torch.Tensor, dst: int):
        import torch.distributed as dist

        return dist.isend(buf, dst=self.members[dst], group=self.group)

    def recv(self, buf: torch.Tensor, src: int) -> None:
        import torch.distributed as dist

        dist.recv(buf, src=self.members[src], group=self.group)

    def barrier(self, device: torch.device) -> None:
        import torch.distributed as dist

        ids = [device.index] if device.type == "cuda" else None
        dist.barrier(group=self.group, device_ids=ids)

    def destroy(self) -> None:
        import torch.distributed as dist

        if self.group is not None:
            dist.destroy_process_group(self.group)


class _GlooPlane:
    """A gloo process group of a declared group's member processes."""

    def __init__(self, pg, store):
        self.pg, self.store = pg, store   # the store outlives the group

    def allreduce(self, out: torch.Tensor, op: str) -> None:
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        opts.reduceOp = _reduce_op(op)
        self.pg.allreduce([out], opts).wait()

    def broadcast(self, out: torch.Tensor, src: int) -> None:
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = src, 0
        self.pg.broadcast([out], opts).wait()

    def allgather(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = [torch.empty_like(x) for _ in range(self.pg.size())]
        self.pg.allgather([outs], [x]).wait()
        return outs

    def isend(self, buf: torch.Tensor, dst: int):
        return self.pg.send([buf], dst, 0)

    def recv(self, buf: torch.Tensor, src: int) -> None:
        self.pg.recv([buf], src, 0).wait()

    def barrier(self, device: torch.device) -> None:
        self.pg.barrier().wait()

    def destroy(self) -> None:
        self.pg = None


class _ThreadGroupState:
    """What the members (threads) of one in-process group share."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.cond = threading.Condition()
        self.rounds: Dict[int, Dict[str, Any]] = {}   # rt: guarded-by(cond)
        self.boxes: Dict[Tuple[int, int], collections.deque] = \
            collections.defaultdict(collections.deque)  # rt: guarded-by(cond)
        self.left = 0                                  # rt: guarded-by(cond)


_thread_lock = threading.Lock()
_thread_groups: Dict[str, _ThreadGroupState] = {}  # rt: guarded-by(_thread_lock)


class _ThreadPlane:
    """A member's view of an in-process group (the local backend): each
    collective is a round in which every member deposits its tensor and
    reads all of them once all have arrived; results are computed from
    the deposits in rank order."""

    def __init__(self, name: str, world_size: int, rank: int,
                 timeout_s: float):
        with _thread_lock:
            st = _thread_groups.get(name)
            if st is None or st.world_size != world_size:
                st = _thread_groups[name] = _ThreadGroupState(world_size)
        self.name, self.state, self.rank = name, st, rank
        self.timeout_s = timeout_s
        self.seq = 0

    def _exchange(self, value) -> List[Any]:
        st, seq = self.state, self.seq
        self.seq += 1
        with st.cond:
            rnd = st.rounds.setdefault(seq, {"vals": {}, "read": 0})
            rnd["vals"][self.rank] = value
            st.cond.notify_all()
            if not st.cond.wait_for(
                    lambda: len(rnd["vals"]) == st.world_size,
                    timeout=self.timeout_s):
                raise TimeoutError(
                    f"collective group {self.name!r}: {len(rnd['vals'])} of "
                    f"{st.world_size} members reached op {seq} within "
                    f"{self.timeout_s} s")
            vals = [rnd["vals"][r] for r in range(st.world_size)]
            rnd["read"] += 1
            if rnd["read"] == st.world_size:
                del st.rounds[seq]
        return vals

    def allreduce(self, out: torch.Tensor, op: str) -> None:
        fn = {"sum": torch.add, "prod": torch.mul, "min": torch.minimum,
              "max": torch.maximum}
        if op not in fn:
            raise ValueError(f"unknown reduce op {op!r}; one of {sorted(fn)}")
        vals = self._exchange(out.clone())
        acc = vals[0]
        for v in vals[1:]:
            acc = fn[op](acc, v)
        out.copy_(acc)

    def broadcast(self, out: torch.Tensor, src: int) -> None:
        out.copy_(self._exchange(out.clone())[src])

    def allgather(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [v.clone() for v in self._exchange(x.clone())]

    def isend(self, buf: torch.Tensor, dst: int):
        st = self.state
        with st.cond:
            st.boxes[(self.rank, dst)].append(buf.clone())
            st.cond.notify_all()
        return _Done()

    def recv(self, buf: torch.Tensor, src: int) -> None:
        st, box = self.state, (src, self.rank)
        with st.cond:
            if not st.cond.wait_for(lambda: st.boxes[box],
                                    timeout=self.timeout_s):
                raise TimeoutError(
                    f"collective group {self.name!r}: nothing from rank "
                    f"{src} within {self.timeout_s} s")
            buf.copy_(st.boxes[box].popleft())

    def barrier(self, device: torch.device) -> None:
        self._exchange(None)

    def destroy(self) -> None:
        with _thread_lock, self.state.cond:
            self.state.left += 1
            if self.state.left == self.state.world_size \
                    and _thread_groups.get(self.name) is self.state:
                del _thread_groups[self.name]


class _Group:
    def __init__(self, name: str, world_size: int, rank: int,
                 members: List, plane, device: torch.device, actor=None):
        self.name, self.world_size, self.rank = name, world_size, rank
        self.members, self.plane, self.device = members, plane, device
        self.actor = actor          # the declared group's rendezvous actor
        self.calls: Dict[str, int] = collections.Counter()
        self.pending: list = []     # (work, buffer) of buffered sends

    def settle(self) -> None:
        """Forget the sends the backend has completed."""
        self.pending = [(w, b) for w, b in self.pending
                        if not w.is_completed()]


# groups whose plane is process-wide (subgroups, gloo groups)
_GROUPS: Dict[str, _Group] = {}
# in-process groups: each member thread holds its own view
_local = threading.local()


def _thread_handles() -> Dict[str, _Group]:
    if not hasattr(_local, "groups"):
        _local.groups = {}
    return _local.groups


# ---------------------------------------------------------------------------
# groups declared on the runtime
# ---------------------------------------------------------------------------


class _CollectiveGroupActor:
    """Rendezvous actor: membership only (JAX's). Tensors never pass
    through it; ``stats()`` shows it."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.members: Dict[int, str] = {}
        self._member_event = asyncio.Event()
        self._register_calls = 0

    async def register(self, rank: int, address: str) -> Dict[int, str]:
        self._register_calls += 1
        self.members[rank] = address
        if len(self.members) == self.world_size:
            self._member_event.set()
        await self._member_event.wait()
        return dict(self.members)

    async def stats(self) -> Dict[str, int]:
        return {"register_calls": self._register_calls, "payload_bytes": 0}


def _runtime_backend():
    from ray_tpu_torch.core.worker import global_worker

    return global_worker()._require_backend()


def _is_cluster(backend) -> bool:
    return hasattr(backend, "server") and hasattr(backend, "io")


def create_collective_group(world_size: int,
                            group_name: str = "default") -> None:
    """Declare the group on the port's runtime (idempotent); its members
    still call ``init_collective_group``. Raises the runtime's "not
    initialized" error without one."""
    import ray_tpu_torch as rt

    _runtime_backend()
    rt.remote(max_concurrency=max(world_size * 2, 8))(
        _CollectiveGroupActor).options(
        name=f"cg:{group_name}", namespace=_NAMESPACE, num_cpus=0,
        get_if_exists=True, lifetime="detached").remote(world_size)


def _join_declared(world_size: int, rank: int, group_name: str,
                   timeout_s: float) -> None:
    """Join ``group_name`` as a member of a group declared on the
    runtime: a gloo group of processes on the cluster backend, the
    in-process plane on the local one."""
    import torch.distributed as dist

    import ray_tpu_torch as rt

    create_collective_group(world_size, group_name)
    actor = rt.get_actor(f"cg:{group_name}", namespace=_NAMESPACE)
    backend = _runtime_backend()
    cpu = torch.device("cpu")
    if not _is_cluster(backend):
        plane = _ThreadPlane(group_name, world_size, rank, timeout_s)
        members = rt.get(actor.register.remote(rank, f"local:{rank}"),
                         timeout=timeout_s)
        _thread_handles()[group_name] = _Group(
            group_name, world_size, rank,
            [members[r] for r in range(world_size)], plane, cpu, actor)
        return
    host = backend.address.rsplit(":", 1)[0]
    timeout = datetime.timedelta(seconds=timeout_s)
    store = None
    if rank == 0:
        store = dist.TCPStore(host, 0, world_size, True, timeout=timeout,
                              wait_for_workers=False)
        address = f"{host}:{store.port}"
    else:
        address = host
    members = rt.get(actor.register.remote(rank, address),
                     timeout=timeout_s)
    if store is None:
        h, port = members[0].rsplit(":", 1)
        store = dist.TCPStore(h, int(port), world_size, False,
                              timeout=timeout)
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=host)]
    pg = dist.ProcessGroupGloo(dist.PrefixStore(f"{group_name}/", store),
                               rank, world_size, opts)
    _GROUPS[group_name] = _Group(
        group_name, world_size, rank,
        [members[r] for r in range(world_size)], _GlooPlane(pg, store), cpu,
        actor)


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default", backend: str = None,
                          timeout_s: float = 60.0) -> None:
    """Join ``group_name`` as its ``rank`` of ``world_size``: a subgroup
    of the default process group where this process has one (``backend``
    defaults to the default group's), else a group declared on the
    port's runtime (module docstring)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    if not 0 <= rank < world_size:
        raise ValueError(
            f"rank {rank} out of range for world_size {world_size}")
    if not dist.is_initialized():
        from ray_tpu_torch.core.worker import global_worker

        if not global_worker().connected:
            raise RuntimeError(
                "collective groups need the default process group "
                "(bootstrap_torch_distributed) or the port's runtime "
                "(ray_tpu_torch.init())")
        _join_declared(world_size, rank, group_name, timeout_s)
        return
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
                                 _DistPlane(group, members), device)


def _handle(group_name: str) -> _Group:
    h = _thread_handles().get(group_name) or _GROUPS.get(group_name)
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
    _reduce_op(op)
    if h.world_size > 1:
        h.plane.allreduce(out, op)
    return out


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    """The rank's ``np.array_split`` chunk (along dim 0) of the reduced
    tensor: chunks of ceil(n / W) rows first, then one shorter."""
    h = _handle(group_name)
    x = _copy(h, tensor, "reducescatter")
    _reduce_op(op)
    if h.world_size == 1:
        return x
    W = h.world_size
    sizes = [len(c) for c in np.array_split(np.arange(x.shape[0]), W)]
    if not isinstance(h.plane, _DistPlane):
        # the host planes reduce the whole tensor and keep their chunk
        h.plane.allreduce(x, op)
        start = sum(sizes[:h.rank])
        return x[start:start + sizes[h.rank]].clone()
    c = max(sizes)
    padded = x.new_zeros((W * c,) + tuple(x.shape[1:]))
    start = 0
    for r, n in enumerate(sizes):
        padded[r * c:r * c + n] = x[start:start + n]
        start += n
    out = x.new_empty((c,) + tuple(x.shape[1:]))
    h.plane.reduce_scatter(out, padded, op)
    return out[:sizes[h.rank]]


def allgather(tensor, group_name: str = "default") -> List[torch.Tensor]:
    """Every rank's tensor, in group rank order."""
    h = _handle(group_name)
    x = _copy(h, tensor, "allgather")
    if h.world_size == 1:
        return [x]
    return h.plane.allgather(x)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    h = _handle(group_name)
    out = _copy(h, tensor, "broadcast")
    if h.world_size > 1:
        h.plane.broadcast(out, src_rank)
    return out


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send, buffered: it returns once the backend holds a
    copy, and the matching ``recv`` may run later."""
    h = _handle(group_name)
    if dst_rank == h.rank:
        raise ValueError("cannot send to self")
    buf = _copy(h, tensor, "send")
    h.pending.append((h.plane.isend(buf, dst_rank), buf))


def recv(tensor, src_rank: int, group_name: str = "default"):
    """Point-to-point receive into ``tensor`` (in place where it is a
    tensor on the group's device, else into a copy copied back into a
    writeable numpy array); returns the received tensor."""
    h = _handle(group_name)
    if src_rank == h.rank:
        raise ValueError("cannot recv from self")
    h.calls["recv"] += 1
    inplace = isinstance(tensor, torch.Tensor) and tensor.device == h.device
    buf = tensor if inplace else torch.as_tensor(tensor).to(h.device,
                                                            copy=True)
    h.plane.recv(buf, src_rank)
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable:
        np.copyto(tensor, buf.cpu().numpy())   # mismatch raises
    return buf


def barrier(group_name: str = "default") -> None:
    h = _handle(group_name)
    h.calls["barrier"] += 1
    if h.world_size > 1:
        h.plane.barrier(h.device)


def group_stats(group_name: str = "default") -> Dict[str, object]:
    """The group's size, this member's rank, its members (global ranks,
    or the addresses a declared group's members registered) and the
    calls it made, by op."""
    h = _handle(group_name)
    return {"world_size": h.world_size, "rank": h.rank,
            "members": list(h.members), "calls": dict(h.calls)}


def destroy_collective_group(group_name: str = "default") -> None:
    """Wait for this member's buffered sends, then leave the group. From
    a process that never joined it, a declared group's rendezvous actor
    is killed (JAX's)."""
    h = _thread_handles().pop(group_name, None) \
        or _GROUPS.pop(group_name, None)
    if h is None:
        _kill_declared(group_name)
        return
    for work, _ in h.pending:
        work.wait()
    h.plane.destroy()
    if isinstance(h.plane, _DistPlane):
        from torch.distributed import distributed_c10d as c10d

        c10d._get_default_store().delete_key(
            f"{_PREFIX}/{group_name}/{h.rank}")


def _kill_declared(group_name: str) -> None:
    from ray_tpu_torch.core.worker import global_worker

    if not global_worker().connected:
        return
    import ray_tpu_torch as rt

    try:
        rt.kill(rt.get_actor(f"cg:{group_name}", namespace=_NAMESPACE))
    except ValueError:
        pass


# ---------------------------------------------------------------------------
# weight shipments over the push-stream plane
# ---------------------------------------------------------------------------

_PARAM_RPC = "coll_param_reclaim"

_ship_lock = threading.Lock()
_ship_ids = itertools.count()  # rt: guarded-by(_ship_lock)

#: producer-side transfer receipts, keyed by sid: the pump stamps its
#: first and last ``take`` so the RLHF flight recorder can join the pump
#: wall with the consumer's fetch wall and the engine's swap barrier
_receipts: "OrderedDict[str, Dict[str, Any]]" = \
    OrderedDict()  # rt: guarded-by(_ship_lock)


class _Leaf:
    """A leaf's place in a flattened tree."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _flatten(tree, leaves: List[Any]):
    """The tree's structure with each leaf replaced by its ``_Leaf``;
    appends the leaves in order."""
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_flatten(v, leaves) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    leaves.append(tree)
    return _Leaf(len(leaves) - 1)


def _unflatten(struct, leaves: List[Any]):
    if isinstance(struct, dict):
        return {k: _unflatten(v, leaves) for k, v in struct.items()}
    if isinstance(struct, (list, tuple)):
        out = [_unflatten(v, leaves) for v in struct]
        return out if isinstance(struct, list) else tuple(out)
    return leaves[struct.i]


def _nbytes(leaf) -> int:
    n = getattr(leaf, "nbytes", None)
    return int(n) if isinstance(n, int) else 0


class _ParamsPump:
    """Finite list pump for one shipment (the stream-source contract).
    Stamps its receipt on every ``take``: the push path and the reclaim
    fallback both drain through here. The push path takes one leaf at a
    time, so each leaf's frame goes out as soon as it is encoded and the
    consumer decodes it while the producer encodes the next."""

    def __init__(self, items: List[Any],
                 receipt: Optional[Dict[str, Any]] = None):
        self._items = list(items)
        self._pos = 0
        self._receipt = receipt

    async def take(self, n: int) -> Tuple[List[Any], bool]:
        out = self._items[self._pos:self._pos + 1]   # one leaf a take
        self._pos += len(out)
        done = self._pos >= len(self._items)
        if self._receipt is not None and out:
            now = time.time()
            with _ship_lock:
                self._receipt.setdefault("t_pump0", now)
                self._receipt["t_pump1"] = now
                self._receipt["frames_taken"] = \
                    self._receipt.get("frames_taken", 0) + len(out)
                if done:
                    self._receipt["pump_done"] = True
        return out, done

    def close(self) -> None:
        self._items = []


def shipment_receipt(sid: str) -> Optional[Dict[str, Any]]:
    """Producer-side transfer receipt for one shipment: frames pumped and
    the pump wall (first ``take`` to last). Outlives the shipment's
    deregistration, so it can be read after the consumer redeemed the
    ticket; the registry keeps the last 32."""
    with _ship_lock:
        r = _receipts.get(sid)
        if r is None:
            return None
        out = dict(r)
    if "t_pump0" in out and "t_pump1" in out:
        out["pump_wall_s"] = round(out["t_pump1"] - out["t_pump0"], 6)
    return out


def _params_backend():
    backend = _runtime_backend()
    if not _is_cluster(backend):
        raise RuntimeError(
            "ship_params/fetch_params need the cluster backend (a "
            "ray_tpu_torch.init() session; the local backend has no stream "
            "transport)")
    return backend


def _ensure_reclaim_rpc(backend) -> None:
    with _ship_lock:
        if getattr(backend, "_rt_param_reclaim", False):
            return

        async def _rpc(p):
            return await _reclaim_shipment(p["sid"], int(p["delivered"]))

        backend.server.register(_PARAM_RPC, _rpc)
        backend._rt_param_reclaim = True


async def _reclaim_shipment(sid: str, delivered: int) -> Dict[str, Any]:
    """Producer-side pull fallback: the pushed-but-undelivered tail, then
    the rest of the pump, in one reply, each leaf encoded as a push frame
    encodes it (leaves above the inline size through the object store: a
    reply frame holds at most ``rpc.MAX_FRAME`` bytes, and a 1b policy is
    more). Runs on the producer's loop."""
    from ray_tpu_torch.cluster import stream as rt_stream

    items, known, err = await rt_stream.drain_source(sid, delivered)
    if err is not None:
        return {"error": repr(err)}
    if not known:
        return {"error": f"shipment {sid!r} unknown "
                         f"(already fetched or cancelled)"}
    backend = _params_backend()
    return {"wire": [await rt_stream.encode_item(backend, it)
                     for it in items], "done": True}


def ship_params(params: Any, *, sid: Optional[str] = None) -> Dict[str, Any]:
    """Register one params tree for streaming to a consumer; returns the
    shipment TICKET ``{"address", "sid", "n_leaves", "nbytes"}``, which
    the caller hands to the consumer (an actor-call argument) to redeem
    with :func:`fetch_params`. The leaves never ride that call: they
    travel as push frames when the consumer subscribes. A ticket is
    redeemable ONCE; an unredeemed shipment is dropped with
    :func:`cancel_shipment`. Leaves above the stream's inline size go
    through the node's object store, and each such frame is freed as
    soon as the consumer has decoded it (the fallback frees the pushed
    frames it replaces), so a shipment leaves nothing in the store."""
    from ray_tpu_torch.cluster import stream as rt_stream

    backend = _params_backend()
    _ensure_reclaim_rpc(backend)
    leaves: List[Any] = []
    struct = _flatten(params, leaves)
    leaves = [leaf.detach() if isinstance(leaf, torch.Tensor) else leaf
              for leaf in leaves]
    nbytes = sum(_nbytes(leaf) for leaf in leaves)
    if sid is None:
        with _ship_lock:
            sid = f"params-{os.getpid()}-{next(_ship_ids)}"
    cuda = [i for i, leaf in enumerate(leaves)
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
    meta = {"treedef": struct, "n_leaves": len(leaves), "nbytes": nbytes,
            "cuda_leaves": cuda}
    receipt = {"sid": sid, "t_ship": time.time(), "nbytes": nbytes,
               "n_leaves": len(leaves)}
    with _ship_lock:
        _receipts[sid] = receipt
        while len(_receipts) > 32:  # bound the receipt registry
            _receipts.popitem(last=False)
    rt_stream.register_source(sid, _ParamsPump([meta] + leaves,
                                               receipt=receipt),
                              free_frames=True)
    return {"address": backend.address, "sid": sid,
            "n_leaves": len(leaves), "nbytes": nbytes}


def cancel_shipment(ticket: Dict[str, Any]) -> None:
    """Drop an unredeemed shipment (producer side); frames it pushed are
    freed."""
    from ray_tpu_torch.cluster import stream as rt_stream

    rt_stream.unregister_source(ticket["sid"])


async def _fetch_async(backend, address: str, sid: str,
                       window: Optional[int]) -> Tuple[List[Any], str, int]:
    from ray_tpu_torch.cluster import stream as rt_stream
    from ray_tpu_torch.cluster.rpc import ChannelBroken

    items: List[Any] = []
    transport = "push"
    rpcs = 1  # the subscribe (or the reclaim, on the no-push path)
    ch = None
    done = False
    try:
        ch = await rt_stream.subscribe(backend, address, sid, window)
    except Exception:  # noqa: BLE001 — no push service: pull instead
        ch = None
    if ch is None:
        transport = "pull"
    else:
        try:
            while True:
                item, d = await rt_stream.take_decoded(backend, ch,
                                                       free=True)
                if d:
                    done = True
                    break
                items.append(item)
        except ChannelBroken:
            # frames still parked in the channel are DISCARDED: the
            # producer's replay buffer holds every unacked item, and the
            # reclaim below filters by the delivered count (and frees
            # the discarded frames)
            transport = "fallback"
    if not done:
        if ch is not None:
            ch.close()
            ch = None
        client = await backend._pool.get(address)
        reply = await client.call(
            _PARAM_RPC, {"sid": sid, "delivered": len(items)},
            timeout=120.0)
        rpcs += 1
        if reply.get("error"):
            raise RuntimeError(f"param shipment {sid!r} failed: "
                               f"{reply['error']}")
        for wire in reply["wire"]:
            item, _ = await rt_stream.take_decoded_wire(backend, wire,
                                                        free=True)
            items.append(item)
    if ch is not None:
        ch.close()
    return items, transport, rpcs


def fetch_params(ticket: Dict[str, Any], *,
                 window: Optional[int] = None
                 ) -> Tuple[Any, Dict[str, Any]]:
    """Redeem a :func:`ship_params` ticket: subscribe to the producer's
    shipment, drain it (oid frames resolve through the object store;
    same-node reads map the producer's bytes), rebuild the tree, CUDA
    leaves on this process's current CUDA device. Falls back to the
    one-RPC reclaim on a broken channel, leaf-exact. Returns ``(params,
    info)``; info carries ``transport`` (push, fallback or pull),
    ``rpcs``, ``nbytes``, ``n_leaves``, ``oid_leaves``, ``inline_leaves``
    and ``fetch_wall_s``."""
    from ray_tpu_torch.cluster import stream as rt_stream

    backend = _params_backend()
    t_fetch0 = time.perf_counter()
    items, transport, rpcs = backend.io.run(
        _fetch_async(backend, ticket["address"], ticket["sid"], window))
    if not items or not isinstance(items[0], dict) \
            or "treedef" not in items[0]:
        raise RuntimeError(
            f"param shipment {ticket['sid']!r}: missing meta frame")
    meta, leaves = items[0], items[1:]
    if len(leaves) != meta["n_leaves"]:
        raise RuntimeError(
            f"param shipment {ticket['sid']!r}: {len(leaves)} leaves "
            f"arrived, expected {meta['n_leaves']} (transport drop?)")
    if meta["cuda_leaves"]:
        dev = torch.device("cuda", torch.cuda.current_device())
        for i in meta["cuda_leaves"]:
            leaves[i] = leaves[i].to(dev)
    fetch_wall_s = time.perf_counter() - t_fetch0
    rt_stream.observe_request_rpcs(transport, rpcs)
    params = _unflatten(meta["treedef"], leaves)
    # leaves above the inline threshold travelled as oid frames on the
    # push path (the stream's encode rule)
    thresh = rt_stream.inline_max_bytes()
    oid_leaves = sum(1 for leaf in leaves if _nbytes(leaf) > thresh)
    return params, {"transport": transport, "rpcs": rpcs,
                    "nbytes": meta["nbytes"],
                    "n_leaves": meta["n_leaves"],
                    "oid_leaves": oid_leaves,
                    "inline_leaves": meta["n_leaves"] - oid_leaves,
                    "fetch_wall_s": round(fetch_wall_s, 6)}
