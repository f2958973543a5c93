"""Checkpoints: directory-backed, with a tensor-tree format of the port's
own (port of ``ray_tpu/train/checkpoint.py``).

A :class:`Checkpoint` is a handle to a directory; :class:`CheckpointManager`
keeps the top-k of them by a metric. The JAX package saves pytrees through
orbax; the port writes its own format: under ``<checkpoint>/<name>/``,
each tensor leaf as a raw little-endian file under its flat name (the
path of dict keys and tuple indices joined by ``/``, plus ``.bin``) and
an ``index.json`` holding the tree's structure, each tensor's dtype and
shape, and the plain Python leaves (ints, floats, strings). A JAX
checkpoint is not readable by the port, nor the reverse: weights cross
between the two through ``models/convert.py``.

Async saves (``save_pytree(..., blocking=False)``) run on a writer thread
so the step loop never waits on serialization; the completion fence
(``wait_pending``) runs at ack boundaries: before a checkpoint is pickled
(``__reduce__``), loaded, or admitted by ``CheckpointManager.register``.
A save writes into a temporary directory renamed into place at the end,
so a reader never sees a half-written tree.

Sharded trees (DTensor leaves, ``parallel/sharding.py``): every rank of
the mesh calls ``save_pytree``, and each writes only the blocks it owns
(its local block, where its coordinate on every replicated mesh dim is
0), one file per block named by its offsets; the index lists every block
of each leaf with its offset and shape. The ranks meet at barriers on a
gloo group of their own (so an async writer thread never shares a
communicator with the step loop's collectives); rank 0 writes the index
and renames the directory. A restore reads, for each leaf, only the
blocks that overlap the rank's target block: into the same placements,
other ones (``load_pytree(name, shardings, mesh=...)``), or, without
``shardings``, the whole tree in one process. No rank writes or reads a
whole tree unless it asks for one. The ranks must share the checkpoint's
filesystem.

The hazard JAX does not have: JAX donates the step's buffers and makes
new ones, while the port's step updates params and moments IN PLACE. So
a non-blocking save first snapshots every tensor with a device copy,
enqueued on the caller's current stream, where it runs before any later
launch on that stream can update the originals; the writer thread then
copies the snapshot to the host on a side stream that waits for an event
recorded after the snapshot, and never reads a live tensor. It copies
through two pinned staging buffers of 64 MiB: a copy into pageable memory
stages through the driver and stalls the step loop's kernel launches
while it runs.
"""

from __future__ import annotations

import heapq
import json
import os
import pickle
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel import sharding

_INDEX = "index.json"
_STAGE_BYTES = 64 << 20   # each of the writer's two pinned staging buffers
_FORMAT = "ray_tpu_torch.tree/1"
_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16,
    torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
    torch.bool)}


def _flatten(tree: Any, path: Tuple[str, ...] = ()
             ) -> Tuple[Any, List[Tuple[str, torch.Tensor]]]:
    """(the tree's JSON structure, its tensor leaves by flat name)."""
    if isinstance(tree, dict):
        node, leaves = {}, []
        for k, v in tree.items():
            if not isinstance(k, str) or any(
                    part in ("", ".", "..") for part in k.split("/")):
                raise TypeError(f"checkpoint dict keys must be names a "
                                f"file path can hold, got {k!r} at "
                                f"{'/'.join(path)!r}")
            node[k], sub = _flatten(v, path + (k,))
            leaves += sub
        return {"dict": node}, leaves
    if isinstance(tree, (list, tuple)):
        items, leaves = [], []
        for i, v in enumerate(tree):
            item, sub = _flatten(v, path + (str(i),))
            items.append(item)
            leaves += sub
        return {type(tree).__name__: items}, leaves
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if isinstance(tree, torch.Tensor):
        name = "/".join(path)
        node = {"tensor": name, "dtype": str(tree.dtype).removeprefix(
            "torch."), "shape": list(tree.shape)}
        if sharding.is_sharded(tree):
            node["blocks"] = _blocks(name, tree)
        return node, [(name, tree)]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}, []
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{'/'.join(path)!r}")


def _owned(t) -> bool:
    """Whether this rank writes its block of DTensor ``t``: its coordinate
    is 0 on every mesh dim that replicates ``t``."""
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, t.placements)
               if not p.is_shard())


def _block_file(name: str, offset) -> str:
    return f"{name}@{'_'.join(map(str, offset)) or 'scalar'}.bin"


def _blocks(name: str, t) -> List[Dict[str, Any]]:
    """Every distinct block of DTensor ``t`` (offset, shape, file), the
    same list on every rank."""
    if any(p.is_partial() for p in t.placements):
        raise ValueError(f"{name!r} is partial ({t.placements}): reduce it "
                         f"before saving")
    mesh = t.device_mesh
    seen, out = set(), []
    for coord in np.ndindex(*mesh.shape):
        off, shape = sharding.block_box(t.shape, mesh.shape, t.placements,
                                        coord)
        if off not in seen and all(shape):
            seen.add(off)
            out.append({"offset": list(off), "shape": list(shape),
                        "file": _block_file(name, off)})
    return out


_SAME_SIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _read_region(path: str, node: Dict[str, Any], box) -> torch.Tensor:
    """The part ``box`` ((offset, shape), global coordinates) of a saved
    leaf, read from the blocks that overlap it (memory-mapped: only the
    overlap is read)."""
    dtype = _DTYPES[node["dtype"]]
    off, shape = box
    out = torch.empty(shape, dtype=dtype)
    if "blocks" not in node:
        blocks = [{"offset": [0] * len(node["shape"]),
                   "shape": node["shape"], "file": node["tensor"] + ".bin"}]
    else:
        blocks = node["blocks"]
    item = torch.empty((), dtype=dtype).element_size()
    for b in blocks:
        lo = [max(o, bo) for o, bo in zip(off, b["offset"])]
        hi = [min(o + n, bo + bn) for o, n, bo, bn in
              zip(off, shape, b["offset"], b["shape"])]
        if any(h <= low for h, low in zip(hi, lo)):
            continue
        raw = np.memmap(os.path.join(path, b["file"]), mode="r",
                        dtype=_SAME_SIZE[item], shape=tuple(b["shape"]))
        src = tuple(slice(low - bo, h - bo)
                    for low, h, bo in zip(lo, hi, b["offset"]))
        dst = tuple(slice(low - o, h - o) for low, h, o in zip(lo, hi, off))
        out[dst] = torch.from_numpy(np.array(raw[src])).view(dtype)
        del raw
    return out


def _barrier_group():
    """A gloo group over every rank, for the sharded save's barriers; made
    once, collectively (every rank calls its first sharded save in the
    same order)."""
    global _GLOO
    if _GLOO is None:
        import torch.distributed as dist

        _GLOO = dist.new_group(backend="gloo")
    return _GLOO


_GLOO = None


def _placements_by_name(tree: Any, path: Tuple[str, ...] = ()
                        ) -> Dict[str, tuple]:
    """A tree of placements (tuples of ``Placement``) by flat name."""
    from torch.distributed.tensor import Placement

    if isinstance(tree, tuple) and tree and all(
            isinstance(p, Placement) for p in tree):
        return {"/".join(path): tree}
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    out: Dict[str, tuple] = {}
    for k, v in items:
        out.update(_placements_by_name(v, path + (str(k),)))
    return out


def _unflatten(node: Dict[str, Any], load) -> Any:
    if "dict" in node:
        return {k: _unflatten(v, load) for k, v in node["dict"].items()}
    if "tuple" in node:
        return tuple(_unflatten(v, load) for v in node["tuple"])
    if "list" in node:
        return [_unflatten(v, load) for v in node["list"]]
    if "tensor" in node:
        return load(node)
    return node["value"]


def _snapshot(tree: Any) -> Any:
    """A copy of every tensor leaf, enqueued on the current stream (so it
    reads the values as of now, before any later launch on that
    stream)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            if sharding.is_sharded(tree):
                return tree.detach().clone()
            return tree.detach().clone(memory_format=torch.contiguous_format)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def _write_host_leaf(path: str, t: torch.Tensor) -> int:
    """One host tensor as raw bytes; returns its size."""
    raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    with open(path, "wb") as f:
        f.write(raw.data)
    return raw.nbytes


def _write_cuda_leaf(path: str, t: torch.Tensor,
                     side: "torch.cuda.Stream",
                     stage: List[torch.Tensor]) -> int:
    """One CUDA tensor as raw bytes, through two pinned staging buffers:
    chunk i+1 is copied on ``side`` while chunk i is written. Copies into
    pinned memory are plain DMA; a copy into pageable memory would stage
    through the driver and stall the kernel launches of the step loop's
    thread while it runs. A buffer is refilled only after its last chunk
    was written (two iterations back, on this thread)."""
    with torch.cuda.stream(side):   # a strided leaf's copy included
        raw = t.contiguous().reshape(-1).view(torch.uint8)
    n = raw.numel()
    with open(path, "wb") as f:
        prev = None
        for i, off in enumerate(range(0, n, _STAGE_BYTES)):
            buf, m = stage[i % 2], min(_STAGE_BYTES, n - off)
            with torch.cuda.stream(side):
                buf[:m].copy_(raw[off:off + m], non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            if prev is not None:
                _drain_chunk(f, *prev)
            prev = (copied, buf, m)
        if prev is not None:
            _drain_chunk(f, *prev)
    return n


def _drain_chunk(f, copied: "torch.cuda.Event", buf: torch.Tensor,
                 m: int) -> None:
    copied.synchronize()
    f.write(buf[:m].numpy().data)


class Checkpoint:
    """A handle to a checkpoint directory."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._pending_lock = threading.Lock()
        # rt: guarded-by(_pending_lock) — in-flight async save threads
        self._pending: List[threading.Thread] = []
        self._pending_errors: List[BaseException] = []
        #: {"bytes", "write_s"} of the latest finished save_pytree
        self.last_save: Dict[str, float] = {}

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        """Small state dicts, serialized as a single file."""
        d = tempfile.mkdtemp(prefix="rtt_ckpt_")
        with open(os.path.join(d, "_dict_checkpoint.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "_dict_checkpoint.pkl"), "rb") as f:
            return pickle.load(f)

    def as_directory(self) -> str:
        return self.path

    # ---- tensor trees -------------------------------------------------------
    def _save_pytree_sync(self, tree: Any, name: str,
                          ready: Optional["torch.cuda.Event"] = None
                          ) -> None:
        """Write ``tree`` under ``name``. CUDA leaves are copied to the
        host on a side stream, after ``ready`` where given, else after the
        work queued so far on the caller's stream."""
        t0 = time.perf_counter()
        structure, leaves = _flatten(tree)
        names = [n for n, _ in leaves]
        if len(set(names)) != len(names):
            raise ValueError(f"two leaves share a flat name: {names}")
        io = {"ready": ready}
        if any(sharding.is_sharded(t) for _, t in leaves):
            nbytes = self._save_sharded(structure, leaves, name, io)
            self.last_save = {"bytes": nbytes,
                              "write_s": time.perf_counter() - t0}
            return
        final = os.path.join(self.path, name)
        tmp = tempfile.mkdtemp(prefix=f".{name}.tmp-", dir=self.path)
        nbytes = 0
        try:
            for flat, t in leaves:
                path = os.path.join(tmp, flat + ".bin")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                nbytes += self._write_leaf(path, t, io)
            with open(os.path.join(tmp, _INDEX), "w") as f:
                json.dump({"format": _FORMAT, "tree": structure}, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.last_save = {"bytes": nbytes,
                          "write_s": time.perf_counter() - t0}

    def _save_sharded(self, structure, leaves, name: str,
                      io: Dict[str, Any]) -> int:
        """Each rank writes the blocks it owns into a directory every rank
        names alike; rank 0 writes the index and renames it into place
        once all have written (barriers on a gloo group)."""
        import torch.distributed as dist

        for flat, t in leaves:
            if (sharding.is_sharded(t)
                    and t.device_mesh.size() != dist.get_world_size()):
                raise ValueError(f"{flat!r} lies on a mesh of "
                                 f"{t.device_mesh.size()} of the "
                                 f"{dist.get_world_size()} ranks: a sharded "
                                 f"save needs a mesh over every rank")
        group = _barrier_group()
        rank = dist.get_rank()
        final = os.path.join(self.path, name)
        tmp = os.path.join(self.path, f".{name}.tmp-sharded")
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        dist.barrier(group=group)
        nbytes = 0
        ok = True
        try:
            for flat, t in leaves:
                if sharding.is_sharded(t):
                    if not _owned(t):
                        continue
                    local = t.to_local()
                    off = sharding.block_box(
                        t.shape, t.device_mesh.shape, t.placements,
                        t.device_mesh.get_coordinate())[0]
                    if not local.numel():
                        continue
                    path = os.path.join(tmp, _block_file(flat, off))
                elif rank == 0:
                    local, path = t, os.path.join(tmp, flat + ".bin")
                else:
                    continue
                os.makedirs(os.path.dirname(path), exist_ok=True)
                nbytes += self._write_leaf(path, local, io)
        except BaseException:
            ok = False
            raise
        finally:
            # every rank reaches the barrier, so a failed writer cannot
            # leave the others waiting; rank 0 installs only a whole tree
            flags = torch.tensor([int(ok)])
            dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=group)
            if rank == 0 and int(flags):
                with open(os.path.join(tmp, _INDEX), "w") as f:
                    json.dump({"format": _FORMAT, "tree": structure}, f)
                shutil.rmtree(final, ignore_errors=True)
                os.replace(tmp, final)
            dist.barrier(group=group)
        if not int(flags):
            raise RuntimeError(f"another rank failed to write its blocks of "
                               f"{final}")
        return nbytes

    @staticmethod
    def _write_leaf(path: str, t: torch.Tensor, io: Dict[str, Any]) -> int:
        """One tensor's bytes to ``path``: a host tensor directly, a CUDA
        one through two pinned staging buffers on a side stream, made on
        the save's first CUDA leaf (``io``, one per save) to wait for
        ``io["ready"]`` where given, else for the work queued so far on
        the caller's stream."""
        if not t.is_cuda:
            return _write_host_leaf(path, t)
        if io.get("side") is None:
            torch.cuda.set_device(t.device)
            side = torch.cuda.Stream(t.device)
            if io.get("ready") is not None:
                side.wait_event(io["ready"])
            else:   # a blocking save of live tensors
                side.wait_stream(torch.cuda.current_stream(t.device))
            io["side"] = side
            io["stage"] = [torch.empty(_STAGE_BYTES, dtype=torch.uint8,
                                       pin_memory=True) for _ in range(2)]
        t.record_stream(io["side"])
        return _write_cuda_leaf(path, t, io["side"], io["stage"])

    def save_pytree(self, tree: Any, name: str = "state", *,
                    blocking: Optional[bool] = None) -> None:
        """Save a tree of dicts, tuples, lists, tensors and plain values
        under this checkpoint directory.

        ``blocking=False`` snapshots the tree on the device (a copy of
        every tensor, enqueued on the current stream) and hands the
        serialization to a writer thread: the call returns as soon as the
        copies are enqueued, and the caller may update the originals in
        place right after. The save is only durable after
        :meth:`wait_pending` (called automatically when the checkpoint is
        pickled, loaded, or registered with a ``CheckpointManager``).
        ``blocking=None``: inside a train session the trainer's
        ``FastPathConfig.async_checkpoint`` decides; standalone saves
        block, as JAX's do.
        """
        if blocking is None:
            from ray_tpu_torch.train import session as _session_mod

            live = _session_mod._session  # None outside a train loop
            blocking = (True if live is None
                        else not live.fast_path.async_checkpoint)
        os.makedirs(self.path, exist_ok=True)
        if blocking:
            self._save_pytree_sync(tree, name)
            return
        snap = _snapshot(tree)
        ready = None
        _, leaves = _flatten(snap)
        if any(sharding.is_sharded(t) for _, t in leaves):
            _barrier_group()   # collectively, here, not on the writer
        cuda = next((t for _, t in leaves if t.is_cuda), None)
        if cuda is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cuda.device))

        def writer():
            try:
                self._save_pytree_sync(snap, name, ready)
            except BaseException as e:  # noqa: BLE001 — re-raised at fence
                with self._pending_lock:
                    self._pending_errors.append(e)

        t = threading.Thread(target=writer, daemon=True,
                             name="rtt-ckpt-writer")
        with self._pending_lock:
            self._pending.append(t)
        t.start()

    def wait_pending(self, timeout: Optional[float] = None) -> None:
        """The completion fence: block until every async save of this
        checkpoint is durable; re-raise the first writer failure.
        Idempotent and cheap when nothing is pending."""
        with self._pending_lock:
            pending = list(self._pending)
        for t in pending:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"checkpoint save still running after {timeout}s "
                    f"({self.path})")
        with self._pending_lock:
            self._pending = [t for t in self._pending if t.is_alive()]
            if self._pending_errors:
                err = self._pending_errors[0]
                self._pending_errors = []
                raise err

    def load_pytree(self, name: str = "state", shardings: Any = None, *,
                    mesh=None, device: DeviceLike = None) -> Any:
        """The tree saved under ``name``, after any pending save of it.

        Without ``shardings`` every tensor comes back whole, on ``device``
        (``cuda`` unless asked), a sharded save's blocks assembled. With
        ``shardings`` (a tree of DTensor placements on ``mesh``'s compute
        mesh shaped like the saved tree, or a ``ShardingRules`` applied by
        path) each rank of ``mesh`` reads only the parts of the saved
        blocks that overlap its own block, whatever placements the tree
        was saved under, and gets DTensors; a leaf ``shardings`` leaves
        out (``None``) comes back whole."""
        if shardings is None:
            device = resolve_device(device)
        elif mesh is None or device is not None:
            raise ValueError("a sharded load takes the mesh (its device is "
                             "the mesh's), not a device")
        self.wait_pending()
        path = os.path.join(self.path, name)
        with open(os.path.join(path, _INDEX)) as f:
            index = json.load(f)
        if index.get("format") != _FORMAT:
            raise ValueError(f"{path} is not a {_FORMAT} checkpoint")
        if shardings is None:
            return _unflatten(index["tree"], lambda node: _read_region(
                path, node, ((0,) * len(node["shape"]), node["shape"])
            ).to(device))
        from torch.distributed.tensor import DTensor

        cmesh = sharding.compute_mesh(mesh)
        local_device = sharding._mesh_device(cmesh)
        if isinstance(shardings, sharding.ShardingRules):
            rules = shardings
            place_of = lambda node: sharding.placements(
                rules.spec_for(node["tensor"]), cmesh, len(node["shape"]))
        else:
            flat = _placements_by_name(shardings)
            place_of = lambda node: flat.get(node["tensor"])

        def load(node):
            places = place_of(node)
            shape = tuple(node["shape"])
            if places is None:
                return _read_region(path, node, ((0,) * len(shape), shape)
                                    ).to(local_device)
            box = sharding.block_box(shape, cmesh.shape, places,
                                     cmesh.get_coordinate())
            local = _read_region(path, node, box).to(local_device)
            return DTensor.from_local(
                local, cmesh, places, run_check=False, shape=shape,
                stride=sharding._contiguous_strides(shape))

        return _unflatten(index["tree"], load)

    def __reduce__(self):
        # pickling IS an ack boundary: the receiving process must never
        # observe a half-written directory
        self.wait_pending()
        return (Checkpoint, (self.path,))

    def __repr__(self):
        return f"Checkpoint({self.path})"


class CheckpointManager:
    """Top-k retention by score (JAX's ``CheckpointManager``).

    Each entry's score is computed ONCE at ``register`` and kept on a heap
    keyed (score, age): eviction pops the worst entry directly instead of
    re-scoring and re-sorting the full retention list per call.
    """

    def __init__(self, run_dir: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.run_dir = run_dir
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries: List[Dict] = []
        self._heap: List = []  # (rank_key, seq, entry) — min = evict first
        self._counter = 0
        os.makedirs(run_dir, exist_ok=True)

    def register(self, checkpoint: Checkpoint,
                 metrics: Dict[str, Any]) -> Checkpoint:
        """Move the checkpoint under the run dir and apply retention.

        Fences any in-flight async save first: an unfinished checkpoint is
        never admitted into the manager.
        """
        checkpoint.wait_pending()
        dest = os.path.join(self.run_dir, f"checkpoint_{self._counter:06d}")
        seq = self._counter
        self._counter += 1
        if checkpoint.path != dest:
            shutil.move(checkpoint.path, dest)
        entry = {"path": dest, "metrics": dict(metrics),
                 "score": self._score_value(metrics), "seq": seq}
        self._entries.append(entry)
        # keep-most-recent mode ranks purely by age (seq breaks the tie);
        # score mode ranks by the once-computed score
        rank = entry["score"] if self.score_attribute else 0.0
        heapq.heappush(self._heap, (rank, seq, entry))
        with open(os.path.join(dest, "_metrics.json"), "w") as f:
            json.dump(entry["metrics"], f, default=str)
        self._apply_retention()
        return Checkpoint(dest)

    def _score_value(self, metrics: Dict[str, Any]) -> float:
        v = metrics.get(self.score_attribute, 0.0) \
            if self.score_attribute else 0.0
        try:
            v = float(v)
        except (TypeError, ValueError):
            v = 0.0
        return v if self.score_order == "max" else -v

    def _apply_retention(self) -> None:
        if self.num_to_keep is None:
            return
        while len(self._entries) > self.num_to_keep and self._heap:
            # entries leave _entries only here, right after their pop, so
            # a popped entry is always live
            _, _, entry = heapq.heappop(self._heap)
            shutil.rmtree(entry["path"], ignore_errors=True)
            self._entries.remove(entry)

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        if self.score_attribute:
            entry = max(self._entries, key=lambda e: e["score"])
        else:
            entry = self._entries[-1]
        return Checkpoint(entry["path"])

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return Checkpoint(self._entries[-1]["path"]) if self._entries \
            else None
