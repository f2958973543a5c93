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
        return ({"tensor": name, "dtype": str(tree.dtype).removeprefix(
            "torch."), "shape": list(tree.shape)}, [(name, tree)])
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}, []
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{'/'.join(path)!r}")


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
        final = os.path.join(self.path, name)
        tmp = tempfile.mkdtemp(prefix=f".{name}.tmp-", dir=self.path)
        side = stage = None
        nbytes = 0
        try:
            for flat, t in leaves:
                path = os.path.join(tmp, flat + ".bin")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                if not t.is_cuda:
                    nbytes += _write_host_leaf(path, t)
                    continue
                if side is None:
                    torch.cuda.set_device(t.device)
                    side = torch.cuda.Stream(t.device)
                    if ready is not None:
                        side.wait_event(ready)
                    else:   # a blocking save of live tensors
                        side.wait_stream(torch.cuda.current_stream(t.device))
                    stage = [torch.empty(_STAGE_BYTES, dtype=torch.uint8,
                                         pin_memory=True) for _ in range(2)]
                t.record_stream(side)
                nbytes += _write_cuda_leaf(path, t, side, stage)
            with open(os.path.join(tmp, _INDEX), "w") as f:
                json.dump({"format": _FORMAT, "tree": structure}, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.last_save = {"bytes": nbytes,
                          "write_s": time.perf_counter() - t0}

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
        ``blocking=None`` blocks, as JAX's does outside a train session
        (the port has none).
        """
        os.makedirs(self.path, exist_ok=True)
        if blocking is None or blocking:
            self._save_pytree_sync(tree, name)
            return
        snap = _snapshot(tree)
        ready = None
        _, leaves = _flatten(snap)
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

    def load_pytree(self, name: str = "state", *,
                    device: DeviceLike = None) -> Any:
        """The tree saved under ``name``, its tensors on ``device``
        (``cuda`` unless asked), after any pending save of it."""
        device = resolve_device(device)
        self.wait_pending()
        path = os.path.join(self.path, name)
        with open(os.path.join(path, _INDEX)) as f:
            index = json.load(f)
        if index.get("format") != _FORMAT:
            raise ValueError(f"{path} is not a {_FORMAT} checkpoint")

        def load(node):
            raw = np.fromfile(os.path.join(path, node["tensor"] + ".bin"),
                              dtype=np.uint8)
            dtype = _DTYPES[node["dtype"]]
            t = (torch.from_numpy(raw).view(dtype) if raw.size
                 else torch.empty(0, dtype=dtype))
            return t.reshape(node["shape"]).to(device)

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
