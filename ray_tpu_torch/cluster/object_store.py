"""Per-node shared-memory object store (the plasma equivalent).

Reference analog: ``src/ray/object_manager/plasma/`` — a per-node store of
immutable sealed objects that every process on the node maps read-only with
zero copies. Redesign: instead of a store daemon owning one dlmalloc arena
with fd-passing (``fling.cc``), each object is a file in a tmpfs session
directory (``/dev/shm/torch_session_<id>/``): creators write+seal, readers mmap
read-only. The kernel page cache IS the shared arena; the raylet tracks
metadata/usage and performs eviction+spilling. This removes the single-daemon
allocation bottleneck and keeps crash cleanup trivial (rm -rf of the session
dir), at the cost of per-object mmap granularity — the right trade for ML
workloads with few large tensors.

Buffers returned by ``read`` point directly into the mapping; deserialized
numpy arrays alias that memory (pickle-5 zero-copy path).
"""

from __future__ import annotations

import mmap
import os
import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID

# Map every page of an object at mmap time: one kernel pass instead of a
# fault per 4 KiB page on first touch (a 2.2 GB object is written and
# read onto the card several times faster on an H100 host:
# ``python -m ray_tpu_torch.tools.ship_stages``, PERF.md).
_POPULATE = getattr(mmap, "MAP_POPULATE", 0)

SHM_ROOT = "/dev/shm"
# Session names (and so the shm directories under SHM_ROOT) of this
# runtime start with this prefix; JAX's start with "session_", so neither
# runtime's sessions are the other's.
SESSION_PREFIX = "torch_session_"


class PlasmaStore:
    """Create/seal/read/delete objects in the node's shm session dir."""

    def __init__(self, session_name: str, create_dir: bool = True):
        self.dir = os.path.join(SHM_ROOT, session_name)
        if create_dir:
            os.makedirs(self.dir, exist_ok=True)
        self._maps: Dict[ObjectID, Tuple[mmap.mmap, memoryview]] = {}
        self._lock = threading.Lock()

    def _path(self, oid: ObjectID) -> str:
        return os.path.join(self.dir, oid.hex())

    def _tmp_path(self, oid: ObjectID) -> str:
        return self._path(oid) + ".building"

    def create(self, oid: ObjectID, size: int) -> memoryview:
        """A writable buffer; call ``seal`` when filled."""
        path = self._tmp_path(oid)
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, max(size, 1))
            mm = mmap.mmap(fd, max(size, 1),
                           flags=mmap.MAP_SHARED | _POPULATE)
        finally:
            os.close(fd)
        with self._lock:
            self._maps[oid] = (mm, memoryview(mm)[:size])
        return memoryview(mm)[:size]

    def seal(self, oid: ObjectID) -> int:
        """Atomically publish the object; returns its size."""
        os.rename(self._tmp_path(oid), self._path(oid))
        with self._lock:
            entry = self._maps.get(oid)
        return len(entry[1]) if entry else os.path.getsize(self._path(oid))

    def contains(self, oid: ObjectID) -> bool:
        return os.path.exists(self._path(oid))

    def read(self, oid: ObjectID) -> Optional[memoryview]:
        """Zero-copy read-only view, or None if absent."""
        with self._lock:
            entry = self._maps.get(oid)
            if entry is not None:
                return entry[1]
        path = self._path(oid)
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            return None
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size, flags=mmap.MAP_SHARED | _POPULATE,
                           prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        view = memoryview(mm)
        with self._lock:
            self._maps[oid] = (mm, view)
        return view

    def write_whole(self, oid: ObjectID, payload: bytes) -> int:
        buf = self.create(oid, len(payload))
        buf[:] = payload
        return self.seal(oid)

    def release(self, oid: ObjectID) -> None:
        """Drop this process's map of the object; the object stays."""
        with self._lock:
            entry = self._maps.pop(oid, None)
        if entry is not None:
            try:
                entry[1].release()
                entry[0].close()
            except BufferError:
                pass  # readers still hold views: unmapped when they go

    def delete(self, oid: ObjectID) -> None:
        self.release(oid)
        for path in (self._path(oid), self._tmp_path(oid)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    def used_bytes(self) -> int:
        total = 0
        try:
            for name in os.listdir(self.dir):
                try:
                    total += os.path.getsize(os.path.join(self.dir, name))
                except FileNotFoundError:
                    pass
        except FileNotFoundError:
            pass
        return total

    def list_objects(self) -> List[ObjectID]:
        out = []
        try:
            for name in os.listdir(self.dir):
                if not name.endswith(".building"):
                    try:
                        out.append(ObjectID.from_hex(name))
                    except ValueError:
                        pass
        except FileNotFoundError:
            pass
        return out

    def destroy(self) -> None:
        with self._lock:
            for mm, view in self._maps.values():
                try:
                    view.release()
                    mm.close()
                except BufferError:
                    pass
            self._maps.clear()
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)
