"""Native runtime core with pure-Python fallback.

``from ray_tpu_torch._native import native`` gives the compiled ``rt_native``
module (building it on first use) or ``None`` when no toolchain exists;
the helpers below always work, falling back to Python implementations.
This mirrors the reference's split: C++ runtime primitives
(``memory_monitor.h``, chunked-object crc, gcs store client) under a
Python control plane.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional, Tuple

native = None
_tried = False


def _load():
    global native, _tried
    if _tried:
        return native
    _tried = True
    try:
        from ray_tpu_torch._native.build import build

        build()
        import importlib.util

        from ray_tpu_torch._native.build import SO

        spec = importlib.util.spec_from_file_location("rt_native", SO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        native = mod
    except Exception:  # noqa: BLE001 — no toolchain: Python fallbacks below
        native = None
    return native


def crc32c(data, init: int = 0) -> int:
    """Castagnoli CRC of a bytes-like (native) or crc32 fallback. Anything
    that crosses a host boundary must carry ``checksum_kind()`` alongside the
    value and verify with ``checksum(data, kind)`` — a mixed cluster (one
    host with a toolchain, one without) produces different algorithms."""
    n = _load()
    if n is not None:
        return n.crc32c(data, init)
    return zlib.crc32(data, init) & 0xFFFFFFFF


def checksum_kind() -> str:
    return "crc32c" if _load() is not None else "crc32"


_CRC32C_POLY = 0x82F63B78  # reflected Castagnoli
_crc32c_table: Optional[List[int]] = None


def _sw_table() -> List[int]:
    global _crc32c_table
    if _crc32c_table is None:
        t = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (_CRC32C_POLY if c & 1 else 0)
            t.append(c)
        _crc32c_table = t
    return _crc32c_table


def crc32c_sw(data, init: int = 0) -> int:
    """Castagnoli CRC that is ALWAYS Castagnoli: native when available,
    pure-Python table otherwise. Unlike :func:`crc32c` this never silently
    switches algorithm with toolchain availability. The WAL replayers use
    it to verify native-written frames on toolchain-less hosts; it is far
    too slow (GIL-bound byte loop) for write paths or multi-MB payloads —
    those use zlib.crc32 or the tagged ``checksum_kind()`` scheme."""
    n = _load()
    if n is not None:
        return n.crc32c(data, init)
    t = _sw_table()
    crc = (init & 0xFFFFFFFF) ^ 0xFFFFFFFF
    for b in bytes(data):
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def checksum(data, kind: str) -> Optional[int]:
    """Compute the named checksum, or None if this host can't (no native
    crc32c and the peer used it) — callers skip verification then."""
    if kind == "crc32":
        return zlib.crc32(data) & 0xFFFFFFFF
    n = _load()
    if kind == "crc32c" and n is not None:
        return n.crc32c(data, 0)
    return None


def memory_info() -> Dict[str, int]:
    """total/used/available bytes, cgroup-aware (v1 and v2)."""
    n = _load()
    if n is not None:
        return n.memory_info()
    total = used = avail = -1
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        pass
    if total >= 0 and avail >= 0:
        used = total - avail
    return {"total": total, "used": used, "available": avail,
            "system_total": total, "cgroup_limit": -1, "cgroup_used": -1}


def process_rss(pid: int) -> int:
    n = _load()
    if n is not None:
        return n.process_rss(pid)
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return -1


def process_memory(pids: List[int]) -> List[Tuple[int, int]]:
    """[(pid, rss_bytes)] for live pids, largest first."""
    n = _load()
    if n is not None:
        return n.process_memory(list(pids))
    out = [(p, process_rss(p)) for p in pids]
    return sorted([x for x in out if x[1] >= 0], key=lambda x: -x[1])


class PyLogKV:
    """Pure-Python LogKV fallback (same on-disk format as the native one).

    Replay accepts BOTH frame checksums — crc32c (native writer) and zlib
    crc32 (this writer) — so a WAL survives the toolchain appearing or
    disappearing between restarts (ADVICE r3: a silent algorithm flip used
    to discard the whole durable KV as a corrupt tail). Writes frame with
    zlib.crc32: it runs at C speed (the pure-Python crc32c table would be
    GIL-bound minutes for the multi-MB runtime-env packages the GCS WAL
    stores), and the native replayer accepts it.
    """

    _TOMB = 0xFFFFFFFF

    def __init__(self, path: str):
        import struct

        self._path = path
        self._table: Dict[str, bytes] = {}
        self._struct = struct
        if os.path.exists(path):
            self._replay()
        self._f = open(path, "ab")

    def _replay(self) -> None:
        s = self._struct
        size = os.path.getsize(self._path)
        reason = None
        self._algos = [lambda b: zlib.crc32(b) & 0xFFFFFFFF, crc32c_sw]
        pos = 0
        with open(self._path, "rb") as f:
            while True:
                pos = f.tell()
                hdr = f.read(12)
                if len(hdr) == 0:
                    break
                if len(hdr) < 12:
                    reason = "torn header"
                    break
                crc, klen, vfield = s.unpack("<III", hdr)
                tomb = vfield == self._TOMB
                vlen = 0 if tomb else vfield
                if klen > 1 << 24 or vlen > 1 << 30:
                    reason = "implausible record lengths"
                    break
                body = f.read(klen + vlen)
                if len(body) < klen + vlen:
                    reason = "torn body"
                    break
                rec = hdr[4:] + body
                # Try the last-matched algorithm first: zlib.crc32 is
                # C-speed, crc32c_sw a Python byte loop — a homogeneous
                # file (the common case) should pay the slow check at most
                # once, not per record.
                if self._algos[0](rec) != crc:
                    if self._algos[1](rec) != crc:
                        reason = "checksum mismatch"
                        break
                    self._algos.reverse()
                key = body[:klen].decode()
                if tomb:
                    self._table.pop(key, None)
                else:
                    self._table[key] = body[klen:]
        if reason is not None and pos < size:
            import logging

            logging.getLogger("ray_tpu_torch.native").warning(
                "LogKV replay of %s stopped at offset %d of %d (%s): "
                "%d trailing bytes truncated. If this is more than one "
                "torn record the WAL may be corrupt — recovered %d keys.",
                self._path, pos, size, reason, size - pos, len(self._table))
            # Truncate the unreplayable tail BEFORE appending: records
            # written after a surviving torn tail would sit behind it and
            # be invisible to every future replay — acked-then-lost on
            # each subsequent restart.
            os.truncate(self._path, pos)

    def _append(self, key: str, value: Optional[bytes]) -> None:
        s = self._struct
        kb = key.encode()
        vfield = self._TOMB if value is None else len(value)
        body = s.pack("<II", len(kb), vfield) + kb + (value or b"")
        self._f.write(
            s.pack("<I", zlib.crc32(body) & 0xFFFFFFFF) + body)
        self._f.flush()

    def put(self, key: str, value: bytes) -> None:
        self._append(key, bytes(value))
        self._table[key] = bytes(value)

    def get(self, key: str) -> Optional[bytes]:
        return self._table.get(key)

    def delete(self, key: str) -> bool:
        if key not in self._table:
            return False
        self._append(key, None)
        del self._table[key]
        return True

    def keys(self):
        return list(self._table)

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def compact(self) -> None:
        tmp = self._path + ".compact"
        old = self._f
        with open(tmp, "wb"):
            pass
        self._f = open(tmp, "ab")
        try:
            for k, v in self._table.items():
                self._append(k, v)
            self.sync()
            os.replace(tmp, self._path)
            old.close()
        except Exception:
            self._f.close()
            self._f = old
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def close(self) -> None:
        self._f.close()

    def __len__(self) -> int:
        return len(self._table)


def LogKV(path: str):
    """Durable append-only KV: native if available, Python otherwise."""
    n = _load()
    if n is not None:
        return n.LogKV(path)
    return PyLogKV(path)
