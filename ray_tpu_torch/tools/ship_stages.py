"""The stages of one weight shipment through the node's object store.

    python3 -m ray_tpu_torch.tools.ship_stages [--preset 1b]
        [--device cuda|cpu] [--dir /dev/shm] [--jsonl PATH]

Draws the preset's params in bf16 on the device (the tree the RLHF
learner ships) and, leaf by leaf, times what ``collective.ship_params``
and ``fetch_params`` do with a leaf above the stream's inline size:
serializing it (for a CUDA leaf, its copy to the host), writing the
payload into a file of the store's directory through an ``mmap``, then
mapping the file and deserializing it back onto the device: the two
store paths, with and without ``MAP_POPULATE`` (``object_store.py``
maps with it). Every leaf read back is checked bit-equal. Prints one
JSON line of seconds summed over the leaves, with the card's name and
power limit; the files are removed.
"""

from __future__ import annotations

import argparse
import mmap
import os
import tempfile
import time
from pathlib import Path

import torch

from ray_tpu_torch.tools._tune import emitter, nvidia_smi

_POPULATE = getattr(mmap, "MAP_POPULATE", 0)


def _write_mmap(path: str, so, populate: bool) -> None:
    n = so.total_bytes()
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
    try:
        os.ftruncate(fd, n)
        mm = mmap.mmap(fd, n, flags=mmap.MAP_SHARED
                       | (_POPULATE if populate else 0))
    finally:
        os.close(fd)
    so.write_to(memoryview(mm))
    mm.close()


def _read(ctx, path: str, n: int, populate: bool, device):
    from ray_tpu_torch._private.serialization import unpack_payload

    fd = os.open(path, os.O_RDONLY)
    try:
        mm = mmap.mmap(fd, n, flags=mmap.MAP_SHARED
                       | (_POPULATE if populate else 0),
                       prot=mmap.PROT_READ)
    finally:
        os.close(fd)
    out = ctx.deserialize(*unpack_payload(memoryview(mm)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def main(argv=None) -> int:
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch._private.serialization import SerializationContext
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.train_step import _leaves

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="1b")
    ap.add_argument("--device", default=None)
    ap.add_argument("--dir", default="/dev/shm")
    ap.add_argument("--jsonl", type=Path, default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    emit = emitter(args.jsonl)
    cfg = llama.PRESETS[args.preset]
    gen = torch.Generator(device=device).manual_seed(0)
    leaves = list(_leaves(llama.init_params(
        cfg, generator=gen, device=device, dtype=torch.bfloat16)).values())
    ctx = SerializationContext()
    modes = ("mmap", "mmap_populate")
    secs = {"serialize": 0.0, **{f"{stage}_{mode}": 0.0 for mode in modes
                                 for stage in ("write", "read")}}
    exact = True
    with tempfile.TemporaryDirectory(dir=args.dir,
                                     prefix="ship_stages_") as tmp:
        for i, leaf in enumerate(leaves):
            t0 = time.perf_counter()
            so = ctx.serialize(leaf)
            secs["serialize"] += time.perf_counter() - t0
            n = so.total_bytes()
            for mode in modes:
                path = os.path.join(tmp, f"{i}_{mode}")
                populate = mode == "mmap_populate"
                t0 = time.perf_counter()
                _write_mmap(path, so, populate)
                secs[f"write_{mode}"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                got = _read(ctx, path, n, populate, device)
                secs[f"read_{mode}"] += time.perf_counter() - t0
                exact = exact and bool(torch.equal(got, leaf))
                del got
                os.unlink(path)
    emit({"tool": "ship_stages", "preset": args.preset,
          "device": str(device), "leaves": len(leaves),
          "bytes": sum(t.numel() * t.element_size() for t in leaves),
          "seconds": secs, "bit_equal": exact,
          "nvidia_smi": nvidia_smi() if device.type == "cuda" else None})
    return 0 if exact else 1


if __name__ == "__main__":
    raise SystemExit(main())
