"""What the kernel tuning scripts share: variant builds of one CUDA source
(each a text substitution, all nvcc processes at once), device timing by
CUDA-graph replay, and their output lines."""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

from ray_tpu_torch.ops import _build, flash


def device_ms(fn, iters=10):
    """Device time per call: ``iters`` calls in one CUDA graph, replayed
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def build_variants(source: str, variants: Dict[str, Dict[str, str]],
                   out_dir: Path):
    """{name: (launch, error_string, pick, ptxas summary of the tcb and
    dec kernels)}, one library of ``csrc/<source>.cu`` per variant
    (``flash.typed_fns``)."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    for header in _build.CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in {source}.cu")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
               str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{err}")
        regs = {k: v for k, v in _build.ptxas_summary(err).items()
                if k.startswith(("tcb::", "dec::"))}
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        libs[name] = (*flash.typed_fns(lib, source), regs)
    return libs


def emitter(jsonl: Optional[Path]):
    """A function that prints one JSON line and appends it to ``jsonl``."""
    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if jsonl is not None:
            with jsonl.open("a") as f:
                f.write(line + "\n")
    return emit


def nvidia_smi() -> str:
    """The card's name and power limit, as every kept number names them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
