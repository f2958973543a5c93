"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). Libraries land in ``ray_tpu_torch/_build/`` (git-ignored),
named by a hash of the sources and flags: an edited source rebuilds, an
unchanged one loads. ``build()`` starts one ``nvcc`` per source, all at
once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES: Tuple[str, ...] = ("flash_fwd", "flash_bwd")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}   # name -> nvcc's stderr (ptxas register use)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise FileNotFoundError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns name -> seconds spent
    building (0.0 for a library already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    secs = {n: 0.0 for n in todo}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        _, err = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_log[name] = err
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{err}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return secs


def ptxas_summary(log: str) -> Dict[str, Dict[str, int]]:
    """{"kernel<dtype,D>": {"registers": n, "spill_bytes": m}} from the
    ``-Xptxas -v`` lines of one build's log. A kernel is named with its
    namespace, as in "tcb::flash_bwd_dq_kernel<bf16,64>". Its dtype is its
    template argument where it has one ("flash_fwd_kernel<bf16,64>"),
    else set by the namespace: tcb and dec (bf16) or simt (float)."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(?:(tcb|simt|dec)\d+)?"
                      r"(flash_(?:fwd|fwd_combine|bwd_dq|bwd_dkv)_kernel)"
                      r"I(f|13__nv_bfloat16)?Li(\d+)E", ln)
        if m:
            ns, elem = m.group(1), m.group(3)
            fp32 = elem == "f" or (elem is None and ns == "simt")
            name = (f"{ns + '::' if ns else ''}{m.group(2)}"
                    f"<{'float' if fp32 else 'bf16'},{m.group(4)}>")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = {"registers": int(m.group(1)), "spill_bytes": spill}
            name = None
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
