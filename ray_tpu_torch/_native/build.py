"""Build the rt_native C extension (port of ``ray_tpu/_native/build.py``).

Run: ``python -m ray_tpu_torch._native.build``  (or it happens lazily on
first import through ``ray_tpu_torch._native``). Uses g++ directly — no
setuptools machinery, no network. The .so lands in the git-ignored
``ray_tpu_torch/_build/``, named by a hash of the source, so a changed
source builds anew and no binary is ever committed.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "rt_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")


def _src_hash() -> str:
    return hashlib.sha256(open(SRC, "rb").read()).hexdigest()[:16]


SO = os.path.join(
    BUILD_DIR,
    f"rt_native-{_src_hash()}{sysconfig.get_config_var('EXT_SUFFIX')}")


def build(force: bool = False, quiet: bool = True) -> str:
    """Compile if needed; returns the .so path. Raises on compile failure."""
    if not force and os.path.exists(SO):
        return SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    # a private output name: processes that build at once each write
    # their own file, and the rename is atomic
    tmp = f"{SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-Wall",
        f"-I{include}", SRC, "-o", tmp,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if not quiet:
            sys.stderr.write(proc.stderr)
        raise RuntimeError(f"rt_native build failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, SO)
    return SO


if __name__ == "__main__":
    print(build(force="--force" in sys.argv, quiet=False))
