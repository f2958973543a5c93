"""RuntimeEnv: packaging (driver side) + materialization (worker side).

Reference analogs: ``_private/runtime_env/packaging.py`` (zip -> KV under a
content hash, ``gcs://`` URIs), ``working_dir.py`` (download + chdir +
sys.path), ``pip.py`` (dependency install), ``context.py`` (env var
injection). The worker cache key (raylet worker pool) includes the env hash,
so processes are reused only within the same environment — the reference's
worker-pool-keyed-by-runtime-env-hash behavior.

Supported fields:
  - ``working_dir``: local dir (driver packages it) or ``gcs://<hash>`` URI.
  - ``env_vars``: dict of str -> str set in the worker before user code.
  - ``pip``: list of requirement strings / local wheel paths, installed into
    a per-env cache dir that is prepended to ``sys.path`` (no venv spawn —
    same interpreter, isolated site dir).
  - ``py_modules``: list of local package dirs (reference:
    ``runtime_env/py_modules.py``) shipped content-addressed like
    working_dir, joined to ``sys.path`` as import roots without chdir.
  - ``venv``: bool — hermetic interpreter isolation (the redesign of the
    reference's ``conda.py``/``container.py`` plugins for prebaked GPU
    images): the RAYLET creates a real virtualenv per env hash
    (``--system-site-packages`` so torch/the framework resolve from the
    image), installs ``pip`` deps into it, and spawns the worker WITH THAT
    INTERPRETER — user deps can shadow or pin versions without touching
    the node's site-packages, and `pip` state cannot leak across envs.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import subprocess
import sys
import zipfile
from typing import Any, Dict, List, Optional

RuntimeEnv = Dict[str, Any]

_EXCLUDE_DIRS = {".git", "__pycache__", ".venv", "node_modules", ".eggs"}
_MAX_WORKING_DIR_BYTES = 512 * 1024 * 1024
_KV_PREFIX = "@runtime_env/"


def _iter_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in _EXCLUDE_DIRS]
        for name in sorted(filenames):
            yield os.path.join(dirpath, name)


def package_working_dir(path: str) -> bytes:
    """Deterministic zip of a directory (sorted entries, zeroed timestamps)
    so equal content yields an equal hash/URI."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"working_dir {path!r} is not a directory")
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for fpath in _iter_files(path):
            rel = os.path.relpath(fpath, path)
            total += os.path.getsize(fpath)
            if total > _MAX_WORKING_DIR_BYTES:
                raise ValueError(
                    f"working_dir {path!r} exceeds "
                    f"{_MAX_WORKING_DIR_BYTES >> 20} MB")
            info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = (os.stat(fpath).st_mode & 0xFFFF) << 16
            with open(fpath, "rb") as f:
                zf.writestr(info, f.read())
    return buf.getvalue()


def env_hash(env: RuntimeEnv) -> str:
    """Content hash identifying a prepared env (worker-pool cache key)."""
    return hashlib.sha1(
        json.dumps(env, sort_keys=True).encode()).hexdigest()[:16]


def prepare_runtime_env(env: Optional[RuntimeEnv], kv_put, kv_get) -> Optional[Dict]:
    """Driver-side normalization: upload working_dir once (content-addressed,
    skipped if the KV already holds the blob); returns the wire form
    {"working_dir_uri", "env_vars", "pip", "hash"} or None."""
    if not env:
        return None
    wire: Dict[str, Any] = {}
    wd = env.get("working_dir")
    if wd:
        if str(wd).startswith("gcs://"):
            wire["working_dir_uri"] = wd
        else:
            blob = package_working_dir(wd)
            digest = hashlib.sha1(blob).hexdigest()[:20]
            uri = f"gcs://{digest}"
            key = _KV_PREFIX + digest
            if kv_get(key) is None:
                kv_put(key, blob)
            wire["working_dir_uri"] = uri
    if env.get("env_vars"):
        vars_ = env["env_vars"]
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in vars_.items()):
            raise TypeError("env_vars must be Dict[str, str]")
        wire["env_vars"] = dict(vars_)
    if env.get("pip"):
        wire["pip"] = list(env["pip"])
    if env.get("venv"):
        wire["venv"] = True
    py_modules = env.get("py_modules")
    if py_modules:
        # Each entry is a local package dir (or a prior gcs:// URI); each is
        # uploaded content-addressed like working_dir but joins sys.path
        # WITHOUT chdir (reference: runtime_env/py_modules.py — modules are
        # import roots, working_dir is the cwd).
        uris = []
        for mod in py_modules:
            if str(mod).startswith("gcs://"):
                uris.append(mod)
                continue
            blob = package_working_dir(mod)
            digest = hashlib.sha1(blob).hexdigest()[:20]
            key = _KV_PREFIX + digest
            if kv_get(key) is None:
                kv_put(key, blob)
            # preserve the top-level package name: the zip holds the dir's
            # CONTENTS, so the import root must re-create <name>/
            uris.append(f"gcs://{digest}#{os.path.basename(os.path.abspath(mod))}")
        wire["py_modules_uris"] = uris
    unknown = set(env) - {"working_dir", "env_vars", "pip", "py_modules",
                          "venv"}
    if unknown:
        raise ValueError(f"unsupported runtime_env fields: {sorted(unknown)}")
    if not wire:
        return None
    wire["hash"] = env_hash(wire)
    return wire


def materialize(wire: Dict, kv_get, cache_root: str) -> None:
    """Worker-side: make the env live in THIS process before any user code
    runs — download/extract working_dir (content-addressed cache shared by
    workers on the node), chdir + sys.path it, install pip deps into a
    per-env site dir, export env_vars."""
    os.makedirs(cache_root, exist_ok=True)

    uri = wire.get("working_dir_uri")
    if uri:
        digest = uri[len("gcs://"):]
        target = os.path.join(cache_root, "working_dirs", digest)
        if not os.path.isdir(target):
            blob = kv_get(_KV_PREFIX + digest)
            if blob is None:
                raise RuntimeError(f"runtime_env blob {uri} not in GCS KV")
            tmp = target + f".tmp.{os.getpid()}"
            os.makedirs(tmp, exist_ok=True)
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(tmp)
            try:
                os.rename(tmp, target)
            except OSError:  # another worker won the race
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        os.chdir(target)
        if target not in sys.path:
            sys.path.insert(0, target)

    for mod_uri in wire.get("py_modules_uris") or ():
        # "gcs://<digest>#<pkg_name>": the zip holds the package dir's
        # CONTENTS, so extraction recreates <root>/<pkg_name>/ and <root>
        # joins sys.path as the import root (no chdir — that's
        # working_dir's job).
        ref, _, pkg_name = mod_uri.partition("#")
        digest = ref[len("gcs://"):]
        root = os.path.join(cache_root, "py_modules", digest)
        if not os.path.isdir(root):
            blob = kv_get(_KV_PREFIX + digest)
            if blob is None:
                raise RuntimeError(f"runtime_env blob {ref} not in GCS KV")
            tmp = root + f".tmp.{os.getpid()}"
            dest = os.path.join(tmp, pkg_name) if pkg_name else tmp
            os.makedirs(dest, exist_ok=True)
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(dest)
            try:
                os.rename(tmp, root)
            except OSError:  # another worker won the race
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        if root not in sys.path:
            sys.path.insert(0, root)

    pip_reqs = wire.get("pip")
    if pip_reqs and not wire.get("venv"):
        # (venv envs carry their deps IN the interpreter the raylet
        # launched this worker with — see ensure_venv)
        site = os.path.join(cache_root, "pip", wire["hash"])
        if not os.path.isdir(site):
            # install into a private tmp dir, then atomically rename — two
            # workers materializing the same env concurrently must never
            # write into one site dir (same pattern as working_dir above)
            tmp = site + f".tmp.{os.getpid()}"
            os.makedirs(tmp, exist_ok=True)
            cmd = [sys.executable, "-m", "pip", "install",
                   "--target", tmp, "--no-warn-script-location"]
            if all(r.endswith(".whl") or os.path.exists(r) for r in pip_reqs):
                cmd.append("--no-index")  # local wheels: no network needed
            proc = subprocess.run(cmd + list(pip_reqs),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"pip install for runtime_env failed:\n{proc.stderr[-2000:]}")
            os.makedirs(os.path.dirname(site), exist_ok=True)
            try:
                os.rename(tmp, site)
            except OSError:  # another worker won the race
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        if site not in sys.path:
            sys.path.insert(0, site)

    for k, v in (wire.get("env_vars") or {}).items():
        os.environ[k] = v


def ensure_venv(wire: Dict, cache_root: str) -> str:
    """Raylet-side: create (or reuse) the hermetic virtualenv for a
    ``venv: True`` env and return its python executable. Keyed by the env
    hash; creation is atomic (private tmp dir, rename into place) so two
    concurrent spawns can't corrupt one env. The reference's analog is the
    agent materializing ``conda.py``/``container.py`` envs before worker
    launch and swapping ``context.py_executable``."""
    venv_dir = os.path.join(cache_root, "venvs", wire["hash"])
    py = os.path.join(venv_dir, "bin", "python")
    if os.path.exists(py):
        return py
    # Concurrent same-hash calls run in executor THREADS of the one
    # raylet process (spawn throttle allows several) — a pid-keyed tmp
    # dir does NOT separate them the way it does for materialize()'s
    # per-worker-process callers. Serialize creation PER ENV HASH and
    # re-check: distinct envs build concurrently (one slow pip install
    # must not make unrelated envs time out in the worker pool), while
    # same-hash spawns still create exactly once.
    with _venv_lock(wire["hash"]):
        if os.path.exists(py):
            return py
        return _create_venv(venv_dir, py, wire)


_VENV_LOCKS: Dict[str, Any] = {}
_VENV_LOCKS_GUARD = __import__("threading").Lock()


def _venv_lock(env_hash: str):
    with _VENV_LOCKS_GUARD:
        lock = _VENV_LOCKS.get(env_hash)
        if lock is None:
            lock = _VENV_LOCKS[env_hash] = __import__("threading").Lock()
        return lock


def _create_venv(venv_dir: str, py: str, wire: Dict) -> str:
    import uuid
    import venv as _venv

    tmp = venv_dir + f".tmp.{uuid.uuid4().hex[:8]}"
    # system-site-packages: torch/numpy/the framework come from the prebaked
    # image; the venv only OVERLAYS user deps
    _venv.create(tmp, system_site_packages=True, with_pip=True,
                 symlinks=True)
    # When THIS process itself runs inside a virtualenv (the common case:
    # the image ships /opt/venv), venv.create chains to the BASE
    # interpreter — system-site-packages then points at the base python's
    # site dir and the image's packages vanish. Propagate the creating
    # interpreter's site dirs with a .pth so the overlay always sees them.
    parent_sites = [p for p in sys.path
                    if p.endswith("site-packages") and os.path.isdir(p)]
    if parent_sites:
        import glob as _glob

        for site_dir in _glob.glob(os.path.join(tmp, "lib", "python*",
                                                "site-packages")):
            with open(os.path.join(site_dir, "_rt_parent_site.pth"),
                      "w") as f:
                f.write("\n".join(parent_sites) + "\n")
    reqs = wire.get("pip") or []
    if reqs:
        tmp_py = os.path.join(tmp, "bin", "python")
        cmd = [tmp_py, "-m", "pip", "install",
               "--no-warn-script-location"]
        if all(r.endswith(".whl") or os.path.exists(r) for r in reqs):
            cmd.append("--no-index")  # local wheels: no network needed
        proc = subprocess.run(cmd + list(reqs), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"venv pip install failed:\n{proc.stderr[-2000:]}")
    os.makedirs(os.path.dirname(venv_dir), exist_ok=True)
    try:
        os.rename(tmp, venv_dir)
    except OSError:  # another spawn won the race
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return py
