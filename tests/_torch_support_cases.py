"""Programs for the parity tests of the runtime's support parts (runtime
environments and the chaos plane) that run on both runtimes, ``ray_tpu``
and ``ray_tpu_torch``, in turn.

Like ``tests/_torch_runtime_cases.py`` this module imports neither package
(nor jax): each program takes the runtime's package name and imports it
by name, and the tests register the module with cloudpickle by value, so
a worker of the port's cluster never imports jax or ``ray_tpu``. Every
program returns plain data for the test to compare across the runtimes.
"""

from __future__ import annotations

import importlib
import os
import sys
import time


def _rt(pkg):
    return importlib.import_module(pkg)


def _exc(e):
    """An exception as (type name, first line of its message)."""
    return type(e).__name__, str(e).splitlines()[0] if str(e) else ""


# ---- runtime environments ---------------------------------------------------

def runtime_envs(pkg, project_dir, module_dir):
    """working_dir, env_vars, py_modules (alone and with working_dir), an
    actor in a working_dir, an unknown field, and the package's bytes."""
    rt = _rt(pkg)
    env_mod = importlib.import_module(pkg + ".runtime_env")
    out = {}

    @rt.remote(runtime_env={"working_dir": project_dir})
    def use_module():
        import secret_mod

        with open("data.txt") as f:
            return secret_mod.shout(), f.read().strip()

    out["working_dir"] = rt.get(use_module.remote(), timeout=90)

    @rt.remote(runtime_env={"env_vars": {"RT_TEST_FLAG": "alpha"}})
    def read_env():
        return os.environ.get("RT_TEST_FLAG"), os.getpid()

    @rt.remote
    def read_env_plain():
        return os.environ.get("RT_TEST_FLAG"), os.getpid()

    val, pid_env = rt.get(read_env.remote(), timeout=90)
    plain, pid_plain = rt.get(read_env_plain.remote(), timeout=90)
    out["env_vars"] = (val, plain, pid_env != pid_plain)

    @rt.remote(runtime_env={"py_modules": [module_dir]})
    def use_pkg():
        import magic_pkg
        from magic_pkg.core import spell

        return magic_pkg.NAME, spell(), "magic_pkg" in os.getcwd()

    out["py_modules"] = rt.get(use_pkg.remote(), timeout=60)

    @rt.remote(runtime_env={"working_dir": project_dir,
                            "py_modules": [module_dir]})
    def both():
        import magic_pkg
        import secret_mod

        with open("data.txt") as f:
            return magic_pkg.NAME, secret_mod.MAGIC, f.read().strip()

    out["both"] = rt.get(both.remote(), timeout=60)

    @rt.remote(runtime_env={"working_dir": project_dir})
    class Uses:
        def magic(self):
            import secret_mod

            return secret_mod.MAGIC

    out["actor"] = rt.get(Uses.remote().magic.remote(), timeout=90)

    @rt.remote(runtime_env={"conda": "nope"})
    def unknown():
        return 1

    try:
        unknown.remote()
        out["unknown_field"] = None
    except Exception as e:  # noqa: BLE001 — the error is the result
        out["unknown_field"] = _exc(e)
    out["package_bytes"] = env_mod.package_working_dir(project_dir)
    return out


def venv_env(pkg, wheel):
    """A ``venv: True`` env with a wheel installed into it, and a plain
    task beside it that must not see the wheel."""
    rt = _rt(pkg)

    @rt.remote(runtime_env={"venv": True, "pip": [wheel]})
    def probe():
        import numpy
        import rt_dummy_pkg

        return sys.executable, rt_dummy_pkg.VALUE, numpy.__name__

    @rt.remote
    def plain():
        try:
            import rt_dummy_pkg  # noqa: F401
            return sys.executable, True
        except ImportError:
            return sys.executable, False

    exe, value, np_name = rt.get(probe.remote(), timeout=300)
    exe2, leaked = rt.get(plain.remote(), timeout=90)
    return {"venv_interpreter": "/venvs/" in exe and exe != sys.executable,
            "value": value, "numpy": np_name,
            "plain_interpreter": "/venvs/" not in exe2, "leaked": leaked}


# ---- the chaos plane ----------------------------------------------------------

def _backend(rt):
    return rt.global_worker()._require_backend()


def _counter(pkg, name, tags=None):
    metrics = importlib.import_module(pkg + ".util.metrics")
    for m in metrics._registry.snapshot():
        if m["name"] == name and m["type"] == "counter":
            return sum(v for labels, v in m["samples"]
                       if tags is None or all(labels.get(k) == tv
                                              for k, tv in tags.items()))
    return 0.0


def _chaos_events(rt, sites, timeout_s=15.0):
    """The chaos-origin failure events of ``sites`` on the feed, once
    there are any (or at the deadline)."""
    b = _backend(rt)
    deadline = time.monotonic() + timeout_s
    while True:
        evs = [e for e in b.io.run(b._gcs.call(
            "list_failure_events", {"limit": 500, "origin": "chaos"}))
            if e.get("site") in sites]
        if evs or time.monotonic() > deadline:
            return evs
        time.sleep(0.2)


def _event_facts(evs):
    return sorted({(e.get("site"), e.get("category"), e.get("origin"))
                   for e in evs})


def chaos_kill_worker(pkg):
    """``raylet.kill_worker`` kills a task's worker once, armed through
    the GCS; the owner's retry recovers. (The killed worker goes back to
    the pool until the raylet reaps it, and a quick retry can be pushed
    to it again: in both runtimes two retries are not always enough.)"""
    rt = _rt(pkg)
    b = _backend(rt)
    retries = _counter(pkg, "rt_task_retries_total")
    reply = b.io.run(b._gcs.call("chaos_arm", {"plan": {
        "seed": 1, "faults": [{"site": "raylet.kill_worker", "at": 1,
                               "max_fires": 1}]}}))

    @rt.remote(max_retries=10)
    def survivor(x):
        return x * 2

    try:
        value = rt.get(survivor.remote(21), timeout=120)
        evs = _chaos_events(rt, ("raylet.kill_worker",))
    finally:
        b.io.run(b._gcs.call("chaos_disarm", {}))
    return {"armed": bool(reply.get("ok")), "value": value,
            "events": _event_facts(evs),
            "retried": _counter(pkg, "rt_task_retries_total") > retries}


def chaos_rpc(pkg):
    """``rpc.delay`` stalls the targeted call; ``rpc.drop`` fails it once
    and the next call goes through."""
    rt = _rt(pkg)
    chaos = importlib.import_module(pkg + ".util.chaos")
    chaos.arm({"seed": 0, "faults": [
        {"site": "rpc.delay", "at": 1, "delay_s": 0.4,
         "target": "cluster_resources"}]})
    t0 = time.monotonic()
    rt.cluster_resources()
    delayed = time.monotonic() - t0 >= 0.4
    chaos.arm({"seed": 0, "faults": [
        {"site": "rpc.drop", "at": 1, "target": "cluster_resources"}]})
    try:
        rt.cluster_resources()
        dropped = None
    except Exception as e:  # noqa: BLE001 — the error is the result
        dropped = type(e).__name__
    again = bool(rt.cluster_resources())
    try:       # the fires are buffered in this process until a drain
        evs = _chaos_events(rt, ("rpc.delay", "rpc.drop"))
    finally:
        chaos.disarm()
    # which of the two buffered fires reaches the feed first varies
    return {"delayed": delayed, "dropped": dropped, "again": again,
            "events": sorted({(e.get("category"), e.get("origin"))
                              for e in evs})}


def chaos_object_lose(pkg):
    """``object.lose`` eats a sealed shared-memory return; lineage
    reconstruction rebuilds it."""
    import numpy as np

    rt = _rt(pkg)
    chaos = importlib.import_module(pkg + ".util.chaos")
    tags = {"outcome": "ok"}
    before = _counter(pkg, "rt_object_reconstructions_total", tags)

    @rt.remote
    def produce():
        return np.full((400, 200), 7.0, dtype=np.float32)

    warm = float(rt.get(produce.remote(), timeout=60)[0, 0])
    chaos.arm({"seed": 0, "faults": [
        {"site": "object.lose", "after": 0, "max_fires": 1}]})
    try:
        value = float(rt.get(produce.remote(), timeout=120)[0, 0])
        evs = _chaos_events(rt, ("object.lose",))
    finally:
        chaos.disarm()
    return {"warm": warm, "value": value, "events": _event_facts(evs),
            "reconstructed": _counter(
                pkg, "rt_object_reconstructions_total", tags) > before}


def chaos_oom(pkg):
    """``oom.pressure`` fakes 99 % node memory on every tick of the
    raylet's monitor: the OOM-kill path kills idle pooled workers first,
    then the running task's worker, and the caller gets the categorized
    error."""
    import tempfile

    rt = _rt(pkg)
    chaos = importlib.import_module(pkg + ".util.chaos")
    running = os.path.join(tempfile.mkdtemp(prefix="chaos_oom_"), "running")

    @rt.remote(max_retries=0)
    def hog(marker):
        open(marker, "w").close()
        time.sleep(60)

    ref = hog.remote(running)
    deadline = time.monotonic() + 60
    while not os.path.exists(running) and time.monotonic() < deadline:
        time.sleep(0.05)      # until the task holds its worker
    chaos.arm({"seed": 0, "faults": [
        {"site": "oom.pressure", "after": 0, "max_fires": 50,
         "value": 0.99}]})
    try:
        rt.get(ref, timeout=60)
        err = None
    except Exception as e:  # noqa: BLE001 — the error is the result
        err = (type(e).__name__,
               (getattr(e, "cause_info", None) or {}).get("category"))
    finally:
        chaos.disarm()
    return {"error": err,
            "events": _event_facts(_chaos_events(rt, ("oom.pressure",)))}


CHAOS_PROGRAMS = ("chaos_kill_worker", "chaos_rpc", "chaos_object_lose",
                  "chaos_oom")
