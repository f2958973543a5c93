"""The runtime's support parts in the port against JAX's: the distributed
progress bars (``util/tqdm_rt.py``), the native helper and its Python
fallbacks (``_native/``: checksums, memory probes, the LogKV write-ahead
log), the GCS's snapshot and WAL recovery (``cluster/gcs.py``), runtime
environments (``runtime_env/``: working_dir, env_vars, py_modules, a
``venv`` with a wheel) and the chaos plane (``util/chaos.py``: the plan,
its seeded fire sequences, and four injection sites on a live cluster).

Each test feeds the same inputs to ``ray_tpu`` and to ``ray_tpu_torch``
and compares what comes out, exactly. The cluster programs are in
``tests/_torch_support_cases.py``, which imports neither package."""

import asyncio
import io
import json
import os
import subprocess
import sys
import textwrap
import zlib

import cloudpickle
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import _native as jnative
from ray_tpu.util import chaos as jchaos
from ray_tpu.util import tqdm_rt as jtqdm
from ray_tpu_torch import _native as tnative
from ray_tpu_torch.util import chaos as tchaos
from ray_tpu_torch.util import tqdm_rt as ttqdm

import _torch_support_cases as cases

cloudpickle.register_pickle_by_value(cases)

PKGS = ("ray_tpu", "ray_tpu_torch")


# ---- progress bars ------------------------------------------------------------

def _bar_lines(mod, run):
    buf = io.StringIO()
    try:
        run(mod, buf)
    except RuntimeError:
        pass
    return [json.loads(ln[len(mod.MAGIC):]) if ln.startswith(mod.MAGIC)
            else ln for ln in buf.getvalue().splitlines()]


def _strip_rate(lines):
    """Drop the bar's id and measured rate, which differ run to run."""
    return [{k: v for k, v in ln.items() if k not in ("uid", "rate")}
            if isinstance(ln, dict) else ln.split(" [")[0] for ln in lines]


def _loop(mod, buf):
    for _ in mod.tqdm(range(5), desc="work", file=buf):
        pass


def _aborted(mod, buf):
    for i in mod.tqdm(range(100), desc="crash", file=buf):
        if i == 30:
            raise RuntimeError("boom")


def _updates(mod, buf):
    bar = mod.tqdm(desc="fast", total=1000, file=buf)
    for _ in range(1000):
        bar.update(1)
    bar.close()


TQDM_CASES = {"loop": _loop, "aborted": _aborted, "updates": _updates}


@pytest.mark.parametrize("where", ["worker", "driver"])
@pytest.mark.parametrize("case", sorted(TQDM_CASES))
def test_progress_bars_match_jax(case, where, monkeypatch):
    """A worker emits magic lines, a driver renders locally: the same
    final state in both packages (update lines are rate limited by the
    clock, so only the last line compares)."""
    if where == "worker":
        monkeypatch.setenv("RT_WORKER_ID", "testworker")
    else:
        monkeypatch.delenv("RT_WORKER_ID", raising=False)
    want, got = (_strip_rate(_bar_lines(m, TQDM_CASES[case]))
                 for m in (jtqdm, ttqdm))
    assert got and got[-1] == want[-1]
    assert (jtqdm.MAGIC in str(got)) == (ttqdm.MAGIC in str(want))


@pytest.mark.parametrize("state", [
    {"desc": "d", "n": 5, "total": 10, "rate": 2.5},
    {"desc": "d", "n": 7, "total": None, "rate": 1.0},
    {"desc": "d", "n": 10, "total": 10, "rate": 1.0, "done": True},
])
def test_progress_render_matches_jax(state):
    assert ttqdm.render_state(state) == jtqdm.render_state(state)
    for line in ("a normal log line", ttqdm.MAGIC + json.dumps(state),
                 ttqdm.MAGIC + "not-json"):
        assert ttqdm.maybe_render(line) == jtqdm.maybe_render(line)


# ---- the native helper ---------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _jax_native_built():
    """Bring up JAX's compiled extension before any comparison, whichever
    test process built it first.

    JAX's lazy build compiles every process into the one ``SO + ".tmp"``
    (``ray_tpu/_native/build.py``): two first builds at once, as under
    pytest-xdist, can clobber each other, and the process whose load fails
    stays on the Python fallbacks (zlib crc32 where the port writes
    crc32c). Here the build runs under an exclusive lock on JAX's
    ``_native`` directory and is forced again if the stamped library does
    not load; then ``_load()`` runs afresh in this process. Without a
    toolchain both packages fall back alike."""
    import fcntl
    import importlib.util

    from ray_tpu._native import build as jbuild

    def _loads():
        try:
            spec = importlib.util.spec_from_file_location("rt_native",
                                                          jbuild.SO)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
            return True
        except Exception:  # noqa: BLE001 — a torn or missing library
            return False

    fd = os.open(os.path.dirname(jbuild.SO), os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        for attempt in range(3):
            try:
                jbuild.build(force=attempt > 0)
            except Exception:  # noqa: BLE001 — no toolchain
                break
            if _loads():
                break
        jnative.native, jnative._tried = None, False
        jnative._load()
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
    tnative._load()
    yield


def _payloads():
    rng = np.random.default_rng(18)
    return [b"", b"123456789", b"hello",
            rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()]


def test_native_checksums_match_jax():
    """The compiled crc32c (or its absence), the pure Python Castagnoli
    table and the tagged checksum agree with JAX's byte for byte."""
    assert tnative.checksum_kind() == jnative.checksum_kind()
    assert tnative.crc32c_sw(b"123456789") == 0xE3069283
    for data in _payloads():
        assert tnative.crc32c(data) == jnative.crc32c(data)
        assert tnative.crc32c(data, 7) == jnative.crc32c(data, 7)
        assert tnative.crc32c_sw(data[:4096]) == jnative.crc32c_sw(
            data[:4096])
        for kind in ("crc32", "crc32c", "md5"):
            assert tnative.checksum(data, kind) == jnative.checksum(data,
                                                                   kind)
    assert tnative.checksum(b"x", "crc32") == zlib.crc32(b"x") & 0xFFFFFFFF


def test_native_memory_probes_match_jax():
    t, j = tnative.memory_info(), jnative.memory_info()
    assert t.keys() == j.keys()
    assert t["total"] == j["total"] > 0
    assert t["cgroup_limit"] == j["cgroup_limit"]
    assert 0 < t["used"] <= t["total"]
    pid = os.getpid()
    assert tnative.process_rss(pid) > 1 << 20
    assert tnative.process_rss(1 << 30) == jnative.process_rss(1 << 30)
    ranked = tnative.process_memory([pid, 1 << 30])
    assert [p for p, _ in ranked] == [p for p, _ in
                                      jnative.process_memory([pid, 1 << 30])]


OPENERS = {"jax-native": lambda p: jnative.LogKV(p),
           "jax-python": lambda p: jnative.PyLogKV(p),
           "port-native": lambda p: tnative.LogKV(p),
           "port-python": lambda p: tnative.PyLogKV(p)}


def _write_log(open_kv, path):
    kv = open_kv(path)
    kv.put("a", b"1")
    kv.put("b", b"\x00raw" * 100)
    kv.put("gone", b"x")
    kv.delete("gone")
    kv.put("a", b"2")
    kv.close()
    with open(path, "ab") as f:
        f.write(b"\xde\xad\xbe")          # a torn header: a crash mid-append


def _read_log(open_kv, path):
    kv = open_kv(path)
    kv.put("after", b"3")                 # an acked write after the crash
    kv.close()
    kv = open_kv(path)
    table = {k: kv.get(k) for k in sorted(kv.keys())}
    kv.close()
    return table


@pytest.mark.parametrize("reader", ["native", "python"])
@pytest.mark.parametrize("writer", sorted(OPENERS))
def test_logkv_files_match_jax(writer, reader, tmp_path):
    """A WAL written by either package, native or Python, replays in the
    port's reader as in JAX's: the torn tail truncated, the write after
    it kept."""
    _write_log(OPENERS[writer], str(tmp_path / "port.log"))
    _write_log(OPENERS[writer], str(tmp_path / "jax.log"))
    got = _read_log(OPENERS["port-" + reader], str(tmp_path / "port.log"))
    want = _read_log(OPENERS["jax-" + reader], str(tmp_path / "jax.log"))
    assert got == want == {"a": b"2", "after": b"3", "b": b"\x00raw" * 100}
    assert (tmp_path / "port.log").read_bytes() == \
        (tmp_path / "jax.log").read_bytes()


# ---- the GCS's snapshot and write-ahead log ------------------------------------

def _gcs_lives(pkg, path, monkeypatch):
    """Actors, object locations and KV through restarts, a WAL whose open
    fails for one life (its puts kept in the snapshot) and the merge when
    it opens again; what each life sees."""
    gcs = __import__(pkg + ".cluster.gcs", fromlist=["GcsServer"])
    native = __import__(pkg + "._native", fromlist=["LogKV"])
    seen = []

    async def lives():
        g = gcs.GcsServer(persist_path=path)
        await g.rpc_kv_put({"key": "s", "value": "json-string"})
        await g.rpc_kv_put({"key": "b", "value": b"\x00raw"})
        await g.rpc_kv_put({"key": "gone", "value": "x"})
        await g.rpc_kv_del({"key": "gone"})
        await g.rpc_kv_put({"key": "both", "value": "old"})
        await g.rpc_register_actor({"spec": {
            "actor_id": "a" * 24, "class_name": "Worker", "name": "keeper",
            "namespace": "default", "resources": {}, "args": [],
            "kwargs": {}, "max_restarts": 0, "scheduling_strategy": None,
            "pg": None, "owner": "x", "method_meta": {},
            "lifetime": "detached", "get_if_exists": False,
            "max_task_retries": 0, "max_concurrency": 1, "class_id": "cid",
            "job_id": "0" * 8}})
        await g.rpc_add_object_location({"oid": "o" * 16, "node_id": "n1",
                                         "size": 123})
        g.actors["a" * 24].state = gcs.ACTOR_ALIVE
        g.mark_dirty()
        seen.append(g._kv_log is not None)
        await g.stop()

        def boom(path):
            raise OSError("simulated WAL open failure")

        with monkeypatch.context() as m:
            m.setattr(native, "LogKV", boom)
            g = gcs.GcsServer(persist_path=path)
            seen.append(g._kv_log is not None)
            await g.rpc_kv_put({"key": "degraded", "value": "v2"})
            await g.rpc_kv_put({"key": "both", "value": "new"})
            await g.stop()
        for _ in range(2):
            g = gcs.GcsServer(persist_path=path)
            got = await g.rpc_kv_get({"key": "b"})
            seen.append({
                "wal": g._kv_log is not None,
                "kv": {k: g.kv[k] for k in sorted(g.kv)},
                "get_b": got.get("value"),
                "actor": (g.actors["a" * 24].spec["class_name"],
                          g.actors["a" * 24].state),
                "locations": sorted(g.object_locations)})
            await g.stop()

    asyncio.run(lives())
    return seen


def test_gcs_snapshot_and_wal_recovery_match_jax(tmp_path, monkeypatch):
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    want = _gcs_lives("ray_tpu", str(tmp_path / "jax" / "gcs_state"),
                      monkeypatch)
    got = _gcs_lives("ray_tpu_torch", str(tmp_path / "port" / "gcs_state"),
                     monkeypatch)
    assert got == want
    assert got[:2] == [True, False] and got[2]["kv"]["both"] == "new"
    assert got[2]["kv"]["degraded"] == "v2" and "gone" not in got[2]["kv"]


# ---- the chaos plan --------------------------------------------------------------

BAD_PLANS = [
    (0, [{"site": "no.such.site"}]),
    (0, [{"site": "worker.kill", "tpyo": 1}]),
    (0, [{"site": "rpc.drop", "prob": 1.5}]),
    (0, []),
]


@pytest.mark.parametrize("seed,faults", BAD_PLANS)
def test_chaos_plan_validation_matches_jax(seed, faults):
    errors = []
    for chaos in (jchaos, tchaos):
        with pytest.raises(ValueError) as e:
            chaos.ChaosPlan(seed, faults)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    text = '{"seed": 3, "faults": [{"site": "rpc.drop", "prob": 0.5}]}'
    assert tchaos.ChaosPlan.from_value(text).to_json() == \
        jchaos.ChaosPlan.from_value(text).to_json()


FIRE_PLANS = {
    "prob": ({"seed": 11, "faults": [{"site": "rpc.drop", "prob": 0.4}]},
             [("rpc.drop", "kv_get")] * 200),
    "gates": ({"seed": 0, "faults": [
        {"site": "worker.kill", "at": 3, "target": "victim"},
        {"site": "rpc.delay", "after": 2, "max_fires": 2, "delay_s": 0.1}]},
        [("worker.kill", "other")] * 5 + [("worker.kill", "my_victim_fn")]
        * 5 + [("rpc.delay", None)] * 6),
}


@pytest.mark.parametrize("plan", sorted(FIRE_PLANS))
def test_chaos_fire_sequences_match_jax(plan):
    """The same plan and seed fire the same faults in the same order in
    both packages, with the same status afterwards."""
    spec, hits = FIRE_PLANS[plan]
    runs = []
    for chaos in (jchaos, tchaos):
        chaos.arm(spec)
        try:
            fires = [chaos.maybe_fire(site, target=target) is not None
                     for site, target in hits]
            status = chaos.status()
        finally:
            chaos.disarm()
        runs.append((fires, {k: status[k] for k in ("armed", "fires",
                                                     "hits")}))
        assert chaos.status() == {"armed": False}
    assert runs[0] == runs[1]
    assert any(runs[1][0])


# ---- clusters: runtime environments and chaos sites --------------------------------

def _shutdown_all():
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()


def _start_both():
    _shutdown_all()
    ray_tpu.init(num_cpus=2)
    ray_tpu_torch.init(num_cpus=2)


@pytest.fixture(scope="module")
def clusters():
    _start_both()
    yield
    _shutdown_all()


@pytest.fixture
def fresh_clusters():
    """A chaos site's effects depend on the worker pool it meets, so each
    program starts on new clusters, as JAX's chaos tests do."""
    _start_both()
    yield
    jchaos.disarm()
    tchaos.disarm()
    _shutdown_all()


@pytest.fixture
def project(tmp_path):
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "secret_mod.py").write_text(
        "MAGIC = 'from-working-dir'\n\n"
        "def shout():\n    return MAGIC.upper()\n")
    (proj / "data.txt").write_text("forty-two\n")
    mods = tmp_path / "mods" / "magic_pkg"
    mods.mkdir(parents=True)
    (mods / "__init__.py").write_text("NAME = 'magic_pkg'\n")
    (mods / "core.py").write_text("def spell():\n    return 'abracadabra'\n")
    return str(proj), str(mods)


def test_runtime_envs_match_jax(clusters, project):
    want, got = (cases.runtime_envs(pkg, *project) for pkg in PKGS)
    assert got == want
    assert got["working_dir"] == ("FROM-WORKING-DIR", "forty-two")
    assert got["env_vars"] == ("alpha", None, True)
    assert got["unknown_field"] is not None


def _wheel(tmp_path):
    src = tmp_path / "pkgsrc"
    (src / "rt_dummy_pkg").mkdir(parents=True)
    (src / "rt_dummy_pkg" / "__init__.py").write_text("VALUE = 1234\n")
    (src / "pyproject.toml").write_text(textwrap.dedent("""
        [build-system]
        requires = ["setuptools"]
        build-backend = "setuptools.build_meta"

        [project]
        name = "rt-dummy-pkg"
        version = "0.1.0"
    """))
    out = tmp_path / "wheels"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-index",
         "--no-build-isolation", "-w", str(out), str(src)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return str(next(out.glob("*.whl")))


def test_venv_env_matches_jax(clusters, tmp_path):
    wheel = _wheel(tmp_path)
    want, got = (cases.venv_env(pkg, wheel) for pkg in PKGS)
    assert got == want
    assert got == {"venv_interpreter": True, "value": 1234,
                   "numpy": "numpy", "plain_interpreter": True,
                   "leaked": False}


@pytest.mark.parametrize("program", cases.CHAOS_PROGRAMS)
def test_chaos_sites_match_jax(fresh_clusters, program):
    want, got = (getattr(cases, program)(pkg) for pkg in PKGS)
    assert got == want
    assert got["events"], got
