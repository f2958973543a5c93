"""The port's serve deployment layer against JAX's: the same serve
programs (``tests/_torch_serve_cases.py``) run on ``ray_tpu.serve`` and on
``ray_tpu_torch.serve``, each on its own runtime's cluster, the two side by
side in one process, and give equal results: handle results and
composition through ``bind``, ``@serve.batch`` sizes, HTTP status, body,
content type and streamed chunk sequences, the ASGI bridge with a
WebSocket echo, multiplexed routing and its LRU, ``schema`` deploys, gRPC
ingress, the names and tags of the serve series and the keys of
``status()`` and ``detailed_status()``. The autoscaler's decisions and
``_RouterState.pick`` under a seeded ``random`` are compared as pure units.

Every proxy binds port 0."""

import dataclasses

import cloudpickle
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu_torch import serve as tserve

import _torch_serve_cases as cases

cloudpickle.register_pickle_by_value(cases)


def _shutdown_all():
    for serve, rt in ((jserve, ray_tpu), (tserve, ray_tpu_torch)):
        if rt.is_initialized():
            try:
                serve.shutdown()
            finally:
                serve._forget_controller_for_tests()
                rt.shutdown()


@pytest.fixture(scope="module")
def clusters():
    _shutdown_all()
    ray_tpu.init(num_cpus=6, num_tpus=0)
    ray_tpu_torch.init(num_cpus=6, num_gpus=0)
    yield
    _shutdown_all()


def _both(program, *args):
    fn = getattr(cases, program)
    return fn("ray_tpu", *args), fn("ray_tpu_torch", *args)


def test_exports_cover_jax():
    assert set(jserve.__all__) <= set(tserve.__all__)
    assert all(hasattr(tserve, n) for n in jserve.__all__)


@pytest.mark.parametrize("program", [
    "serve_handles_and_composition", "serve_batching", "serve_http",
    "serve_asgi", "serve_multiplexed", "serve_schema", "serve_grpc",
    "serve_status_and_metrics"])
def test_serve_programs_match_jax(clusters, program):
    want, got = _both(program)
    assert got == want, (program, got, want)
    if program == "serve_handles_and_composition":
        assert got["composed"][1] == {"left": 6, "right": 105, "sum": 111}
    if program == "serve_batching":
        assert got["total"] == 8 and got["fused"] and got["within_max"]
    if program == "serve_http":
        assert got["sum"]["chunks"] == [b'{"sum": 6}']
        assert got["stream"]["chunked"] and got["stream"]["several_chunks"]
        assert got["stream"]["body"] == b"t0 t1 t2 t3 t4 "
        assert got["missing"]["status"] == got["unrouted"]["status"] == 404
    if program == "serve_asgi":
        assert got["ws"][:4] == ["hello:/room", "ABC", bytes([44]), "BYE"]
    if program == "serve_multiplexed":
        assert got["loads"] == ["m1", "m2", "m3", "m1"]
    if program == "serve_status_and_metrics":
        names = {name for name, _ in got["series"]}
        assert "rt_serve_execute_seconds_count" in names, names


def test_obs_series_match_jax():
    """Every series of ``serve.obs``: the same names, descriptions, tag
    keys and buckets."""
    want, got = _both("obs_catalog")
    assert got == want
    assert len(got) >= 15


SERIES = [
    (1, {}), (3, {"queue_depth": 1}), (9, {"queue_depth": 9, "qps": 5.0}),
    (1, {"qps": 70.0, "p99_s": 0.2}), (2, {"qps": 3.0, "p99_s": 1.2}),
    (4, {"qps": 0.0, "p99_s": 9.9}), (0, {}), (0, {"cb_pending": 7}),
    (30, {"queue_depth": 1000}), (0, {}),
]


def test_autoscaler_decisions_match_jax():
    """The same ongoing-count and windowed-stats series under the
    ongoing, queue-depth, qps and p99 policies: the same targets and
    triggering signals."""
    want, got = _both("autoscale_decisions", SERIES)
    assert got == want
    assert {s for _, s in got} >= {"ongoing", "queue_depth", "qps", "p99"}


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_router_picks_match_jax(seed):
    """``_RouterState.pick`` under the same seeded global ``random``:
    power of two choices by load, model-id preference, KV-affinity with
    ``_AFFINITY_SLACK``; the same replicas picked and the same counts."""
    prefix = list(range(1, 97))
    prompts = [prefix + [60, 61], prefix + [7], list(range(200, 240)),
               prefix[:40] + [3]]
    want, got = _both("router_picks", seed, prompts)
    assert got == want


def test_router_affinity_units_match_jax():
    """JAX's affinity cases (``tests/test_zz_kv_cache.py``): residency
    wins every two-choice, unknown residency falls back to load, the
    slack guard sheds to the cold replica, the longer match wins."""
    import ray_tpu.serve.handle as JH
    import ray_tpu.util.prefix_hash as JPH
    import ray_tpu_torch.serve.handle as TH
    import ray_tpu_torch.util.prefix_hash as TPH

    prefix = list(range(1, 97))

    def run(H, PH):
        def router(counts, digests):
            r = H._RouterState("app", "dep")
            r.replicas = [(rid, object()) for rid in counts]
            r.counts = dict(counts)
            r.kv_digests = {k: frozenset(v) for k, v in digests.items()}
            return r

        out = []
        d = PH.prompt_digests(prefix + [60, 61])
        for counts, digests in (
                ({"a": 0, "b": 0}, {"a": d, "b": []}),
                ({"a": 5, "b": 0}, {}),
                ({"warm": H._AFFINITY_SLACK + 3, "cold": 0},
                 {"warm": d, "cold": []}),
                ({"a": 0, "b": 0}, {"a": d, "b": [d[-1]]})):
            r = router(counts, digests)
            picks = []
            for _ in range(16):
                rid, _ = r.pick(None, d)
                picks.append(rid)
                r.complete(rid)
            out.append(picks)
        return out

    want, got = run(JH, JPH), run(TH, TPH)
    assert got == want
    assert got[0] == ["a"] * 16 and got[2] == ["cold"] * 16


def test_config_and_schema_helpers_match_jax():
    """The config dataclasses' defaults and validation, and the schema's
    override fields."""
    from ray_tpu.serve import config as jc, schema as js
    from ray_tpu_torch.serve import config as tc, schema as ts

    for name in ("AutoscalingConfig", "DeploymentConfig", "HTTPOptions"):
        j, t = getattr(jc, name), getattr(tc, name)
        assert ([(f.name, f.default) for f in dataclasses.fields(t)]
                == [(f.name, f.default) for f in dataclasses.fields(j)])
    assert tc.DEFAULT_HTTP_PORT == jc.DEFAULT_HTTP_PORT
    assert ts._OVERRIDE_FIELDS == js._OVERRIDE_FIELDS
    for bad in ({"target_queue_depth": 0}, {"min_replicas": 3,
                                            "max_replicas": 2}):
        errs = []
        for mod in (jc, tc):
            try:
                mod.AutoscalingConfig(**bad).validate()
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1] is not None
