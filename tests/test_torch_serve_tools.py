"""The serve legs of the port's benches on the port's cluster, at
`debug` on the CPU: ``tools/kv_bench.py``'s legs 2 and 3 (the
shared-prefix trace through serve handles, cold and warm at equal load,
warm at twice the load) and ``tools/stream_bench.py``'s push and pull legs
with the RPC sweep. Each artifact holds every key of JAX's committed one,
nested keys included."""

import json
import pathlib

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve as tserve

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=6, num_gpus=0)
    yield
    try:
        tserve.shutdown()
    finally:
        tserve._forget_controller_for_tests()
        ray_tpu_torch.shutdown()


def _artifact_keys(name, drop=()):
    art = json.loads((ROOT / name).read_text())
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in art.items() if k not in drop}


def _check_keys(art, name, drop=()):
    want = _artifact_keys(name, drop)
    got = {k: sorted(v) if isinstance(v, dict) else None
           for k, v in art.items() if k in want}
    for k in want:
        assert k in got, (name, k)
        if want[k] is not None:
            assert set(want[k]) <= set(got[k]), (name, k)


def test_kv_bench_serve_legs_write_jax_keys(cluster, monkeypatch, capsys):
    """kv_bench's legs 2 and 3 at `debug` on the cluster already up:
    every key of JAX's committed ``BENCH_KV_r10.json``."""
    from ray_tpu_torch.tools import kv_bench

    for k, v in dict(PREFIX="32", ENG_PREFIX="32", SUFFIX="4", NEW="4",
                     SLOTS="2", RPS="2", SECS="1", ROUNDS="1").items():
        monkeypatch.setenv(f"RT_KV_BENCH_{k}", v)
    assert kv_bench.main(["--device", "cpu", "--serve"]) == 0
    kv = json.loads(capsys.readouterr().out)
    _check_keys(kv, "BENCH_KV_r10.json")
    assert kv["hits_advancing"] and kv["serve"]["warm"]["completed"] > 0


def test_stream_bench_serve_legs_write_jax_keys(cluster, monkeypatch,
                                                capsys):
    """stream_bench's push and pull legs with the RPC sweep at `debug`:
    every key of JAX's committed ``BENCH_STREAM_r07.json`` but
    ``broadcast_100mb``, from a leg JAX's script no longer runs."""
    from ray_tpu_torch.tools import stream_bench

    for k, v in dict(STREAMS="2", TOKENS="8", SLOTS="2").items():
        monkeypatch.setenv(f"RT_STREAM_BENCH_{k}", v)
    assert stream_bench.main(["--device", "cpu", "--serve"]) == 0
    st = json.loads(capsys.readouterr().out)
    _check_keys(st, "BENCH_STREAM_r07.json", ("broadcast_100mb",))
    assert st["push"]["transport"] == "push"
    assert st["pull"]["transport"] == "pull"
    assert st["push_rpcs_constant"]
