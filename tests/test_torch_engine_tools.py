"""The port's engine benches (``ray_tpu_torch/tools/kv_bench.py`` leg 1,
``stream_bench.py`` leg 1) beside the JAX package's ``_engine_ttft_leg``
and ``_engine_leg`` at the same arguments (JAX's engine needs no
runtime).

CPU, the ``debug`` preset, a few requests. The results carry the same
keys; the warm leg's prefix cache sees the same hits, misses and pages;
every stream's token count is exact (each leg checks its own). The warm
budget is JAX's 256 MiB where one prefix fits, and grows to the pages of
one prefix where it does not (the 7b preset). Both tools refuse their
runtime legs naming ROADMAP item R, print the artifact without an
``RT_*_BENCH_OUT`` path and write no file then, and refuse a
``BENCH_*.json`` path. Times are never compared.
"""

import json

import pytest
import torch

from ray_tpu.scripts import kv_bench as jkv
from ray_tpu.scripts import stream_bench as jstream
from ray_tpu_torch.tools import kv_bench as tkv
from ray_tpu_torch.tools import stream_bench as tstream

# prefix, suffix, new, slots, stride, requests
KV_ARGS = (128, 4, 4, 2, 2, 3)
# slots, max_len, stride, streams, tokens
STREAM_ARGS = (2, 16 + 6, 2, 5, 6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def test_kv_leg_matches_jax():
    seen = []
    got = tkv._engine_ttft_leg("debug", *KV_ARGS, device="cpu",
                               observe=lambda *a: seen.append(a[:3]))
    want = jkv._engine_ttft_leg("debug", *KV_ARGS)
    assert _keys(got) == _keys(want)
    assert got["warm"]["kv"]["hits"] == want["warm"]["kv"]["hits"] \
        == KV_ARGS[-1] + 1
    for k in ("misses", "pages", "evictions"):
        assert got["warm"]["kv"][k] == want["warm"]["kv"][k], k
    assert {k: got[k] for k in ("requests", "prefix_tokens",
                                "suffix_tokens")} \
        == {k: want[k] for k in ("requests", "prefix_tokens",
                                 "suffix_tokens")}
    # every timed request observed, each prompt clamped into the vocab
    assert [s[0] for s in seen] == ["cold"] * 3 + ["warm"] * 3
    assert all(len(p) == 132 and p.max() < 256 and 0 <= t < 256
               for _, p, t in seen)


def test_warm_budget_holds_one_prefix():
    assert tkv.warm_kv_bytes("debug", 1024, 4, 8) == tkv.WARM_KV_BYTES \
        == 256 << 20
    # 7b: 32 layers x K and V x 32 heads x 128 x 2 bytes a token, 1024
    # chunk-aligned tokens of prompt and output
    assert tkv.warm_kv_bytes("7b", 1024, 4, 8) == 512 << 20
    assert tkv.warm_kv_bytes("7b", 1024, 60, 8) == (512 + 32) << 20


def test_stream_leg_matches_jax():
    got = tstream._engine_leg("debug", *STREAM_ARGS, device="cpu")
    want = jstream._engine_leg("debug", *STREAM_ARGS)
    assert set(got) == set(want)
    assert {k: got[k] for k in ("streams", "tokens_per_stream")} \
        == {k: want[k] for k in ("streams", "tokens_per_stream")} \
        == {"streams": 5, "tokens_per_stream": 6}
    assert got["tok_s"] > 0


def test_tools_print_without_out_and_write_nothing(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    for k, v in {"RT_KV_BENCH_ENG_PREFIX": "64", "RT_KV_BENCH_NEW": "2",
                 "RT_KV_BENCH_SLOTS": "2", "RT_STREAM_BENCH_STREAMS": "3",
                 "RT_STREAM_BENCH_TOKENS": "4",
                 "RT_STREAM_BENCH_SLOTS": "2"}.items():
        monkeypatch.setenv(k, v)
    assert tkv.main(["--device", "cpu"]) == 0
    kv = json.loads(capsys.readouterr().out)
    assert kv["schema"] == "rt-kv-bench-1"
    assert kv["engine_ttft"]["requests"] == tkv.REQUESTS == 24
    assert kv["engine_ttft"]["warm"]["kv"]["hits"] == tkv.REQUESTS + 1
    assert set(kv["engine_ttft"]) == {"requests", "prefix_tokens",
                                      "suffix_tokens", "cold", "warm",
                                      "ttft_collapse_x"}
    assert kv["ttft_collapse_x_engine"] == kv["engine_ttft"][
        "ttft_collapse_x"]
    assert tstream.main(["--device", "cpu"]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["schema"] == "rt-stream-bench-1"
    assert st["raw_engine"]["streams"] == 3
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("RT_STREAM_BENCH_OUT", "s.json")
    assert tstream.main(["--device", "cpu"]) == 0
    assert json.loads((tmp_path / "s.json").read_text())["raw_engine"][
        "tokens_per_stream"] == 4


def test_tools_refuse_runtime_legs_and_bench_files(tmp_path, monkeypatch):
    """A ``BENCH_*.json`` output is refused before any work, the serve
    legs (``--serve``, which start a cluster) included; the serve legs
    themselves run in tests/test_torch_serve_llm.py."""
    monkeypatch.chdir(tmp_path)
    for tool, knob, name in (
            (tkv, "RT_KV_BENCH_OUT", "BENCH_KV_r10.json"),
            (tstream, "RT_STREAM_BENCH_OUT", "BENCH_STREAM_r07.json")):
        monkeypatch.setenv(knob, name)
        for argv in (["--device", "cpu"], ["--device", "cpu", "--serve"]):
            with pytest.raises(SystemExit, match="BENCH_"):
                tool.main(argv)
    assert list(tmp_path.iterdir()) == []
