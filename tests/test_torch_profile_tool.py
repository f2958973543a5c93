"""``rt profile`` in the port (``ray_tpu_torch/tools/profile.py``) and the
generate paths' step-profiler records against the JAX package's.

CPU, the ``debug`` and ``moe-debug`` presets, torch on one thread. The
FLOP formulas equal JAX's for every preset; with both profilers enabled,
``generate``, ``generate_speculative`` and ``generate_stream`` write the
same record kinds, counts, tokens, FLOPs, meta and first-call flags as
JAX's (called directly, no runtime), and ``_run_train`` the same as JAX's
at K = 1 and K = 4; times are never compared. The table, the step lanes
and the artifact's keys are JAX's; ``--address`` is refused naming R.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as JG
from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.scripts import profile as jprofile
from ray_tpu.util import flops as JF
from ray_tpu.util import step_profiler as jprof
from ray_tpu.util import timeline as jtimeline
from ray_tpu_torch.models import generate as TG
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.tools import profile as tprofile
from ray_tpu_torch.util import flops as TF
from ray_tpu_torch.util import step_profiler as tprof
from ray_tpu_torch.util import timeline as ttimeline
from ray_tpu_torch.util.memory import HBM_GAUGE, publish_hbm_gauges

PRESETS = sorted(jllama.PRESETS) + sorted(jmoe.PRESETS)
# what a record must share with JAX's: everything but times and memory
SAME = ("kind", "step", "launches", "steps", "tokens", "flops", "meta",
        "first_call")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def profilers():
    """Both step profilers reset and enabled for the test, then off."""
    for p in (jprof, tprof):
        p.reset()
        p.enable()
    yield
    for p in (jprof, tprof):
        p.disable()
        p.reset()


def _cfgs(preset):
    jfam, tfam = ((jllama, tllama) if preset in jllama.PRESETS
                  else (jmoe, tmoe))
    return (dataclasses.replace(jfam.PRESETS[preset],
                                compute_dtype=jnp.float32),
            dataclasses.replace(tfam.PRESETS[preset],
                                compute_dtype=torch.float32))


def _params(jcfg, tcfg, seed=0):
    fam = jmoe if isinstance(jcfg, jmoe.MoEConfig) else jllama
    jp = fam.init_params(jax.random.key(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               device="cpu")


def _view(records):
    return [{k: getattr(r, k) for k in SAME} for r in records]


def _assert_records_equal(got, want):
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    for g, w in zip(got, want):
        flops = g.pop("flops"), w.pop("flops")
        assert flops[0] == pytest.approx(flops[1], rel=1e-12)
        assert g == w


@pytest.mark.parametrize("preset", PRESETS)
def test_generation_flops_equal_jax(preset):
    jcfg, tcfg = _cfgs(preset)
    for ctx in (1, 77, 2048):
        assert TF.decode_flops_per_token(tcfg, ctx) \
            == JF.decode_flops_per_token(jcfg, ctx)
    for b, s in ((1, 1), (4, 128), (8, 2048)):
        assert TF.prefill_flops(tcfg, b, s) == JF.prefill_flops(jcfg, b, s)
        for n in (1, 16, 33):
            assert TF.generate_flops(tcfg, b, s, n) \
                == JF.generate_flops(jcfg, b, s, n)
    assert TF.train_step_flops(tcfg, 4, 128) \
        == JF.train_step_flops(jcfg, 4, 128)


@pytest.mark.parametrize("preset", ["debug", "moe-debug"])
def test_generate_and_stream_records_match_jax(preset, profilers):
    jcfg, tcfg = _cfgs(preset)
    jp, tp = _params(jcfg, tcfg)
    prompt = np.random.default_rng(0).integers(0, 256, (2, 5), np.int32)
    for _ in range(2):   # the second call of each key is no first call
        JG.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=4)
        TG.generate(tp, prompt, tcfg, max_new_tokens=4, device="cpu")
    for _ in range(2):
        jtoks = [np.asarray(t) for t in JG.generate_stream(
            jp, jnp.asarray(prompt), jcfg, max_new_tokens=4)]
        ttoks = [t.numpy() for t in TG.generate_stream(
            tp, prompt, tcfg, max_new_tokens=4, device="cpu")]
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
    want, got = _view(jprof.records()), _view(tprof.records())
    assert [r["kind"] for r in got] == ["generate"] * 2 + (
        ["prefill"] + ["decode"] * 3) * 2
    _assert_records_equal(got, want)


def test_speculative_records_match_jax(profilers):
    jcfg, tcfg = _cfgs("debug")
    jp, tp = _params(jcfg, tcfg)
    jdcfg = dataclasses.replace(jcfg, n_layers=1)
    tdcfg = dataclasses.replace(tcfg, n_layers=1)
    jdp, tdp = _params(jdcfg, tdcfg, seed=2)
    prompt = np.random.default_rng(1).integers(0, 256, (2, 6), np.int32)
    for _ in range(2):
        jout = JG.generate_speculative(jp, jdp, jnp.asarray(prompt), jcfg,
                                       jdcfg, max_new_tokens=5)
        tout = TG.generate_speculative(tp, tdp, prompt, tcfg, tdcfg,
                                       max_new_tokens=5, device="cpu")
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    got = _view(tprof.records())
    assert [r["kind"] for r in got] == ["speculative"] * 2
    assert got[0]["meta"] == {"batch": 2, "prompt_len": 6, "speculate_k": 4}
    _assert_records_equal(got, _view(jprof.records()))


def test_disabled_profiler_records_nothing():
    tprof.disable()
    tprof.reset()
    jcfg, tcfg = _cfgs("debug")
    _, tp = _params(jcfg, tcfg)
    prompt = np.zeros((1, 3), np.int64)
    TG.generate(tp, prompt, tcfg, max_new_tokens=2, device="cpu")
    list(TG.generate_stream(tp, prompt, tcfg, max_new_tokens=2,
                            device="cpu"))
    TG.generate_speculative(tp, tp, prompt, tcfg, tcfg, max_new_tokens=2,
                            device="cpu")
    assert tprof.records() == []


@pytest.mark.parametrize("k,steps", [(1, 2), (4, 5)])
def test_run_train_records_match_jax(k, steps, profilers):
    """K = 1: ``make_train_step`` per step; K = 4 over 5 batches: one
    fused launch of 4 steps and a single-step tail, as JAX's driver."""
    jcfg, tcfg = _cfgs("debug")
    jprofile._run_train(jcfg, steps, 2, 16, k)
    tprofile._run_train(tcfg, steps, 2, 16, k, device="cpu")
    got, want = _view(tprof.records()), _view(jprof.records())
    assert [(r["launches"], r["steps"]) for r in got] == (
        [(1, 1)] * 2 if k == 1 else [(1, 4), (1, 1)])
    _assert_records_equal(got, want)


def _scripted(mod):
    """The same three records in ``mod``'s StepRecord."""
    base = dict(name="", seq=0, t_start=1000.0, first_call=False, meta={},
                tokens_per_s=0.0, mfu=0.0)
    rows = [dict(kind="train", step=0, wall_s=1.5, compile_s=1.2,
                 dispatch_s=0.0, execute_s=0.3, launches=1, tokens=4096,
                 flops=1e12, tokens_per_s=2730.7, mfu=0.21,
                 hbm_peak_bytes=123456789, steps=4, first_call=True),
            dict(kind="decode", step=7, wall_s=0.0123, compile_s=0.0,
                 dispatch_s=0.011, execute_s=0.0013, launches=1, tokens=8,
                 flops=2e9, tokens_per_s=650.4, mfu=0.0011,
                 hbm_peak_bytes=0, steps=1),
            dict(kind="speculative", step=2, wall_s=0.25, compile_s=0.0,
                 dispatch_s=0.2, execute_s=0.05, launches=3, tokens=64,
                 flops=0.0, hbm_peak_bytes=0, steps=1)]
    return [mod.StepRecord(**dict(base, seq=i + 1, **r))
            for i, r in enumerate(rows)]


def test_fmt_table_equals_jax():
    assert tprofile._fmt_table(_scripted(tprof)) \
        == jprofile._fmt_table(_scripted(jprof))


def test_step_lanes_equal_jax(tmp_path):
    events = [{"task_id": f"step:n:1:0:{r.seq}", "name": r.kind,
               "node_id": "n", "profile": r.to_dict()}
              for r in _scripted(tprof)]
    for ev in events:
        assert ttimeline.step_lanes(ev, ev["profile"]) \
            == jtimeline._step_lanes(ev, ev["profile"])
    trace = ttimeline.step_timeline(events + [{"task_id": "t"}],
                                    str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == trace
    # a step span each, a compile span for the first call, a sync each
    assert sorted(t["cat"] for t in trace) == ["compile"] + ["step"] * 3 \
        + ["sync"] * 3


def test_profiler_drain_feeds_the_timeline(profilers):
    from ray_tpu_torch.util.recorder_core import Sinks

    tprof.record("train", wall_s=0.5, compile_s=0.2, execute_s=0.1)
    tprof.record("decode", wall_s=0.01, execute_s=0.002)
    events = []
    assert tprof.drain(Sinks(events=events.extend)) == 2
    trace = ttimeline.step_timeline(events)
    assert [t["tid"] for t in trace if t["cat"] == "step"] \
        == ["step:train", "step:decode"]


def test_hbm_gauges_go_to_the_sink():
    seen = []
    publish_hbm_gauges(lambda *a: seen.append(a),
                       [{"device": 0, "bytes_in_use": 5},
                        {"device": 1, "bytes_in_use": None}])
    assert seen == [(HBM_GAUGE, "set", 5.0, {"device": "cuda:0"})]
    publish_hbm_gauges(lambda *a: 1 / 0, [{"device": 0, "bytes_in_use": 5}])


def _artifact(out: str) -> dict:
    start = out.index("\n{\n") + 1
    return json.JSONDecoder().raw_decode(out[start:])[0]


@pytest.mark.parametrize("mode,extra", [
    ("train", ["--steps", "2", "--steps-per-launch", "2"]),
    ("stream", ["--steps", "1", "--new-tokens", "3"])])
def test_main_prints_jax_artifact(mode, extra, tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tprofile.main(["--device", "cpu", "--mode", mode, "--seq",
                            "8", "--batch", "2", "--json", "-", "--out",
                            str(tmp_path / "trace.json")] + extra)
    assert rc == 0 and not tprof.is_enabled()
    out = buf.getvalue()
    art = _artifact(out)
    assert set(art) == {"schema", "t", "config", "platform", "records",
                        "summary"}
    assert art["schema"] == "rt-profile-v1"
    assert set(art["config"]) == {"preset", "mode", "steps", "batch", "seq",
                                  "new_tokens", "steps_per_launch"}
    assert art["platform"] == {"backend": "cpu", "devices": 1,
                               "name": "cpu"}
    jkeys = set(_scripted(jprof)[0].to_dict())
    assert all(set(r) == jkeys for r in art["records"])
    want = ["train"] if mode == "train" else ["prefill", "decode", "decode"]
    assert [r["kind"] for r in art["records"]] == want
    jprof.reset()
    for r in _scripted(jprof):
        jprof.record(r.kind, wall_s=r.wall_s, tokens=r.tokens,
                     flops=r.flops, first_call=r.first_call)
    assert set(art["summary"]) == set(jprof.summary())
    jprof.reset()
    assert "steady-state: wall" in out and "# rt_step_* metrics" in out
    assert 'rt_step_time_seconds_count{kind="%s"}' % want[-1] in out
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert sum(t["cat"] == "step" for t in trace) == len(want)
    if mode == "train":
        assert "launch amortization: 2.0 steps/launch" in out


def test_main_torch_trace_and_refusals(tmp_path, capsys):
    rc = tprofile.main(["--device", "cpu", "--mode", "generate", "--steps",
                        "1", "--seq", "4", "--batch", "1", "--new-tokens",
                        "2", "--no-metrics", "--torch-trace",
                        str(tmp_path / "tr")])
    assert rc == 0
    traces = list((tmp_path / "tr").glob("*.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    out = capsys.readouterr().out
    assert "rt_step_" not in out
    with pytest.raises(SystemExit, match="ROADMAP item R"):
        tprofile.main(["--address", "127.0.0.1:6379", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown preset"):
        tprofile.main(["--preset", "nope", "--device", "cpu"])
