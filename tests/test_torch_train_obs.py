"""ray_tpu_torch's train flight recorder and step profiler against the JAX
package's.

One scripted sequence of launch records with fixed times goes into JAX's
``TrainRecorder`` and into the port's: ``summary()``, ``window_summary()``
and ``launches()`` must be equal (less the recorder's self-timing). The
same for ``step_profiler.record`` and ``summary``. Fields derived from the
peak are compared times their peak wherever a side uses its default:
JAX's default on the CPU is its placeholder (``ray_tpu/util/flops.py``),
the port's the H100's bf16 rate. A drain pass must hand the port's sinks
what the JAX drain pushes into its metrics registry and GCS. Then the
port's driver on the CPU: every fused launch recorded and closed, the
profiler's launch counts joined to the recorder's. (The done-hook on a
card is tests/test_torch_train_cuda.py's.)
"""

import json
import time

import jax  # noqa: F401 — keeps JAX's platform set before ray_tpu loads
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu.util import recorder_core as JRC
from ray_tpu.util import step_profiler as JSP
from ray_tpu.util import train_recorder as JTR
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train.driver import StepDriver
from ray_tpu_torch.util import step_profiler as TSP
from ray_tpu_torch.util import train_recorder as TTR
from ray_tpu_torch.util.recorder_core import Sinks

SELF_TIMED = ("overhead_s", "overhead_frac")
MFU_FIELDS = ("raw_mfu", "achieved_mfu", "marginal_mfu", "marginal_mfu_mean")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def profilers():
    """Both step profilers reset, their launch sources set aside."""
    saved = (dict(JSP._launch_sources), dict(TSP._launch_sources))
    for sp in (JSP, TSP):
        sp.reset()
        sp._launch_sources.clear()
    yield
    for sp, src in zip((JSP, TSP), saved):
        sp.reset()
        sp._launch_sources.clear()
        sp._launch_sources.update(src)


def _script(rec, flops=1.0):
    """Fused launches at fixed times (t0 = 1000 s): a compile launch, a
    gap, a dry reset, host tax, an explicit loader_dry, and a launch whose
    done-hook never fires (in flight). ``flops`` scales the analytic
    FLOPs."""
    s1 = rec.record_launch(t_start=1000.0, data_wait_s=0.2, h2d_s=0.1,
                           dispatch_s=0.0, compile_s=0.1,
                           t_dispatch_end=1000.4, flops=0.2e9 * flops, k=4,
                           tokens=256, batch_shape=(4, 2, 33))
    rec.finalize_launch(s1, 1000.5)
    s2 = rec.record_launch(t_start=1000.5, data_wait_s=0.1, h2d_s=0.0,
                           dispatch_s=0.1, data_ready_t=1000.45,
                           t_dispatch_end=1000.7, flops=0.3e9 * flops, k=4,
                           tokens=256, batch_shape=(4, 2, 33))
    rec.add_host_tax(s2, 0.05)
    rec.finalize_launch(s2, 1000.9)
    s3 = rec.record_launch(t_start=1001.0, data_wait_s=0.3, h2d_s=0.01,
                           dispatch_s=0.02, data_ready_t=1001.2,
                           t_dispatch_end=1001.33, flops=0.1e9 * flops,
                           k=4, tokens=256, batch_shape=(4, 2, 33))
    rec.finalize_launch(s3, 1001.6)
    rec.loader_dry()
    s4 = rec.record_launch(t_start=1002.0, data_wait_s=0.01, h2d_s=0.0,
                           dispatch_s=0.05, data_ready_t=1001.0,
                           flops=0.2e9 * flops, k=2, tokens=128,
                           batch_shape=(2, 2, 33))
    rec.add_host_tax(s4, 0.02)
    rec.finalize_launch(s4, 1002.3)
    rec.record_launch(t_start=1003.0, data_wait_s=0.01, h2d_s=0.0,
                      dispatch_s=0.05, flops=0.1e9 * flops, k=4, tokens=256,
                      batch_shape=(4, 2, 33))


def _pair(name, **kw):
    j = JTR.TrainRecorder(name, enabled=True, **kw)
    t = TTR.TrainRecorder(name, enabled=True, **kw)
    return j, t


def _strip(summary):
    return {k: v for k, v in summary.items() if k not in SELF_TIMED}


def test_scripted_summaries_equal():
    j, t = _pair("script", n_devices=1, peak_flops=1e9)
    try:
        for rec in (j, t):
            _script(rec)
        sj, st = j.summary(), t.summary()
        assert _strip(st) == _strip(sj)
        assert st["window_launches"] == 4 and st["in_flight"] == 1
        assert st["dry_resets"] == 2 and st["compiles"] == 1
        assert "waterfall" in st and st["launch_gap_max_s"] > 0
        for t0, t1 in ((999.0, 1001.0), (1000.6, 1003.5), (0.0, 999.0),
                       (0.0, 1e4)):
            assert t.window_summary(t0, t1) == j.window_summary(t0, t1)
        assert t.launches() == j.launches()
        assert t.launches(2) == j.launches(2)
        sj_snap, st_snap = j.snapshot(), t.snapshot()
        assert st_snap["launches"] == sj_snap["launches"]
    finally:
        j.close()
        t.close()


def test_default_peak_mfu_times_peak_equal():
    """Each side's default peak: the MFU fields times the peak they were
    divided by agree (JAX's CPU placeholder against the H100's rate)."""
    j, t = _pair("peak", n_devices=1)
    try:
        assert t._peak_total() == 989e12
        for rec in (j, t):
            _script(rec, flops=1e6)
        sj, st = j.summary(), t.summary()
        pj, pt = j._peak_total(), t._peak_total()
        for f in MFU_FIELDS:
            assert st[f] * pt == pytest.approx(sj[f] * pj, rel=1e-5), f
        for a, b in zip(st["marginal_mfu_recent"], sj["marginal_mfu_recent"]):
            assert a * pt == pytest.approx(b * pj, rel=1e-5)
        for b_, v in st["waterfall"]["mfu_cost"].items():
            assert v * pt == pytest.approx(
                sj["waterfall"]["mfu_cost"][b_] * pj, rel=1e-5, abs=1e-3)
        drop = set(MFU_FIELDS) | {"marginal_mfu_recent", "waterfall"}
        assert {k: v for k, v in _strip(st).items() if k not in drop} == \
            {k: v for k, v in _strip(sj).items() if k not in drop}
        assert st["waterfall"]["buckets_s"] == sj["waterfall"]["buckets_s"]
    finally:
        j.close()
        t.close()


def test_kill_switch_records_nothing():
    rec = TTR.TrainRecorder("off", enabled=False)
    try:
        seq = rec.record_launch(t_start=0.0, data_wait_s=1.0, h2d_s=0.0,
                                dispatch_s=1.0)
        assert seq == 0
        rec.watch_outputs(seq, {"loss": torch.ones(1)})
        rec.add_host_tax(seq, 1.0)
        rec.finalize_launch(seq, 2.0)
        rec.loader_dry()
        assert not rec.launches()
        s = rec.summary()
        assert s["launches_total"] == 0 and s["window_launches"] == 0
    finally:
        rec.close()


def _profile_script(sp):
    sp.record("train", name="1b", t_start=500.0, wall_s=2.0, compile_s=1.5,
              execute_s=0.5, tokens=4096, flops=4e12, first_call=True,
              steps=4, meta={"k": 4})
    sp.record("train", name="1b", t_start=502.0, wall_s=1.0,
              dispatch_s=0.3, execute_s=0.7, tokens=4096, flops=4e12,
              steps=4)
    sp.record("train", name="1b", t_start=503.0, wall_s=0.25,
              dispatch_s=0.1, execute_s=0.15, tokens=1024, flops=1e12)
    sp.record("decode", t_start=504.0, wall_s=0.01, launches=8, tokens=8)


def test_profiler_records_and_summary_equal(profilers):
    for sp in (JSP, TSP):
        _profile_script(sp)
    pj, pt = JSP._peak_total(), TSP._peak_total()
    for kind in ("train", "decode", None):
        sj, st = JSP.summary(kind), TSP.summary(kind)
        assert st.pop("mean_mfu") * pt == pytest.approx(
            sj.pop("mean_mfu") * pj, rel=1e-9)
        assert st == sj, kind
    rj, rt = JSP.records(), TSP.records()
    assert len(rt) == len(rj) == 4
    for a, b in zip(rt, rj):
        a, b = a.to_dict(), b.to_dict()
        assert a.pop("mfu") * pt == pytest.approx(b.pop("mfu") * pj,
                                                  rel=1e-9)
        assert a == b
    assert TSP.summary("nothing") == JSP.summary("nothing") == {}


def test_profiled_call_compile_then_dispatch(profilers):
    TSP.enable()
    try:
        key = ("train", "test")
        for _ in range(2):
            out = TSP.profiled_call("train", lambda x: {"loss": x * 2},
                                    (torch.ones(3),), key=key, tokens=10,
                                    flops=1e6)
            assert torch.equal(out["loss"], torch.full((3,), 2.0))
        first, second = TSP.records("train")
        assert first.first_call and first.compile_s > 0 \
            and first.dispatch_s == 0
        assert not second.first_call and second.compile_s == 0 \
            and second.dispatch_s > 0
        assert first.hbm_peak_bytes == 0    # no CUDA here
    finally:
        TSP.disable()
    assert TSP.profiled_call("train", lambda: 7, key=key) == 7
    assert len(TSP.records()) == 2          # disabled: nothing recorded


class _Recording:
    """What a drain pushes: JAX's through monkeypatched handles and a
    stand-in cluster backend, the port's through its sinks."""

    def __init__(self):
        self.metrics, self.events, self.kv = [], [], []

    def handles(self, roles):
        rec = self

        class Handle:
            def __init__(self, series):
                self.series = series

            def observe(self, v, tags):
                rec.metrics.append((self.series, "observe", v, tags))

            def inc(self, v, tags):
                rec.metrics.append((self.series, "inc", v, tags))

            def set(self, v, tags):
                rec.metrics.append((self.series, "set", v, tags))

        return {role: Handle(series) for role, series in roles.items()}

    def backend(self):
        rec = self

        class Gcs:
            def call(self, name, payload):
                assert name == "task_events"
                return payload["events"]

        class Io:
            def run(self, events):
                rec.events.append(events)

        class Backend:
            _gcs, io = Gcs(), Io()

            def kv_put(self, key, value):
                rec.kv.append((key, value))

            def kv_del(self, key):
                pass

        return Backend()

    def sinks(self):
        return Sinks(metric=lambda *a: self.metrics.append(a),
                     kv_put=lambda key, value: self.kv.append((key, value)),
                     events=self.events.append)


def test_recorder_drain_matches_jax(monkeypatch):
    jrec, trec = _Recording(), _Recording()
    monkeypatch.setattr(JTR, "_metric_handles",
                        lambda _m: jrec.handles(TTR.SERIES))
    backend = jrec.backend()
    monkeypatch.setattr(JRC, "cluster_backend", lambda: backend)
    j = JTR.TrainRecorder("drain", enabled=True, n_devices=1,
                          peak_flops=1e9)
    t = TTR.TrainRecorder("drain", enabled=True, n_devices=1,
                          peak_flops=1e9, sinks=trec.sinks())
    try:
        for rec in (j, t):
            _script(rec)
        assert t.drain_now() == j.drain_now()
        norm = lambda ms: [(s, op, None if s == TTR.SERIES["overhead"]
                            else v, tags) for s, op, v, tags in ms]
        assert norm(trec.metrics) == norm(jrec.metrics) and trec.metrics
        assert trec.events == jrec.events and trec.events
        snaps = [[(k, _strip_snapshot(v)) for k, v in r.kv]
                 for r in (trec, jrec)]
        assert snaps[0] == snaps[1] and snaps[0]
        # watermarked: a second pass pushes no launch twice
        assert t.drain_now() == j.drain_now() == {"metrics": 0, "kv": 1,
                                                  "events": 0}
    finally:
        j.close()
        t.close()


def _strip_snapshot(value):
    snap = json.loads(value)
    snap.pop("t")
    snap["summary"] = _strip(snap["summary"])
    return snap


def test_profiler_drain_matches_jax(profilers, monkeypatch):
    jrec, trec = _Recording(), _Recording()
    monkeypatch.setattr(JSP, "_hists", jrec.handles(TSP.SERIES))
    backend = jrec.backend()

    class Worker:
        def _require_backend(self):
            return backend

    monkeypatch.setattr(ray_tpu, "is_initialized", lambda: True)
    monkeypatch.setattr(ray_tpu, "global_worker", lambda: Worker())
    for sp in (JSP, TSP):
        _profile_script(sp)
    assert TSP.drain(trec.sinks()) == JSP.drain() == 4
    pj, pt = JSP._peak_total(), TSP._peak_total()

    def norm_metric(m, peak):
        s, op, v, tags = m
        return (s, op, v * peak if s == TSP.SERIES["mfu"] else v, tags)

    got = [norm_metric(m, pt) for m in trec.metrics]
    want = [norm_metric(m, pj) for m in jrec.metrics]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[3] == w[3]
        assert g[2] == pytest.approx(w[2], rel=1e-9)

    def norm_event(e, peak):
        e = json.loads(json.dumps(e))
        e["task_id"] = e["task_id"].rsplit(":", 2)[0]   # epoch:seq
        e["profile"]["mfu"] *= peak
        return e

    [got], [want] = trec.events, jrec.events
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = norm_event(g, pt), norm_event(w, pj)
        assert g["profile"].pop("mfu") == pytest.approx(
            w["profile"].pop("mfu"), rel=1e-9)
        assert g == w
    assert [e["profile"]["seq"] for e in got] == [1, 2, 3, 4]
    assert TSP.drain(trec.sinks()) == 0     # watermarked


def test_driver_records_every_fused_launch_and_joins_profiler(profilers):
    """The port's driver on the CPU with the profiler on: K = 2 over 8
    batches and a tail of 1; every fused launch recorded, closed by the
    done-hook, its phases partitioning its wall; the profiler's train
    summary reads the recorder's launch counts."""
    cfg = tllama.PRESETS["debug"]
    opt = tts.default_optimizer(total_steps=100)
    params, state = tts.init_state(
        cfg, opt, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, 256, (2, 17)).astype(np.int32)}
               for _ in range(9)]
    TSP.enable()
    try:
        drv = StepDriver(cfg, opt, steps_per_launch=2, device="cpu")
        taxes = []
        drv.run(params, state, iter(batches),
                on_launch=lambda m: taxes.append(float(m["loss"].reshape(-1)
                                                       [-1])))
    finally:
        TSP.disable()
    rec = drv.recorder
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and rec.summary()["in_flight"]:
        time.sleep(0.01)
    try:
        summ = rec.summary()
        assert len(taxes) == 5 and summ["in_flight"] == 0
        assert summ["window_launches"] == summ["launches_total"] == 4
        assert summ["steps"] == 8 and summ["compiles"] == 1
        assert 0.90 <= summ["phase_sum_ratio"] <= 1.05, summ
        recs = rec.launches()
        assert recs[0]["phases"]["compile"] > 0 \
            and recs[0]["phases"]["dispatch"] == 0
        assert recs[-1]["phases"]["dispatch"] > 0 \
            and recs[-1]["phases"]["compile"] == 0
        assert all(r["k"] == 2 and r["batch_shape"] == [2, 2, 17]
                   and r["tokens"] == 64 and r["flops"] > 0 for r in recs)
        # the join counts every live recorder of the process, this one's
        # 4 launches of 2 steps among them
        joined = TTR._profiler_launch_join()
        assert joined["launches"] >= 4 and joined["steps"] >= 8
        prof = TSP.summary("train")
        assert prof["launch_source"] == "recorder"
        assert (prof["launches"], prof["steps"]) == (joined["launches"],
                                                     joined["steps"])
        assert prof["records"] == 5        # 4 fused + the tail's 1 step
    finally:
        rec.close()
