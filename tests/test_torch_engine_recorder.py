"""ray_tpu_torch's engine flight recorder against the JAX package's.

One scripted sequence of record_tick / request_admitted / request_tokens /
request_done / record_swap calls with explicit times goes into JAX's
``EngineRecorder`` and into the port's: ``summary()`` and
``window_summary()`` must be equal (less the recorder's self-timing,
which measures each side's own wall), and a drain pass must hand the
port's sinks what the JAX drain pushes into its metrics registry, serve
span buffer and GCS. Then the ports of tests/test_zz_engine_obs.py's
cases on the port's engine (``device="cpu"``): phase sums, cached-prefill
attribution, the swap barrier, the span join; and on the recorder: SLO
math, window carving, boundedness and the kill switch."""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.serve import obs as jobs
from ray_tpu.util import engine_recorder as JER
from ray_tpu.util import recorder_core as JRC
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import serving as TS
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.util import engine_recorder as TER
from ray_tpu_torch.util.recorder_core import Sinks

SELF_TIMED = ("overhead_s", "overhead_frac")


def _script(rec):
    """Ticks and request lifecycles at fixed times (t0 = 1000 s)."""
    t0 = 1000.0
    rec.record_tick(t_start=t0, wall_s=0.020,
                    phases={"admission": 0.001, "prefill": 0.015,
                            "kv_restore": 0.002},
                    active=0, pending=1, bucket=0, k=0, tokens=1,
                    admitted=1, gap_s=None)
    rec.request_admitted(1, t_submit=t0 - 0.01, t_admit=t0 + 0.02,
                         prompt_tokens=40, cached_tokens=32,
                         prefill_s=0.015, kv_restore_s=0.002, slot=3,
                         obs_ctx={"request_id": "req-a", "span_id": "sp-a"})
    rec.request_admitted(2, t_submit=t0, t_admit=t0 + 0.05,
                         prompt_tokens=12, cached_tokens=0, prefill_s=0.03,
                         kv_restore_s=0.0, slot=1)
    for i in range(6):
        rec.record_tick(t_start=t0 + 0.1 + 0.01 * i, wall_s=0.008,
                        phases={"decode_step": 0.006,
                                "token_delivery": 0.001},
                        active=2 if i < 4 else 1, pending=0,
                        bucket=4 if i < 4 else 1, k=4 if i < 3 else 1,
                        tokens=8 if i < 3 else 2, admitted=0,
                        gap_s=None if i == 0 else 0.002 + 0.001 * i)
        rec.request_tokens(1, 4 if i < 3 else 1, t0 + 0.108 + 0.01 * i,
                           done=i == 4)
        if i < 3:
            rec.request_tokens(2, 4, t0 + 0.108 + 0.01 * i)
    rec.request_done(2, t=t0 + 0.2, state="cancelled")
    rec.record_swap(0.003)
    rec.record_tick(t_start=t0 + 0.3, wall_s=0.004,
                    phases={"swap_barrier": 0.003}, active=0, pending=0,
                    bucket=0, k=0, tokens=0, admitted=0, gap_s=None)
    rec.request_admitted(3, t_submit=t0 + 0.31, t_admit=t0 + 0.4,
                         prompt_tokens=20, cached_tokens=16,
                         prefill_s=0.05, kv_restore_s=0.001, slot=0,
                         obs_ctx={"request_id": "req-c", "span_id": "sp-c"})
    rec.request_tokens(3, 6, t0 + 0.45, done=True)


def _pair(**kw):
    j = JER.EngineRecorder("script", max_slots=4, enabled=True,
                           ttft_slo_s=0.05, tpot_slo_s=0.004, **kw)
    t = TER.EngineRecorder("script", max_slots=4, enabled=True,
                           ttft_slo_s=0.05, tpot_slo_s=0.004, **kw)
    for rec in (j, t):
        _script(rec)
    return j, t


def _strip(summary):
    out = {k: v for k, v in summary.items() if k not in SELF_TIMED}
    if "last_swap" in out:
        out["last_swap"] = {k: v for k, v in out["last_swap"].items()
                            if k != "t"}
    return out


def test_scripted_summaries_equal():
    j, t = _pair()
    try:
        assert _strip(t.summary()) == _strip(j.summary())
        for lo, hi in ((0.0, 2000.0), (1000.0, 1000.15), (1000.15, 1000.5),
                       (1000.3, 1001.0), (5.0, 6.0)):
            assert t.window_summary(lo, hi) == j.window_summary(lo, hi)
        assert t.ticks() == j.ticks()
        assert t.requests() == j.requests()
        snap_t, snap_j = t.snapshot(), j.snapshot()
        for s in (snap_t, snap_j):
            s.pop("t")
            s["summary"] = _strip(s["summary"])
        assert snap_t == snap_j
        assert TER.TICK_PHASES == JER.TICK_PHASES
    finally:
        j.close()
        t.close()


class _Recording:
    """Stand-ins for the JAX drain's pushes: metric handles, the serve
    span buffer and a cluster backend, each recording what it gets."""

    def __init__(self):
        self.metrics, self.spans, self.kv, self.events = [], [], [], []
        self.deleted = []

    def handles(self, _m):
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

        return {role: Handle(series) for role, series in TER.SERIES.items()}

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
                rec.deleted.append(key)

        return Backend()

    def sinks(self):
        return Sinks(
            metric=lambda *a: self.metrics.append(a),
            span=lambda task_id, name, **kw: self.spans.append(
                dict(kw, task_id=task_id, name=name)),
            kv_put=lambda key, value: self.kv.append((key, value)),
            kv_del=self.deleted.append,
            events=self.events.append)


def _norm_spans(spans):
    """Span ids are random on both sides: number them in order."""
    out = []
    for i, s in enumerate(spans):
        s = dict(s, span_id=f"span{i}")
        s["task_id"] = s["task_id"].rsplit(":", 1)[0]
        out.append(s)
    return out


def _norm_metrics(metrics):
    """The overhead gauge is self-timed: each side's own wall."""
    return [(series, op, None if series == TER.SERIES["overhead"] else v,
             tags) for series, op, v, tags in metrics]


def _norm_kv(kv):
    out = []
    for key, value in kv:
        snap = json.loads(value)
        snap.pop("t")
        snap["summary"] = _strip(snap["summary"])
        out.append((key, snap))
    return out


def test_sinks_receive_what_the_jax_drain_pushes(monkeypatch):
    jrec, trec = _Recording(), _Recording()
    monkeypatch.setattr(JER, "_metric_handles", jrec.handles)
    backend = jrec.backend()
    monkeypatch.setattr(JRC, "cluster_backend", lambda: backend)

    def emit_span(task_id, name, **kw):
        jrec.spans.append(dict(kw, task_id=task_id, name=name))

    monkeypatch.setattr(jobs, "emit_span", emit_span)
    j = JER.EngineRecorder("drain", max_slots=4, enabled=True,
                           ttft_slo_s=0.05, tpot_slo_s=0.004)
    t = TER.EngineRecorder("drain", max_slots=4, enabled=True,
                           ttft_slo_s=0.05, tpot_slo_s=0.004,
                           sinks=trec.sinks())
    try:
        for rec in (j, t):
            _script(rec)
        counts_j, counts_t = j.drain_now(), t.drain_now()
        assert counts_t == counts_j
        assert counts_t["metrics"] > 0 and counts_t["spans"] == 2
        assert _norm_metrics(trec.metrics) == _norm_metrics(jrec.metrics)
        assert _norm_spans(trec.spans) == _norm_spans(jrec.spans)
        assert [s["parent_span_id"] for s in trec.spans] == ["sp-a", "sp-c"]
        assert _norm_kv(trec.kv) == _norm_kv(jrec.kv)
        assert trec.events == jrec.events and trec.events
        # watermarked: a second pass pushes no record twice
        assert t.drain_now() == j.drain_now() == {
            "metrics": 0, "spans": 0, "kv": 1, "events": 0}
        assert len(trec.metrics) == len(jrec.metrics)
    finally:
        j.close()
        t.close()
    assert trec.deleted == jrec.deleted == [t._kv_key]


def test_drain_without_sinks_does_nothing():
    rec = TER.EngineRecorder("no-sinks", max_slots=2, enabled=True)
    try:
        _script(rec)
        assert rec.drain_now() == {"metrics": 0, "spans": 0, "kv": 0,
                                   "events": 0}
    finally:
        rec.close()

    def broken(*_a, **_k):
        raise OSError("sink down")

    rec = TER.EngineRecorder("broken", max_slots=2, enabled=True,
                             sinks=Sinks(kv_put=broken, events=broken,
                                         kv_del=broken))
    try:
        _script(rec)
        assert rec.drain_now() == {"metrics": 0, "spans": 0, "kv": 0,
                                   "events": 0}
        # the events were not lost: the next working sink gets them
        got = []
        rec.sinks = Sinks(events=got.append)
        assert rec.drain_now()["events"] == len(got[0]) > 0
    finally:
        rec.close()


# ---------------------------------------------------------------------------
# SLO/goodput math, windows, bounds, kill switch (synthetic records)
# ---------------------------------------------------------------------------


def _synthetic(mod):
    rec = mod.EngineRecorder("slo-math", max_slots=4, enabled=True,
                             ttft_slo_s=0.100, tpot_slo_s=0.010)
    t0 = 1000.0
    for rid, ttft, end in ((1, 0.050, 0.100), (2, 0.200, 0.250),
                           (3, 0.050, 0.550)):
        rec.request_admitted(rid, t_submit=t0, t_admit=t0 + ttft,
                             prompt_tokens=8, cached_tokens=0,
                             prefill_s=ttft - 0.01, kv_restore_s=0.0)
        rec.request_tokens(rid, 10, t0 + end, done=True)
    rec.request_admitted(4, t_submit=t0, t_admit=t0 + 0.010,
                         prompt_tokens=8, cached_tokens=0,
                         prefill_s=0.005, kv_restore_s=0.0)
    rec.request_done(4, t=t0 + 0.020, state="cancelled")
    return rec


def test_slo_attainment_math():
    rec, jrec = _synthetic(TER), _synthetic(JER)
    try:
        s = rec.summary()
        assert _strip(s) == _strip(jrec.summary())
        assert s["window_completed"] == 3
        assert s["requests_total"] == 4 and s["cancelled_total"] == 1
        assert s["ttft_attainment"] == pytest.approx(2 / 3, abs=1e-4)
        assert s["tpot_attainment"] == pytest.approx(2 / 3, abs=1e-4)
        assert s["goodput_tok_s"] == pytest.approx(11 / 0.45, abs=0.06)
        assert s["window_tok_s"] == pytest.approx(33 / 0.45, abs=0.06)
        assert s["goodput_frac"] == pytest.approx(11 / 33, abs=1e-4)
        rec.set_slo(ttft_slo_s=1.0, tpot_slo_s=1.0)
        s2 = rec.summary()
        assert s2["ttft_attainment"] == s2["tpot_attainment"] == 1.0
        assert s2["goodput_frac"] == 1.0
    finally:
        rec.close()
        jrec.close()


def test_window_summary_carves_time_ranges():
    rec = _synthetic(TER)
    try:
        rec.record_tick(t_start=1000.0, wall_s=0.010,
                        phases={"decode_step": 0.008,
                                "token_delivery": 0.002},
                        active=2, pending=0, bucket=4, k=4, tokens=8,
                        admitted=0, gap_s=0.001)
        rec.record_tick(t_start=2000.0, wall_s=0.010,
                        phases={"decode_step": 0.008}, active=1,
                        pending=0, bucket=4, k=4, tokens=4, admitted=0,
                        gap_s=0.5)
        w = rec.window_summary(999.0, 1500.0)
        assert w["window_ticks"] == 1 and w["tokens"] == 8
        assert w["tick_gap_max_s"] == pytest.approx(0.001)
        assert w["decode_efficiency"] == pytest.approx(0.5)
        assert w["occupancy"] == pytest.approx(0.5)
        assert w["window_completed"] == 3
        w2 = rec.window_summary(1500.0, 2500.0)
        assert w2["window_ticks"] == 1 and w2["window_completed"] == 0
        assert w2["tick_gap_max_s"] == pytest.approx(0.5)
    finally:
        rec.close()


def test_recorder_bounded_under_sustained_load():
    rec = TER.EngineRecorder("bounded", max_slots=4, cap=128, enabled=True)
    try:
        for i in range(5000):
            rec.record_tick(t_start=float(i), wall_s=0.001,
                            phases={"decode_step": 0.001}, active=1,
                            pending=0, bucket=4, k=1, tokens=1,
                            admitted=0, gap_s=None)
            rec.request_admitted(i, t_submit=float(i), t_admit=float(i),
                                 prompt_tokens=4, cached_tokens=0,
                                 prefill_s=0.0, kv_restore_s=0.0)
            if i % 2 == 0:
                rec.request_tokens(i, 4, float(i) + 0.01, done=True)
        assert len(rec.ticks()) <= 128 and len(rec.requests()) <= 128
        assert len(rec._active) <= 128
        assert len(rec._window) <= TER._SLO_WINDOW
        s = rec.summary()
        assert s["ticks_total"] == 5000 and s["requests_total"] == 5000
        assert len(json.dumps(rec.snapshot())) < 64_000
    finally:
        rec.close()


def test_kill_switch_records_nothing(monkeypatch):
    rec = TER.EngineRecorder("off", max_slots=2, enabled=False)
    try:
        _script(rec)
        assert not rec.ticks() and not rec.requests()
        assert rec.summary()["ticks_total"] == 0
    finally:
        rec.close()
    # the environment variable, read at import as in JAX's module
    monkeypatch.setattr(TER, "_ENABLED_DEFAULT", False)
    rec = TER.EngineRecorder("env-off", max_slots=2)
    try:
        assert not rec.enabled
    finally:
        rec.close()


# ---------------------------------------------------------------------------
# the port's engine: cold request, warm request, weight swap
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_run():
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32, attn_impl="flash")
    jp = jllama.init_params(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    spans = []
    eng = TS.ContinuousEngine(
        tp, tcfg, max_slots=2, max_len=96, decode_stride=4, warmup=True,
        kv_cache_bytes=64 << 20, kv_label="obs-test", device="cpu",
        recorder_sinks=Sinks(span=lambda task_id, name, **kw: spans.append(
            dict(kw, task_id=task_id, name=name))))
    prompt = (np.arange(24) % tcfg.vocab_size).astype(np.int64)
    toks1 = list(iter(eng.submit_stream(prompt, 8).get, None))
    q2 = eng.submit_stream(prompt, 8, obs_ctx={"request_id": "req-obs-2",
                                               "span_id": "parentspan01"})
    toks2 = list(iter(q2.get, None))
    la = dict(eng._batcher.last_admission)
    eng.load_params(tp)  # swap -> swap_barrier tick
    time.sleep(0.3)  # the final record_tick lands just after the tokens
    yield eng, la, toks1, toks2, spans
    eng.shutdown()


def test_tick_phase_sum_within_tolerance(engine_run):
    eng, _, toks1, toks2, _ = engine_run
    assert len(toks1) == 8 and toks2 == toks1
    rec = eng._recorder
    ticks = rec.ticks()
    assert ticks
    for t in ticks:
        assert sum(t["phases"].values()) <= t["wall_s"] * 1.02
    summ = rec.summary()
    assert 0.90 <= summ["phase_sum_ratio"] <= 1.02, summ
    decoded = [t for t in ticks if t["phases"].get("decode_step")]
    assert decoded and all(t["bucket"] >= 1 and t["k"] >= 1
                           for t in decoded)
    assert summ["recorded_wall_s"] > 0 and summ["overhead_frac"] < 0.02
    st = eng.stats()
    assert st["recorder"]["ticks_total"] == summ["ticks_total"]
    assert st["tokens_generated"] == 16 and st["kv"]["hits"] == 1


def test_cached_prefill_attribution_matches_last_admission(engine_run):
    eng, la, _, _, _ = engine_run
    assert la["cached_tokens"] == 16
    warm = [r for r in eng._recorder.requests()
            if r.get("request_id") == "req-obs-2"]
    assert warm
    r = warm[-1]
    assert r["cached_tokens"] == la["cached_tokens"]
    assert r["prompt_tokens"] == la["prompt_tokens"] == 24
    assert r["computed_tokens"] == 8
    assert r["kv_restore_s"] >= 0 and r["prefill_s"] > 0
    assert r["state"] == "done" and r["tokens"] == 8
    assert r["decode_ticks"] >= 1 and r["ttft_s"] >= 0


def test_swap_barrier_phase_visible(engine_run):
    eng, _, _, _, _ = engine_run
    summ = eng._recorder.summary()
    assert summ["swaps"] == 1 and eng.stats()["weight_swaps"] == 1
    assert summ["phase_s"].get("swap_barrier", 0.0) > 0.0, summ["phase_s"]
    assert eng.stats()["kv"]["invalidations"] == 1


def test_request_record_joins_serve_span_tree(engine_run):
    eng, _, _, _, spans = engine_run
    assert eng._recorder._drain_spans() == 1
    ev = spans[-1]
    assert ev["request_id"] == "req-obs-2"
    assert ev["task_id"].startswith("serve:req-obs-2:engine:")
    assert ev["parent_span_id"] == "parentspan01"
    assert ev["name"] == "engine:obs-test"
    assert set(ev["phases"]) >= {"queue_wait", "prefill", "decode",
                                 "kv_restore"}
    assert eng._recorder._drain_spans() == 0
