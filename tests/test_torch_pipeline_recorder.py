"""ray_tpu_torch's RLHF pipeline flight recorder against the JAX
package's.

The scripted intervals of tests/test_zz_rlhf_obs.py go into JAX's
``PipelineRecorder`` and the port's: the derived fields, ``summary()``,
``iterations()`` and ``snapshot()`` must be equal (less the recorder's
self-timing and the snapshot's clock), and so must ``bubble_attribution``
for every interval set there. A drain pass must hand the port's sinks
what the JAX drain pushes into its metrics registry and GCS.
"""

import json

import pytest

from ray_tpu.util import pipeline_recorder as JPR
from ray_tpu.util import recorder_core as JRC
from ray_tpu_torch.util import pipeline_recorder as TPR
from ray_tpu_torch.util.recorder_core import Sinks

SELF_TIMED = ("overhead_s", "overhead_frac")


def _iv(role, phase, t0, t1):
    return {"role": role, "phase": phase, "t0": t0, "t1": t1}


STRICT = [_iv("generator", "generate", 0.0, 4.0),
          _iv("reference", "score_ref", 4.0, 6.0),
          _iv("reward", "score_reward", 6.0, 8.0),
          _iv("learner", "update", 8.0, 12.0)]
GAPPED = [_iv("generator", "generate", 0.0, 4.0),
          _iv("reference", "score_ref", 4.0, 6.0),
          _iv("reward", "score_reward", 4.0, 6.0),
          _iv("learner", "update", 8.0, 12.0)]
FULL = [_iv(r, p, 0.0, 5.0) for r, p in
        (("generator", "generate"), ("reference", "score_ref"),
         ("reward", "score_reward"), ("learner", "update"))]
RECEIPT = {"version": 1, "nbytes": 1 << 20, "n_leaves": 12,
           "oid_leaves": 7, "inline_leaves": 5, "transport": "push",
           "pump_wall_s": 0.01, "fetch_wall_s": 0.02,
           "barrier_drain_s": 0.005, "swap_apply_s": 0.001}


def test_constants_equal():
    for name in ("PIPE_PHASES", "PHASE_ROLE", "DRIVER_PHASES",
                 "DRIVER_PHASE_ACTORS", "ROLES", "_KV_PREFIX"):
        assert getattr(TPR, name) == getattr(JPR, name), name


@pytest.mark.parametrize("ivs,roles", [
    (STRICT, list(JPR.ROLES)), (GAPPED, list(JPR.ROLES)), (FULL, None),
    ([], None), (STRICT[:2], None),
    # a zero-length and an unknown-role interval are skipped
    (STRICT + [_iv("learner", "ship", 3.0, 3.0),
               _iv("nobody", "x", 0.0, 1.0)], list(JPR.ROLES))])
def test_bubble_attribution_matches_jax(ivs, roles):
    assert TPR.bubble_attribution(ivs, roles=roles) == \
        JPR.bubble_attribution(ivs, roles=roles)


def _record_one(rec, *, iteration=1, t0=100.0, staleness_skew=0,
                receipt=None):
    """tests/test_zz_rlhf_obs.py's strict-phase iteration: 1s generate,
    0.5s score pair, 1s update, ship+sync, 0.1s of tax a driver phase."""
    ivs = [_iv("generator", "generate", t0, t0 + 1.0),
           _iv("reference", "score_ref", t0 + 1.1, t0 + 1.6),
           _iv("reward", "score_reward", t0 + 1.1, t0 + 1.6),
           _iv("learner", "update", t0 + 1.7, t0 + 2.7),
           _iv("learner", "ship", t0 + 2.8, t0 + 2.9),
           _iv("generator", "sync_swap", t0 + 2.9, t0 + 3.0)]
    return rec.record_iteration(
        iteration=iteration, t0=t0, wall_s=3.2, intervals=ivs,
        driver_s={"generate": 1.1, "score": 0.6, "update": 1.1,
                  "ship": 0.15, "sync_swap": 0.15},
        tokens=64, learner_version=iteration + staleness_skew,
        decoded_version=iteration, receipt=receipt)


def _script(rec):
    """Every path of the recorder: receipts, version skew, a clamped
    skew, an interrupt and the restart gap it leaves."""
    out = [_record_one(rec, receipt=RECEIPT)]
    out.append(_record_one(rec, iteration=2, staleness_skew=2, t0=110.0))
    out.append(rec.record_iteration(
        iteration=3, t0=120.0, wall_s=1.0,
        intervals=[_iv("generator", "generate", 120.0, 120.9)],
        driver_s={"generate": 0.95}, learner_version=1, decoded_version=5))
    rec.record_interrupt(phase="generate", t=130.0,
                         error="ActorDiedError('gen')")
    out.append(_record_one(rec, iteration=4, t0=133.5))
    out.append(_record_one(rec, iteration=5, t0=140.0, receipt=RECEIPT))
    return out


def _strip(summary):
    return {k: v for k, v in summary.items() if k not in SELF_TIMED}


def test_scripted_records_equal():
    j = JPR.PipelineRecorder("t-script", enabled=True)
    t = TPR.PipelineRecorder("t-script", enabled=True)
    try:
        derived_j, derived_t = _script(j), _script(t)
        assert derived_t == derived_j
        assert derived_t[0]["tax_s"]["score"] == pytest.approx(0.1)
        assert derived_t[1]["staleness"] == 2
        assert derived_t[2]["staleness"] == 0
        assert derived_t[3]["restart_gap_s"] == pytest.approx(3.5)
        assert derived_t[4]["restart_gap_s"] is None
        assert _strip(t.summary()) == _strip(j.summary())
        assert t.iterations() == j.iterations()
        assert t.iterations(2) == j.iterations(2)
        snap_t, snap_j = t.snapshot(), j.snapshot()
        for s in (snap_t, snap_j):
            s.pop("t")
            s["summary"] = _strip(s["summary"])
        assert snap_t == snap_j
        assert [r["state"] for r in snap_t["iterations"]] == [
            "ok", "ok", "ok", "interrupted", "ok", "ok"]
        assert t.summary()["overhead_frac"] < 0.02
    finally:
        j.close()
        t.close()


def test_recorder_bounded_like_jax():
    j = JPR.PipelineRecorder("t-bound", cap=128, enabled=True)
    t = TPR.PipelineRecorder("t-bound", cap=128, enabled=True)
    try:
        for rec in (j, t):
            for i in range(600):
                _record_one(rec, iteration=i, t0=float(i * 4))
        assert len(t.iterations()) == len(j.iterations()) == 128
        assert t.iterations() == j.iterations()
        assert _strip(t.summary()) == _strip(j.summary())
        assert t.summary()["iterations_total"] == 600
        assert len(json.dumps(t.snapshot())) < 64_000
    finally:
        j.close()
        t.close()


def test_kill_switch_records_nothing():
    for mod in (JPR, TPR):
        rec = mod.PipelineRecorder("t-off", enabled=False)
        try:
            assert _record_one(rec) == {}
            rec.record_interrupt(phase="update", t=1.0)
            assert not rec.iterations()
            assert rec.summary()["iterations_total"] == 0
        finally:
            rec.close()


class _Recording:
    """Stand-ins for the JAX drain's pushes: metric handles and a cluster
    backend, each recording what it gets."""

    def __init__(self):
        self.metrics, self.kv, self.events, self.deleted = [], [], [], []

    def handles(self, _m):
        rec = self

        class Handle:
            def __init__(self, series):
                self.series = series

            def observe(self, v, tags):
                rec.metrics.append((self.series, "observe", v, tags))

            def set(self, v, tags):
                rec.metrics.append((self.series, "set", v, tags))

        return {role: Handle(series) for role, series in TPR.SERIES.items()}

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
        return Sinks(metric=lambda *a: self.metrics.append(a),
                     kv_put=lambda key, value: self.kv.append((key, value)),
                     kv_del=self.deleted.append, events=self.events.append)


def _norm_metrics(metrics):
    """The overhead gauge is self-timed: each side's own wall."""
    return [(s, op, None if s == TPR.SERIES["overhead"] else v, tags)
            for s, op, v, tags in metrics]


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
    monkeypatch.setattr(JPR, "_metric_handles", jrec.handles)
    backend = jrec.backend()
    monkeypatch.setattr(JRC, "cluster_backend", lambda: backend)
    j = JPR.PipelineRecorder("drain", enabled=True)
    t = TPR.PipelineRecorder("drain", enabled=True, sinks=trec.sinks())
    try:
        _script(j)
        _script(t)
        counts_j, counts_t = j.drain_now(), t.drain_now()
        assert counts_t == counts_j
        assert counts_t["metrics"] == 6 and counts_t["events"] == 6
        assert _norm_metrics(trec.metrics) == _norm_metrics(jrec.metrics)
        assert {m[0] for m in trec.metrics} == set(TPR.SERIES.values())
        assert _norm_kv(trec.kv) == _norm_kv(jrec.kv)
        assert trec.events == jrec.events and trec.events
        # watermarked: a second pass pushes no record twice
        assert t.drain_now() == j.drain_now() == {
            "metrics": 0, "kv": 1, "events": 0}
    finally:
        j.close()
        t.close()
    assert trec.deleted == jrec.deleted == [t._kv_key]
    assert t not in TPR.live_recorders()
