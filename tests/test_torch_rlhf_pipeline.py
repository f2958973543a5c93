"""ray_tpu_torch's RLHF generator and pipeline against JAX's roles, and the port's
in-place aliasing rules.

``debug`` preset, float32 compute, the JAX weights carried over through
numpy, CPU. JAX's roles are its plain classes, driven in-process in the
pipeline's phase order, with the generator synced through
``load_params`` on numpy params (the stream plane is not ported). Values
within 1e-5 absolute, params within 1e-4 of the reference's max |value|
per leaf (tests/test_long_context.py:34 and :57); greedy tokens equal.
The port's roles own their params: the alias tests update in place and
check that no other role sees it. (The models and the learner alone:
tests/test_torch_rlhf.py.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.rl.rlhf import pipeline as jpipe
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.parallel.train_step import _leaves
from ray_tpu_torch.rl.rlhf import pipeline as tpipe

ATOL, REL = 1e-5, 1e-4
PRESET = "debug_f32"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs():
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture
def jax_preset(monkeypatch):
    """JAX's roles look their config up by name: a float32 debug preset."""
    jcfg, tcfg = _configs()
    monkeypatch.setitem(jllama.PRESETS, PRESET, jcfg)
    return tcfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


def _assert_params_close(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name in want:
        assert _rel(got[name], want[name]) < REL, name


def test_generator_matches_jax(jax_preset):
    tcfg = jax_preset
    jg = jpipe.RLHFGenerator(PRESET, 0, 3, 24, 4)
    params = _np(jllama.init_params(jax.random.key(0),
                                    jllama.PRESETS[PRESET]))
    tg = tpipe.RLHFGenerator(tcfg, 0, 3, 24, 4, params=params, device="cpu")
    try:
        prompts = [list(p) for p in _tokens(7, 5, 6)]
        want, got = jg.generate(prompts, 12), tg.generate(prompts, 12)
        np.testing.assert_array_equal(got["sequences"], want["sequences"])
        assert got["tokens_generated"] == want["tokens_generated"] == 60
        assert got["weights_version"] == want["weights_version"] == 0
    finally:
        jg.engine.shutdown()
        tg.engine.shutdown()


class _Hooks(tpipe.RLHFHooks):
    def __init__(self):
        self.metrics, self.active = [], []

    def metric(self, series, op, value, tags=None):
        self.metrics.append((series, op, tags))

    def activate(self, ctx):
        self.active.append(ctx["trace_id"])
        return sum(isinstance(a, str) for a in self.active)

    def deactivate(self, token):
        self.active.append(-token)


def test_pipeline_iteration_matches_jax_roles(jax_preset):
    """Two port iterations against JAX's roles driven by hand in the same
    order: sequences, rewards, reference logprobs, the learner's metrics,
    and iteration 2's tokens, decoded under the synced weights."""
    tcfg = jax_preset
    c = dict(num_prompts=3, prompt_len=5, max_new_tokens=7, max_slots=2,
             decode_stride=2, lr=1e-3, seed=2)
    jc = jpipe.RLHFConfig(preset=PRESET, **c)
    jl = jpipe.RLHFLearner(PRESET, jc.seed, jc.lr, jc.kl_coeff,
                           jc.clip_param, jc.num_epochs)
    jref = jpipe.RLHFReference(PRESET, jc.seed)
    jrw = jpipe.RLHFReward(PRESET, jc.seed + 1)
    jg = jpipe.RLHFGenerator(PRESET, jc.seed, jc.max_slots, jc.max_len,
                             jc.decode_stride)
    hooks = _Hooks()
    pipe = tpipe.RLHFPipeline(tpipe.RLHFConfig(preset=tcfg, **c),
                              params=_np(jl.get_params()),
                              reward_params=_np(jrw._params), device="cpu",
                              hooks=hooks)
    rng = np.random.default_rng(jc.seed)
    try:
        for it in (1, 2):
            prompts = [[int(t) for t in rng.integers(1, 256, jc.prompt_len)]
                       for _ in range(jc.num_prompts)]
            gen = jg.generate(prompts, jc.max_new_tokens)
            seqs = gen["sequences"]
            scores = jrw.score(seqs)["scores"]
            ref = jref.logprobs(seqs, jc.prompt_len)["logprobs"]
            upd = jl.update(seqs, scores, ref, jc.prompt_len)
            jg.engine.load_params(_np(jl.get_params()))

            seen = {}
            for role, method in ((pipe.generator, "generate"),
                                 (pipe.reward, "score"),
                                 (pipe.reference, "logprobs")):
                fn = getattr(role, method)

                def spy(*a, _fn=fn, _m=method):
                    seen[_m] = _fn(*a)
                    return seen[_m]

                setattr(role, method, spy)
            r = pipe.run_iteration()
            for role, method in ((pipe.generator, "generate"),
                                 (pipe.reward, "score"),
                                 (pipe.reference, "logprobs")):
                delattr(role, method)
            np.testing.assert_array_equal(seen["generate"]["sequences"],
                                          seqs)
            np.testing.assert_allclose(seen["score"]["scores"], scores,
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(seen["logprobs"]["logprobs"], ref,
                                       atol=ATOL, rtol=0)
            for key in ("loss", "kl_mean", "reward_mean"):
                assert r[key] == pytest.approx(upd[key], abs=ATOL), key
            assert r["iteration"] == r["weights_version"] == it
            assert r["decoded_version"] == it - 1 and r["staleness"] == 0
            assert r["sync_transport"] == "device"
            assert r["receipt"]["n_leaves"] == len(_leaves(
                pipe.learner.get_params()))
            assert r["sync_bytes"] == sum(
                t.numel() * 4 for t in _leaves(pipe.learner.get_params())
                .values())
            assert set(r["phases_actor_s"]) == {
                "generate", "score_reward", "score_ref", "update", "ship",
                "sync_swap"}
            assert r["bubble_fraction"] == pytest.approx(0.75, abs=0.01)
        assert r["kl_mean"] != 0.0
        _assert_params_close(params_to_numpy(pipe.learner.get_params()),
                             _np(jl.get_params()))
        s = pipe.stats()
        assert s["iterations"] == 2 and s["recorder"]["window_iterations"]
        series = {m[0] for m in hooks.metrics}
        assert series == {"rt_rlhf_iterations_total",
                          "rt_rlhf_tokens_generated_total",
                          "rt_rlhf_reward_mean", "rt_rlhf_phase_seconds",
                          "rt_rlhf_weight_sync_bytes_total",
                          "rt_rlhf_weight_sync_seconds"}
        # role construction and each iteration under the trace context
        assert hooks.active == [pipe.trace_id, -1, pipe.trace_id, -2,
                                pipe.trace_id, -3]
    finally:
        jg.engine.shutdown()
        pipe.shutdown()


def _roles(tcfg, shared):
    """Learner, reference and generator all handed the SAME tensors."""
    learner = tpipe.RLHFLearner(tcfg, 0, 1e-2, 0.1, 0.2, 1, params=shared,
                                device="cpu")
    reference = tpipe.RLHFReference(tcfg, 0, params=shared, device="cpu")
    gen = tpipe.RLHFGenerator(tcfg, 0, 2, 20, 2, params=shared,
                              device="cpu")
    return learner, reference, gen


def _snapshot(params):
    return {k: t.clone() for k, t in _leaves(params).items()}


def _unchanged(params, snap):
    return all(torch.equal(t, snap[k]) for k, t in _leaves(params).items())


def _update(learner, tcfg):
    seqs = _tokens(seed=9, b=2, s=10)
    return learner.update(seqs, np.array([1.0, -1.0], np.float32),
                          np.full((2, 6), -5.0, np.float32), 4)


@pytest.fixture
def shared_roles():
    _, tcfg = _configs()
    shared = tllama.init_params(tcfg, generator=torch.Generator()
                                .manual_seed(0), device="cpu",
                                dtype=torch.float32)
    learner, reference, gen = _roles(tcfg, shared)
    yield tcfg, shared, learner, reference, gen
    gen.engine.shutdown()


def test_reference_unchanged_by_update(shared_roles):
    tcfg, shared, learner, reference, _ = shared_roles
    snap = _snapshot(reference._params)
    _update(learner, tcfg)
    assert not _unchanged(learner.get_params(), snap)
    assert _unchanged(reference._params, snap)
    assert _unchanged(shared, snap)


def test_generator_unchanged_by_update_before_sync(shared_roles):
    tcfg, _, learner, _, gen = shared_roles
    engine_params = gen.engine._batcher.params
    snap = _snapshot(engine_params)
    _update(learner, tcfg)
    assert not _unchanged(learner.get_params(), snap)
    assert _unchanged(engine_params, snap)


def test_generator_unchanged_by_update_after_sync(shared_roles):
    tcfg, _, learner, _, gen = shared_roles
    _update(learner, tcfg)
    ticket = learner.ship_weights()
    assert ticket["version"] == 1
    info = gen.sync_weights(ticket)
    assert "params" not in ticket and info["version"] == 1
    engine_params = gen.engine._batcher.params
    snap = _snapshot(engine_params)
    assert _unchanged(learner.get_params(), snap)
    _update(learner, tcfg)
    assert not _unchanged(learner.get_params(), snap)
    assert _unchanged(engine_params, snap)


def test_failed_sync_drops_the_copy_and_records_the_interrupt():
    _, tcfg = _configs()
    pipe = tpipe.RLHFPipeline(tpipe.RLHFConfig(preset=tcfg, num_prompts=2,
                                               prompt_len=4,
                                               max_new_tokens=3),
                              device="cpu")
    tickets = []
    ship = pipe.learner.ship_weights

    def spy(*a):
        tickets.append(ship(*a))
        return tickets[-1]

    def broken(ticket):
        raise RuntimeError("sync lost")

    pipe.learner.ship_weights = spy
    pipe.generator.sync_weights = broken
    try:
        with pytest.raises(RuntimeError, match="sync lost"):
            pipe.run_iteration()
        assert len(tickets) == 1 and "params" not in tickets[0]
        s = pipe.recorder.summary()
        assert s["interrupted_total"] == 1
        assert s["interrupted_last"]["phase"] == "sync_swap"
    finally:
        pipe.shutdown()
