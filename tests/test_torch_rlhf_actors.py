"""The port's RLHF pipeline on its runtime (``ray_tpu_torch/rl/rlhf/
pipeline.py``): the four roles placed as actors of a ``RoleGroup``, the
weights shipped over the stream plane.

CPU, the ``debug`` preset in float32, JAX's weights carried over
through numpy. Two iterations of the actor pipeline against JAX's roles
driven by hand in the pipeline's phase order (as
tests/test_torch_rlhf_pipeline.py holds the one-process pipeline):
sequences token-exact, rewards and reference logprobs within 1e-5
absolute, the learner's metrics within 1e-5, params within 1e-4 of the
reference's max |value| per leaf. The roles' outputs are read back
from spying subclasses (``_torch_actor_cases.spying``). Then JAX's own
end-to-end checks (``tests/test_zz_rlhf.py:219``): placement rows, the
engine's counters, one swap an iteration, the push transport with oid
leaves (the stream's inline size lowered to 16 KiB for the module), the
phases and the pump receipt. ``init(num_gpus=4)``: each role's
``CUDA_VISIBLE_DEVICES`` names a card of its own. On the local backend
the first sync raises, as JAX's ``ship_params`` does there.
"""

import dataclasses
import os

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_actor_cases as cases
import ray_tpu_torch as rt
from ray_tpu.models import llama as jllama
from ray_tpu.rl.rlhf import pipeline as jpipe
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.parallel.train_step import _leaves
from ray_tpu_torch.rl.rlhf import pipeline as tpipe

ATOL, REL = 1e-5, 1e-4
PRESET = "debug_f32"
INLINE_MAX = 16 * 1024


@pytest.fixture(scope="module", autouse=True)
def module_env():
    """One torch thread here and in every role's process; a 16 KiB
    inline size for the stream (read by the producer's process)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "RT_STREAM_INLINE_MAX")}
    os.environ.update(OMP_NUM_THREADS="1",
                      RT_STREAM_INLINE_MAX=str(INLINE_MAX))
    cloudpickle.register_pickle_by_value(cases)
    yield
    if rt.is_initialized():
        rt.shutdown()
    cloudpickle.unregister_pickle_by_value(cases)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
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


def test_actor_pipeline_matches_jax_roles(jax_preset, monkeypatch):
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
    cases.spy_roles(monkeypatch)
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=8, num_gpus=0)
    hooks = _Hooks()
    pipe = tpipe.RLHFPipeline(tpipe.RLHFConfig(preset=tcfg, **c),
                              params=_np(jl.get_params()),
                              reward_params=_np(jrw._params), device="cpu",
                              hooks=hooks)
    rng = np.random.default_rng(jc.seed)
    try:
        assert pipe.group is not None
        assert all(isinstance(getattr(pipe, role), rt.ActorHandle)
                   for role in ("learner", "reference", "reward",
                                "generator"))
        pids = {role: rt.get(getattr(pipe, role).visible.remote())["pid"]
                for role in ("learner", "reference", "reward", "generator")}
        assert len(set(pids.values())) == 4 and os.getpid() not in \
            pids.values()
        for it in (1, 2):
            prompts = [[int(t) for t in rng.integers(1, 256, jc.prompt_len)]
                       for _ in range(jc.num_prompts)]
            gen = jg.generate(prompts, jc.max_new_tokens)
            seqs = gen["sequences"]
            scores = jrw.score(seqs)["scores"]
            ref = jref.logprobs(seqs, jc.prompt_len)["logprobs"]
            upd = jl.update(seqs, scores, ref, jc.prompt_len)
            jg.engine.load_params(_np(jl.get_params()))

            r = pipe.run_iteration()
            seen = {}
            for role in ("generator", "reward", "reference", "learner"):
                seen.update(rt.get(getattr(pipe, role).last.remote()))
            np.testing.assert_array_equal(seen["generate"]["sequences"],
                                          seqs)
            np.testing.assert_allclose(seen["score"]["scores"], scores,
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(seen["logprobs"]["logprobs"], ref,
                                       atol=ATOL, rtol=0)
            for key in ("loss", "kl_mean", "reward_mean", "ratio_mean"):
                assert seen["update"][key] == pytest.approx(upd[key],
                                                            abs=ATOL), key
            for key in ("loss", "kl_mean", "reward_mean"):
                assert r[key] == pytest.approx(upd[key], abs=ATOL), key
            assert r["iteration"] == r["weights_version"] == it
            assert r["decoded_version"] == it - 1 and r["staleness"] == 0
            # JAX's end-to-end checks
            assert r["tokens_generated"] == 3 * 7
            assert r["sync_transport"] == "push"
            receipt = r["receipt"]
            assert receipt["transport"] == "push" and receipt["rpcs"] == 1
            assert receipt["oid_leaves"] > 0 and receipt["inline_leaves"] > 0
            assert receipt["oid_leaves"] + receipt["inline_leaves"] \
                == receipt["n_leaves"]
            assert receipt["frames_taken"] == receipt["n_leaves"] + 1
            assert receipt["pump_wall_s"] >= 0
            assert r["sync_bytes"] == receipt["nbytes"] > 0
            assert set(r["phases_s"]) == {"generate", "score", "update",
                                          "sync"}
            assert set(r["phases_actor_s"]) == {
                "generate", "score_reward", "score_ref", "update", "ship",
                "sync_swap"}
            eng = rt.get(pipe.generator.engine_stats.remote())
            assert eng["tokens_generated"] == it * 3 * 7
            assert eng["requests_completed"] == it * 3
            assert eng["weight_swaps"] == it
        assert r["kl_mean"] != 0.0
        learner = params_to_numpy(rt.get(pipe.learner.get_params.remote()))
        want = {k: np.asarray(v) for k, v in _leaves(_np(
            jl.get_params())).items()}
        got = {k: np.asarray(v) for k, v in _leaves(learner).items()}
        assert got.keys() == want.keys()
        for name in want:
            assert _rel(got[name], want[name]) < REL, name
        s = pipe.stats()
        assert [row["role"] for row in s["placement"]] == [
            "learner", "reference", "reward", "generator"]
        assert all(row["num_cpus"] == 1.0 and row["num_gpus"] == 0.0
                   for row in s["placement"])
        assert s["iterations"] == 2 and s["recorder"]["window_iterations"]
        assert s["recorder"]["receipt_last"]["transport"] == "push"
        assert {m[0] for m in hooks.metrics} >= {
            "rt_rlhf_iterations_total", "rt_rlhf_weight_sync_bytes_total"}
        assert hooks.active == [pipe.trace_id, -1, pipe.trace_id, -2,
                                pipe.trace_id, -3]
    finally:
        jg.engine.shutdown()
        pipe.shutdown()
        rt.shutdown()


def test_roles_take_a_card_each_of_four(monkeypatch):
    """``init(num_gpus=4)`` on the CPU: a GPU share of one pins each role
    to a card of its own; the default share is a card each on a cluster
    of four cards, a quarter of one card otherwise, none on the CPU."""
    cases.spy_roles(monkeypatch)
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=8, num_gpus=4)
    pipe = tpipe.RLHFPipeline(
        tpipe.RLHFConfig(preset="debug", num_prompts=2, prompt_len=4,
                         max_new_tokens=2, max_slots=2, decode_stride=2,
                         gpus_per_role=1.0), device="cpu")
    try:
        seen = [rt.get(getattr(pipe, role).visible.remote())
                for role in ("learner", "reference", "reward", "generator")]
        cards = [v["cuda_visible_devices"] for v in seen]
        assert sorted(cards) == ["0", "1", "2", "3"], cards
        assert [row["num_gpus"] for row in pipe.stats()["placement"]] \
            == [1.0] * 4
        stub = type("Stub", (), {})()
        stub.cfg, stub.device = tpipe.RLHFConfig(), torch.device("cuda")
        assert tpipe.RLHFPipeline.gpus_per_role(stub) == 1.0
        monkeypatch.setattr(rt, "cluster_resources", lambda: {"GPU": 1.0})
        assert tpipe.RLHFPipeline.gpus_per_role(stub) == 0.25
        stub.device = torch.device("cpu")
        assert tpipe.RLHFPipeline.gpus_per_role(stub) == 0.0
    finally:
        pipe.shutdown()
        rt.shutdown()


def test_local_backend_sync_raises():
    """The local backend has no stream transport: the roles run as
    threads here and the first sync raises, as JAX's does."""
    if rt.is_initialized():
        rt.shutdown()
    rt.init(local_mode=True, num_cpus=8)
    pipe = tpipe.RLHFPipeline(
        tpipe.RLHFConfig(preset="debug", num_prompts=2, prompt_len=4,
                         max_new_tokens=2, max_slots=2, decode_stride=2),
        device="cpu")
    try:
        with pytest.raises(Exception, match="cluster backend"):
            pipe.run_iteration()
        assert pipe.recorder.summary()["interrupted_total"] == 1
    finally:
        pipe.shutdown()
        rt.shutdown()
