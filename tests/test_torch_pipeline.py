"""Pipeline parallelism of the port (``ray_tpu_torch/parallel/pipeline.py``
and the Llama family's pipelined paths) against the JAX package's
(``ray_tpu/parallel/pipeline.py``).

- ``schedule_stats`` and ``max_microbatches_for_stash`` equal JAX's over a
  grid of (schedule, p, m).
- ``pipeline_apply`` on JAX's tanh stack (``tests/test_long_context.py:
  113-159``, the data from a numpy seed): (pp 4) without remat and (pp 2,
  fsdp 2) with remat and gradients, on a 4-rank gloo gang, against JAX's
  on its 8 virtual devices (output within 1e-5, gradient 1e-4 relative).
- The ``debug`` preset in fp32 under GPipe and 1F1B at (pp 2, tp 2),
  microbatches 4, tokens [16, 33] (``tests/test_pipeline_1f1b.py:52-131``):
  plain, with segment ids (two documents a row) and with a loss mask;
  loss within 1e-5 and every gradient within 1e-4 of its largest, against
  the port's flat ``lm_loss`` and against JAX's 1F1B, which also catches
  a gradient scaled by P.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gang as gang
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import pipeline as jpipeline
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel.context import mesh_scope as jmesh_scope
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import context as tcontext
from ray_tpu_torch.parallel import pipeline as tpipeline
from ray_tpu_torch.parallel import train_step as tts

OUT_TOL = 1e-5
GRAD_REL = 1e-4
LIMIT_S = 150
VARIANTS = {"plain": ["tokens"], "segments": ["tokens", "segment_ids"],
            "loss_mask": ["tokens", "loss_mask"]}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-8))


def _flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _tanh_stack(stage_ws, h):
    body = lambda hh, w: (jnp.tanh(hh @ w), None)
    return jax.lax.scan(body, h, stage_ws)[0]


def _jax_tanh(data):
    mesh4 = jmake_mesh(JMeshConfig.for_devices(8, pp=4))
    pp4 = jax.jit(lambda w, x: jpipeline.pipeline_apply(
        _tanh_stack, w, x, mesh4, num_microbatches=4, remat=False))(
        data["ws4"], data["x4"])
    mesh2 = jmake_mesh(JMeshConfig.for_devices(8, pp=2))
    fn = lambda w, x: jpipeline.pipeline_apply(_tanh_stack, w, x, mesh2,
                                               num_microbatches=2)
    pp2 = jax.jit(fn)(data["ws2"], data["x2"])
    grad = jax.jit(jax.grad(lambda w, x: (fn(w, x) ** 2).sum()))(
        data["ws2"], data["x2"])
    return {"pp4": np.asarray(pp4), "pp2": np.asarray(pp2),
            "pp2_grad": np.asarray(grad)}


def _jax_1f1b(params, batch):
    cfg = dataclasses.replace(jllama.PRESETS["debug"],
                              compute_dtype=jnp.float32, pipeline_axis="pp",
                              pipeline_microbatches=4,
                              pipeline_schedule="1f1b")
    mesh, _ = jts.auto_mesh(8, tp=2, pp=2)
    with jmesh_scope(mesh):
        loss, grads = jax.jit(lambda p, b: jllama.lm_loss_and_grads_1f1b(
            p, b, cfg))(params, batch)
    return float(loss), _flat(grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    tanh = {"ws4": f32(8, 16, 16) * 0.3, "x4": f32(8, 16),
            "ws2": f32(4, 8, 8) * 0.3, "x2": f32(16, 8)}
    np.savez(tmp / "tanh.npz", **tanh)
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32)
    jp = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(0), jcfg))
    tparams = params_from_jax(jp, tcfg, device="cpu", dtype=torch.float32)
    torch.save(tparams, tmp / "params.pt")
    data = {"tokens": rng.integers(0, jcfg.vocab_size, (16, 33),
                                   dtype=np.int32),
            "segment_ids": np.repeat(np.arange(2, dtype=np.int32), 16)[
                None].repeat(16, 0),
            "loss_mask": (rng.uniform(size=(16, 32)) > 0.3).astype(
                np.float32)}
    np.savez(tmp / "batch.npz", **data)
    gangs = {
        "tanh": gang.start("pipeline_tanh", 4, tmp, LIMIT_S,
                           data=str(tmp / "tanh.npz")),
        "llama": gang.start("llama_pipeline", 4, tmp, LIMIT_S,
                            preset="debug", mesh={"pp": 2, "tp": 2},
                            params=str(tmp / "params.pt"),
                            batch=str(tmp / "batch.npz"),
                            variants=VARIANTS),
    }
    ref = {"tanh": _jax_tanh(tanh), "flat": {}, "jax_1f1b": {}}
    for name, keys in VARIANTS.items():
        batch = {k: data[k] for k in keys}
        ref["jax_1f1b"][name] = _jax_1f1b(jp, batch)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, grads = tts.value_and_grad(
            lambda p: tllama.lm_loss(p, tb, tcfg), tparams)
        ref["flat"][name] = (float(loss),
                             {k: g.numpy() for k, g in grads.items()})
    return ref, {k: g.result() for k, g in gangs.items()}


def test_schedule_stats_and_stash_budget_match_jax():
    for schedule in ("gpipe", "1f1b"):
        for p in (1, 2, 4, 8):
            for m in (1, 2, 4, 7, 16):
                assert tpipeline.schedule_stats(schedule, p, m) == \
                    jpipeline.schedule_stats(schedule, p, m)
            for budget in (0, 1, 3, 4, 15, 100):
                assert tpipeline.max_microbatches_for_stash(
                    schedule, p, budget) == \
                    jpipeline.max_microbatches_for_stash(schedule, p, budget)
    for fn, args in ((tpipeline.schedule_stats, (2, 4)),
                     (tpipeline.max_microbatches_for_stash, (2, 4))):
        with pytest.raises(ValueError, match="unknown schedule 'zb'"):
            fn("zb", *args)


def test_pipeline_apply_matches_jax(runs):
    ref, got = runs
    for rank in got["tanh"]:
        for key in ("pp4", "pp2"):
            assert np.abs(rank[key] - ref["tanh"][key]).max() < OUT_TOL, key
        assert _rel(rank["pp2_grad"], ref["tanh"]["pp2_grad"]) < GRAD_REL


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_llama_pipeline_matches_flat_model(runs, schedule, variant):
    ref, got = runs
    loss, grads = ref["flat"][variant]
    for rank in got["llama"]:
        run = rank[f"{variant}/{schedule}"]
        assert abs(run["loss"] - loss) < OUT_TOL
        assert set(run["grads"]) == set(grads)
        for name, g in grads.items():
            assert _rel(run["grads"][name], g) < GRAD_REL, name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_1f1b_matches_jax_1f1b(runs, variant):
    ref, got = runs
    loss, grads = ref["jax_1f1b"][variant]
    run = got["llama"][0][f"{variant}/1f1b"]
    assert abs(run["loss"] - loss) < OUT_TOL
    assert set(run["grads"]) == set(grads)
    for name, g in grads.items():
        assert _rel(run["grads"][name], g) < GRAD_REL, name


def test_gpipe_matches_1f1b(runs):
    _, got = runs
    for variant in VARIANTS:
        a = got["llama"][0][f"{variant}/gpipe"]
        b = got["llama"][0][f"{variant}/1f1b"]
        assert abs(a["loss"] - b["loss"]) < OUT_TOL
        for name, g in a["grads"].items():
            assert _rel(b["grads"][name], g) < GRAD_REL, name


def test_pipeline_refusals_match_jax():
    """JAX's errors: a pipeline needs a mesh, takes no ring or Ulysses
    attention, and 1f1b needs untied embeddings; a batch the microbatches
    do not divide."""
    tcfg = dataclasses.replace(tllama.PRESETS["debug"], pipeline_axis="pp")
    jcfg = dataclasses.replace(jllama.PRESETS["debug"], pipeline_axis="pp")
    tp = tllama.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    jp = jllama.init_params(jax.random.key(0), jcfg)
    tb = {"tokens": torch.zeros(4, 9, dtype=torch.int32)}
    jb = {"tokens": jnp.zeros((4, 9), jnp.int32)}
    cases = [
        (dataclasses.replace(tcfg), dataclasses.replace(jcfg), "lm_loss",
         ValueError, "needs an ambient mesh"),
        (dataclasses.replace(tcfg, pipeline_schedule="1f1b"),
         dataclasses.replace(jcfg, pipeline_schedule="1f1b"),
         "lm_loss_and_grads_1f1b", ValueError, "needs an ambient mesh"),
        (dataclasses.replace(tcfg, tie_embeddings=True),
         dataclasses.replace(jcfg, tie_embeddings=True),
         "lm_loss_and_grads_1f1b", NotImplementedError, "untied"),
        (dataclasses.replace(tcfg, attn_impl="ring"),
         dataclasses.replace(jcfg, attn_impl="ring"),
         "lm_loss_and_grads_1f1b", ValueError, "incompatible with ring"),
    ]
    with tcontext.mesh_scope(object()):
        with pytest.raises(ValueError, match="incompatible with ring"):
            tllama.lm_loss(tp, tb, dataclasses.replace(tcfg,
                                                       attn_impl="ring"))
    for tc, jc, fn, exc, match in cases:
        with pytest.raises(exc, match=match) as t_err:
            getattr(tllama, fn)(tp, tb, tc)
        with pytest.raises(exc, match=match) as j_err:
            getattr(jllama, fn)(jp, jb, jc)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="not divisible by 4 microbatches"):
        tpipeline.pipeline_spmd(lambda w, h: h, {}, torch.zeros(6, 2), None,
                                4)


def test_moe_refuses_pipeline_and_sp_attention_without_a_mesh():
    """The MoE family refuses a pipeline axis with JAX's message; ring and
    Ulysses attention run for it on a mesh (``test_torch_sharded_moe.py``)
    and, with no ambient mesh, fail with JAX's error."""
    from ray_tpu.models import moe as jmoe
    from ray_tpu_torch.models import moe as tmoe

    tcfg = tmoe.PRESETS["moe-debug"]
    tp = tmoe.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu", dtype=torch.float32)
    jcfg = dataclasses.replace(jmoe.PRESETS["moe-debug"], pipeline_axis="pp")
    jp = jmoe.init_params(jax.random.key(0), jcfg)
    tokens = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="MoE family") as j_err:
        jmoe.forward_hidden(jp, jnp.zeros((2, 8), jnp.int32), jcfg)
    with pytest.raises(NotImplementedError, match="MoE family") as t_err:
        tmoe.forward_hidden(tp, tokens, dataclasses.replace(
            tcfg, pipeline_axis="pp"))
    assert str(t_err.value) == str(j_err.value)
    for impl in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="mesh") as j_err:
            jmoe.forward_hidden(jp, jnp.zeros((2, 8), jnp.int32),
                                dataclasses.replace(jcfg, pipeline_axis=None,
                                                    attn_impl=impl))
        with pytest.raises(ValueError, match="mesh") as t_err:
            tmoe.forward_hidden(tp, tokens, dataclasses.replace(
                tcfg, attn_impl=impl))
        assert str(t_err.value) == str(j_err.value)
