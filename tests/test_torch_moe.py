"""ray_tpu_torch's MoE family against ray_tpu.models.moe (`moe-debug`,
float32 on both sides, CPU, weights carried over with params_from_jax):
forward logits and lm_loss within 1e-5, every gradient within 1e-4
relative, the routing's kept/dropped selection under a capacity overflow,
the identity dispatch with ample capacity, the aux loss, MoE decode
against JAX's generate and the drop-free forward, and the port's
ContinuousBatcher serving MoE against JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as JG
from ray_tpu.models import moe as jmoe
from ray_tpu.models.serving import ContinuousBatcher as JBatcher
from ray_tpu_torch.models import generate as TG
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.models.serving import ContinuousBatcher

ATOL = 1e-5        # tests/test_long_context.py:34
GRAD_RTOL = 1e-4   # tests/test_long_context.py:57


def _cfgs(**kw):
    jcfg = dataclasses.replace(jmoe.PRESETS["moe-debug"],
                               compute_dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tmoe.PRESETS["moe-debug"],
                               compute_dtype=torch.float32, **kw)
    return jcfg, tcfg


def _setup(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jp = jmoe.init_params(jax.random.key(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jcfg, tcfg, jp, tp


def _layer0(jp, tp):
    jl = jax.tree_util.tree_map(lambda x: x[0], jp["layers"])
    tl = {k: w[0] for k, w in tp["layers"].items()}
    return jl, tl


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def test_presets_and_param_counts_match_jax():
    for name, jc in jmoe.PRESETS.items():
        tc = tmoe.PRESETS[name]
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq_len", "n_experts", "top_k",
                  "capacity_factor", "router_aux_coef"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert tc.num_params() == jc.num_params(), name
        assert tc.active_params() == jc.active_params(), name
    jcfg, tcfg, jp, tp = _setup()
    assert set(tp["layers"]) == set(jp["layers"])
    assert "w_gate" not in tp["layers"]
    n = sum(t.numel() for t in (tp["embed"], tp["final_norm"], tp["lm_head"],
                                *tp["layers"].values()))
    assert n == tcfg.num_params()
    init = tmoe.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in init["layers"].items()} == {
        k: tuple(v.shape) for k, v in tp["layers"].items()}
    back = params_to_numpy(tp)
    np.testing.assert_array_equal(back["layers"]["e_down"],
                                  np.asarray(jp["layers"]["e_down"]))


def test_forward_logits_match_jax():
    jcfg, tcfg, jp, tp = _setup(seed=1)
    toks = _tokens(2, (2, 33))
    ref = np.asarray(jmoe.forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
    got = tmoe.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL, rtol=0)


def test_lm_loss_and_every_gradient_match_jax():
    jcfg, tcfg, jp, tp = _setup(seed=3)
    toks = _tokens(4, (2, 25))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmoe.lm_loss(p, {"tokens": jnp.asarray(toks, jnp.int32)},
                               jcfg))(jp)
    leaves = {"embed": tp["embed"], "final_norm": tp["final_norm"],
              "lm_head": tp["lm_head"], **tp["layers"]}
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tmoe.lm_loss(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    flat_j = {"embed": jgrads["embed"], "final_norm": jgrads["final_norm"],
              "lm_head": jgrads["lm_head"], **jgrads["layers"]}
    assert set(flat_j) == set(leaves)
    for name, t in leaves.items():
        want = np.asarray(flat_j[name])
        err = np.abs(t.grad.numpy() - want).max()
        assert err <= GRAD_RTOL * max(np.abs(want).max(), 1e-30), name
    # the router is trained through the gates and the aux loss
    assert float(tp["layers"]["router"].grad.norm()) > 0


@pytest.mark.parametrize("top_k", [1, 2])
def test_capacity_overflow_keeps_and_drops_what_jax_does(top_k):
    """Every token wants expert 1 and the capacity holds ~1 slot
    (`tests/test_model_moe.py:63`): the port keeps the same selections
    as JAX (its non-zero rows) and drops the rest to exactly zero."""
    jcfg, tcfg, jp, tp = _setup(n_layers=1, top_k=top_k,
                                capacity_factor=0.01)
    jl, tl = _layer0(jp, tp)
    router = np.zeros(jl["router"].shape, np.float32)
    router[:, 1] = 100.0
    router[:, 2] = 50.0
    jl = dict(jl, router=jnp.asarray(router))
    tl = dict(tl, router=torch.from_numpy(router))
    h = np.random.default_rng(3).standard_normal((1, 16, jcfg.d_model),
                                                 np.float32)
    jout, jaux = jmoe._moe_ffn(jcfg, jnp.asarray(h), jl)
    tout, taux = tmoe._moe_ffn(tcfg, torch.from_numpy(h), tl)
    jflat = np.asarray(jout).reshape(16, -1)
    tflat = tout.numpy().reshape(16, -1)
    kept_j = np.abs(jflat).max(axis=1) > 0
    kept_t = np.abs(tflat).max(axis=1) > 0
    np.testing.assert_array_equal(kept_t, kept_j)
    assert (~kept_t).sum() >= 16 - 2 * top_k   # ~1 slot an expert
    assert (tflat[~kept_t] == 0).all()
    np.testing.assert_allclose(tflat, jflat, atol=ATOL, rtol=0)
    assert abs(float(taux) - float(jaux)) <= ATOL


def test_capacity_drops_partial_match_jax():
    """A capacity that holds some selections of a skewed router and not
    others, top-2: the output (kept sums, dropped parts zero) equals
    JAX's row for row."""
    jcfg, tcfg, jp, tp = _setup(seed=5, n_layers=1, capacity_factor=0.5)
    jl, tl = _layer0(jp, tp)
    router = np.asarray(jl["router"]).copy()
    router[:, 0] += 0.5   # skew toward expert 0
    jl = dict(jl, router=jnp.asarray(router))
    tl = dict(tl, router=torch.from_numpy(router))
    h = np.random.default_rng(6).standard_normal((2, 24, jcfg.d_model),
                                                 np.float32)
    jout, jaux = jmoe._moe_ffn(jcfg, jnp.asarray(h), jl)
    tout, taux = tmoe._moe_ffn(tcfg, torch.from_numpy(h), tl)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    assert abs(float(taux) - float(jaux)) <= ATOL


def test_ties_go_to_the_lower_expert_like_lax_top_k():
    """A zero router gives every expert the same probability: lax.top_k
    picks experts 0..K-1, and so must the port."""
    jcfg, tcfg, jp, tp = _setup(n_layers=1)
    jl, tl = _layer0(jp, tp)
    router = np.zeros(jl["router"].shape, np.float32)
    jl = dict(jl, router=jnp.asarray(router))
    tl = dict(tl, router=torch.from_numpy(router))
    h = np.random.default_rng(8).standard_normal((1, 8, jcfg.d_model),
                                                 np.float32)
    jout, jaux = jmoe._moe_ffn(jcfg, jnp.asarray(h), jl)
    tout, taux = tmoe._moe_ffn(tcfg, torch.from_numpy(h), tl)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    assert abs(float(taux) - float(jaux)) <= ATOL


def test_dispatch_identity_with_ample_capacity():
    """top_k 1 with room for every token: each token's output is its own
    chosen expert's dense SwiGLU FFN (the case of
    `tests/test_model_moe.py:37`, here exact in fp32)."""
    _, tcfg, _, tp = _setup(n_layers=1, top_k=1, capacity_factor=8.0)
    tl = {k: w[0] for k, w in tp["layers"].items()}
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, tcfg.d_model), np.float32))
    out, _ = tmoe._moe_ffn(tcfg, h, tl)
    tokens = h.reshape(-1, tcfg.d_model)
    chosen = (tokens @ tl["router"]).argmax(-1)
    o = out.reshape(-1, tcfg.d_model)
    for g in range(tokens.shape[0]):
        e = int(chosen[g])
        t = tokens[g][None]
        dense = (torch.nn.functional.silu(t @ tl["e_gate"][e])
                 * (t @ tl["e_up"][e])) @ tl["e_down"][e]
        torch.testing.assert_close(o[g], dense[0], atol=ATOL, rtol=0)


def test_aux_loss_matches_jax_and_prefers_balance():
    jcfg, tcfg, jp, tp = _setup(n_layers=1)
    jl, tl = _layer0(jp, tp)
    h = np.random.default_rng(5).standard_normal((2, 32, jcfg.d_model),
                                                 np.float32)
    auxes = {}
    for kind in ("uniform", "collapsed", "trained"):
        router = np.asarray(jl["router"]).copy()
        if kind == "uniform":
            router[:] = 0.0
        elif kind == "collapsed":
            router[:] = 0.0
            router[:, 0] = 100.0
        _, ja = jmoe._moe_ffn(jcfg, jnp.asarray(h),
                              dict(jl, router=jnp.asarray(router)))
        _, ta = tmoe._moe_ffn(tcfg, torch.from_numpy(h),
                              dict(tl, router=torch.from_numpy(router)))
        assert abs(float(ta) - float(ja)) <= ATOL, kind
        auxes[kind] = float(ta)
    assert auxes["collapsed"] > auxes["uniform"]
    assert abs(auxes["uniform"] - 1.0) < 0.2


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_moe_generate_matches_jax_and_dropfree_forward(attn_impl):
    jcfg, tcfg, jp, tp = _setup(seed=0, attn_impl=attn_impl)
    prompt = _tokens(1, (2, 5))
    ref = np.asarray(JG.generate(jp, jnp.asarray(prompt, jnp.int32), jcfg,
                                 max_new_tokens=6))
    got = TG.generate(tp, prompt, tcfg, max_new_tokens=6, device="cpu")
    assert got.numpy().tolist() == ref.tolist()
    # greedy decode = argmax of the drop-free full forward, step by step
    # (`tests/test_generate.py:50`)
    free = dataclasses.replace(tcfg, capacity_factor=float(tcfg.n_experts))
    seq = torch.from_numpy(prompt)
    for t in range(6):
        logits = tmoe.forward(tp, seq, free)
        assert torch.equal(logits[:, -1].argmax(-1), got[:, t]), t
        seq = torch.cat([seq, got[:, t:t + 1]], dim=1)


def test_moe_batcher_matches_jax_batcher():
    """The port's ContinuousBatcher serves the MoE family token for token
    as JAX's does, admissions interleaved with decode steps."""
    jcfg, tcfg, jp, tp = _setup(seed=2, attn_impl="flash")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, size=s).astype(np.int32)
               for s in (5, 9, 7)]
    wants = [10, 6, 8]

    def drive(eng):
        ids = [eng.submit(prompts[0], wants[0])]
        for _ in range(2):
            eng.step()
        ids.append(eng.submit(prompts[1], wants[1]))
        eng.step()
        ids.append(eng.submit(prompts[2], wants[2]))
        res = eng.run_to_completion()
        return [list(map(int, res[i])) for i in ids]

    want = drive(JBatcher(jp, jcfg, max_slots=4, max_len=48))
    got = drive(ContinuousBatcher(tp, tcfg, max_slots=4, max_len=48,
                                  device="cpu"))
    assert got == want
