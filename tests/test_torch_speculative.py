"""ray_tpu_torch's generate_speculative against ray_tpu.models.generate
(`debug` preset, float32, CPU, weights carried over with params_from_jax):
the port's output equals JAX's speculative output, which equals JAX's
greedy generate, token for token, and its round count equals JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as JG
from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import generate as TG
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax


def _cfgs(attn_impl="flash", **kw):
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32,
                               attn_impl=attn_impl, **kw)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32,
                               attn_impl=attn_impl, **kw)
    return jcfg, tcfg


def _params(seed, jcfg, tcfg):
    jp = jllama.init_params(jax.random.key(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               device="cpu")


def _check(jp, jdp, tp, tdp, jcfg, jdcfg, tcfg, tdcfg, prompt, n, k):
    jprompt = jnp.asarray(prompt, jnp.int32)
    ref = np.asarray(JG.generate(jp, jprompt, jcfg, max_new_tokens=n))
    jout, jstats = JG.generate_speculative(
        jp, jdp, jprompt, jcfg, jdcfg, max_new_tokens=n, speculate_k=k,
        return_stats=True)
    got, stats = TG.generate_speculative(
        tp, tdp, prompt, tcfg, tdcfg, max_new_tokens=n, speculate_k=k,
        return_stats=True, device="cpu")
    np.testing.assert_array_equal(np.asarray(jout), ref)
    assert got.shape == (len(prompt), n)
    assert got.numpy().tolist() == ref.tolist()
    assert stats == jstats
    return stats


@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("draft", ["same", "independent"])
def test_speculative_matches_jax_and_greedy(k, draft):
    """The same model as draft (most proposals accepted) and an
    independent draft (rejections exercise the correction and the stale
    cache overwrite), at b 2: lockstep acceptance."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(0, jcfg, tcfg)
    jdp, tdp = (jp, tp) if draft == "same" else _params(123, jcfg, tcfg)
    prompt = np.random.default_rng(1).integers(0, 256, size=(2, 9))
    stats = _check(jp, jdp, tp, tdp, jcfg, jcfg, tcfg, tcfg, prompt, 17, k)
    assert 1 <= stats["rounds"] <= 17


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_speculative_smaller_draft_config(attn_impl):
    jcfg, tcfg = _cfgs(attn_impl)
    jdcfg, tdcfg = _cfgs(attn_impl, n_layers=1)
    jp, tp = _params(0, jcfg, tcfg)
    jdp, tdp = _params(7, jdcfg, tdcfg)
    prompt = np.random.default_rng(2).integers(0, 256, size=(1, 6))
    _check(jp, jdp, tp, tdp, jcfg, jdcfg, tcfg, tdcfg, prompt, 12, 4)


def test_speculative_debug_draft_preset():
    """The `debug_draft` preset (narrower, GQA 2/1) drafting for `debug`."""
    jcfg, tcfg = _cfgs()
    jdcfg = dataclasses.replace(jllama.PRESETS["debug_draft"],
                                compute_dtype=jnp.float32, attn_impl="flash")
    tdcfg = dataclasses.replace(tllama.PRESETS["debug_draft"],
                                compute_dtype=torch.float32,
                                attn_impl="flash")
    jp, tp = _params(3, jcfg, tcfg)
    jdp, tdp = _params(4, jdcfg, tdcfg)
    prompt = np.random.default_rng(5).integers(0, 256, size=(2, 7))
    _check(jp, jdp, tp, tdp, jcfg, jdcfg, tcfg, tdcfg, prompt, 15, 4)


def test_speculative_returns_tokens_only_by_default_and_fits_max_len():
    jcfg, tcfg = _cfgs()
    _, tp = _params(0, jcfg, tcfg)
    prompt = np.random.default_rng(6).integers(0, 256, size=(1, 5))
    out = TG.generate_speculative(tp, tp, prompt, tcfg, tcfg,
                                  max_new_tokens=8, speculate_k=3,
                                  max_len=5 + 8 + 3 + 1, device="cpu")
    assert torch.equal(out, TG.generate(tp, prompt, tcfg, max_new_tokens=8,
                                        device="cpu"))


def test_speculative_size_check_raises_like_jax():
    """The cache must hold prompt + new + k + 1 positions (the port clamps
    write positions, JAX shifts the block: they agree only while it
    fits)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(0, jcfg, tcfg)
    prompt = np.zeros((1, 5), np.int32)
    with pytest.raises(ValueError, match="max_len"):
        JG.generate_speculative(jp, jp, jnp.asarray(prompt), jcfg, jcfg,
                                max_new_tokens=8, speculate_k=3, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        TG.generate_speculative(tp, tp, prompt, tcfg, tcfg, max_new_tokens=8,
                                speculate_k=3, max_len=16, device="cpu")
