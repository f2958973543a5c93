"""ray_tpu_torch's KV-cache generation against ray_tpu.models.generate:
greedy decode token for token (`debug` preset, float32, CPU, weights
carried over with params_from_jax). Sampling cannot match jax.random, so
it is held to seeded determinism and to greedy at temperature 0."""

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


def _setup(attn_impl="flash", seed=0):
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32, attn_impl=attn_impl)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32,
                               attn_impl=attn_impl)
    jp = jllama.init_params(jax.random.key(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_greedy_generate_matches_jax(attn_impl):
    jcfg, tcfg, jp, tp = _setup(attn_impl)
    prompt = np.random.default_rng(1).integers(0, 256, size=(2, 7))
    ref = np.asarray(JG.generate(jp, jnp.asarray(prompt, jnp.int32), jcfg,
                                 max_new_tokens=12))
    got = TG.generate(tp, prompt, tcfg, max_new_tokens=12, device="cpu")
    assert got.shape == (2, 12)
    assert got.numpy().tolist() == ref.tolist()


def test_generate_stream_matches_jax_with_max_len():
    jcfg, tcfg, jp, tp = _setup(seed=2)
    prompt = np.random.default_rng(3).integers(0, 256, size=(1, 9))
    ref = np.asarray(JG.generate(jp, jnp.asarray(prompt, jnp.int32), jcfg,
                                 max_new_tokens=10, max_len=40))
    got = [int(t[0]) for t in TG.generate_stream(
        tp, prompt, tcfg, max_new_tokens=10, max_len=40, device="cpu")]
    assert got == ref[0].tolist()


def test_forward_with_cache_last_only_and_prefill_logits():
    """Full prefill logits through the cache equal the uncached forward;
    ``last_only`` keeps only the last position."""
    _, tcfg, _, tp = _setup(seed=4)
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, size=(2, 11)))
    cache = TG.init_cache(tcfg, 2, 32, device="cpu")
    full = TG._forward_with_cache(tp, tokens, tcfg, cache, 0,
                                  last_only=False)
    want = tllama.forward(tp, tokens, tcfg)
    assert (full - want).abs().max() < 1e-4
    cache = TG.init_cache(tcfg, 2, 32, device="cpu")
    last = TG._forward_with_cache(tp, tokens, tcfg, cache, 0)
    assert last.shape == (2, 1, 256)
    assert (last[:, 0] - want[:, -1]).abs().max() < 1e-4


def test_sampling_is_seeded_and_temperature_zero_is_greedy():
    _, tcfg, _, tp = _setup(seed=6)
    prompt = np.random.default_rng(7).integers(0, 256, size=(2, 5))

    def sample(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return TG.generate(tp, prompt, tcfg, max_new_tokens=8, generator=g,
                           device="cpu", **kw)

    a = sample(0, temperature=1.0, top_k=20)
    assert torch.equal(a, sample(0, temperature=1.0, top_k=20))
    assert not torch.equal(a, sample(1, temperature=1.0, top_k=20))
    greedy = TG.generate(tp, prompt, tcfg, max_new_tokens=8, device="cpu")
    assert torch.equal(sample(0, temperature=0.0), greedy)
    top1 = sample(3, temperature=1.0, top_k=1)
    assert torch.equal(top1, greedy)
