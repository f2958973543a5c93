"""ray_tpu_torch's RLHF models and its learner role
against the JAX package's.

``debug`` preset, float32 compute on both sides, the JAX weights carried
over through numpy, tokens from numpy with a seed, CPU. JAX's flash runs
its Pallas kernels in interpret mode, the port's its plain versions.
Values within 1e-5 absolute and params within 1e-4 of the reference's max
|value| per leaf (the reference's own tolerances: tests/
test_long_context.py:34 and :57). (The generator, the
pipeline and the alias tests: tests/test_torch_rlhf_pipeline.py.)"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.rl.rlhf import models as jrm
from ray_tpu.rl.rlhf import pipeline as jpipe
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import (params_from_jax, params_to_numpy,
                                          reward_params_from_jax)
from ray_tpu_torch.parallel.train_step import _leaves
from ray_tpu_torch.rl.rlhf import models as trm
from ray_tpu_torch.rl.rlhf import pipeline as tpipe

ATOL, REL = 1e-5, 1e-4
PRESET = "debug_f32"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(attn_impl="xla"):
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32, attn_impl=attn_impl)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32,
                               attn_impl=attn_impl)
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


def _tokens(seed=1, b=3, s=12, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_reward_and_logprobs_match_jax(attn_impl):
    jcfg, tcfg = _configs(attn_impl)
    jrw = jrm.init_reward_params(jax.random.key(3), jcfg)
    jpol = jllama.init_params(jax.random.key(4), jcfg)
    trw = reward_params_from_jax(_np(jrw), tcfg, device="cpu")
    tpol = params_from_jax(_np(jpol), tcfg, device="cpu")
    toks = _tokens()
    want = np.asarray(jrm.reward_score(jrw, jnp.asarray(toks), jcfg))
    got = trm.reward_score(trw, torch.from_numpy(toks), tcfg).numpy()
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for prompt_len in (1, 11):
        want = np.asarray(jrm.sequence_logprobs(jpol, jnp.asarray(toks),
                                                prompt_len, jcfg))
        got = trm.sequence_logprobs(tpol, torch.from_numpy(toks),
                                    prompt_len, tcfg).numpy()
        assert got.shape == want.shape == (3, 12 - prompt_len)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_sequence_logprobs_rejects_bad_prompt_len():
    jcfg, tcfg = _configs()
    jpol = jllama.init_params(jax.random.key(4), jcfg)
    tpol = params_from_jax(_np(jpol), tcfg, device="cpu")
    toks = _tokens()
    for bad in (0, 12, 13):
        with pytest.raises(ValueError, match="out of range") as jerr:
            jrm.sequence_logprobs(jpol, jnp.asarray(toks), bad, jcfg)
        with pytest.raises(ValueError, match="out of range") as terr:
            trm.sequence_logprobs(tpol, torch.from_numpy(toks), bad, tcfg)
        assert str(terr.value) == str(jerr.value)


def _assert_params_close(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name in want:
        assert _rel(got[name], want[name]) < REL, name


def test_learner_update_matches_jax(jax_preset):
    tcfg = jax_preset
    jl = jpipe.RLHFLearner(PRESET, 0, 1e-4, 0.1, 0.2, 2)
    tl = tpipe.RLHFLearner(tcfg, 0, 1e-4, 0.1, 0.2, 2,
                           params=_np(jl.get_params()), device="cpu")
    rng = np.random.default_rng(5)
    seqs = _tokens(seed=6, b=4, s=14)
    rewards = rng.standard_normal(4).astype(np.float32)
    ref = (rng.standard_normal((4, 8)) * 0.1 - 5.0).astype(np.float32)
    for _ in range(2):
        want = jl.update(seqs, rewards, ref, 6)
        got = tl.update(seqs, rewards, ref, 6)
        for key in ("loss", "ratio_mean", "kl_mean", "reward_mean"):
            assert got[key] == pytest.approx(want[key], abs=ATOL), key
        assert got["version"] == want["version"]
        _assert_params_close(params_to_numpy(tl.get_params()),
                             _np(jl.get_params()))
