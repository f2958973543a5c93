"""ray_tpu_torch's Llama forward against ray_tpu.models.llama on the same
weights (carried over with params_from_jax), `debug` preset, float32, CPU.

Tolerance 1e-4 absolute on the logits: each op agrees with JAX within 1e-5
(tests/test_torch_ops.py), and two layers plus the vocab projection add up
those fp32 summation-order differences over d_model-long dot products; the
logits are O(1), so 1e-4 is a few hundred fp32 ulps and far below any
difference a wrong op would make.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax

TOL = 1e-4


def _configs(attn_impl, **over):
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32, attn_impl=attn_impl,
                               **over)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32,
                               attn_impl=attn_impl, **over)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = jllama.init_params(jax.random.key(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_jax(np_params, tcfg, device="cpu")


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_forward_matches_jax(attn_impl):
    jcfg, tcfg = _configs(attn_impl)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                               size=(2, 24))
    ref = np.asarray(jllama.forward(jp, jnp.asarray(tokens), jcfg))
    got = tllama.forward(tp, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    assert np.abs(got.numpy() - ref).max() < TOL


def test_tied_embeddings_match_jax():
    jcfg, tcfg = _configs("xla", tie_embeddings=True)
    jp, tp = _params(jcfg, tcfg, seed=3)
    assert "lm_head" not in tp
    tokens = np.random.default_rng(2).integers(0, 256, size=(1, 10))
    ref = np.asarray(jllama.forward(jp, jnp.asarray(tokens), jcfg))
    got = tllama.forward(tp, torch.from_numpy(tokens), tcfg).numpy()
    assert np.abs(got - ref).max() < TOL


def test_segment_ids_match_jax():
    jcfg, tcfg = _configs("xla")
    jp, tp = _params(jcfg, tcfg, seed=4)
    tokens = np.random.default_rng(5).integers(0, 256, size=(2, 12))
    seg = np.repeat(np.array([[0, 1], [0, 0]]), 6, axis=1)
    ref = np.asarray(jllama.forward(jp, jnp.asarray(tokens), jcfg,
                                    segment_ids=jnp.asarray(seg)))
    got = tllama.forward(tp, torch.from_numpy(tokens), tcfg,
                         segment_ids=torch.from_numpy(seg)).numpy()
    assert np.abs(got - ref).max() < TOL


def _flat(tree):
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_init_params_shapes_and_seed():
    """Same tree, shapes and leaf names as JAX's init, stored in the
    compute dtype, and reproducible from the generator's seed."""
    cfg = tllama.PRESETS["debug"]
    a, b = (_flat(tllama.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
        for _ in range(2))
    ref = _flat(jax.eval_shape(
        lambda k: jllama.init_params(k, jllama.PRESETS["debug"]),
        jax.random.key(0)))
    assert sorted(a) == sorted(ref)
    for name, leaf in a.items():
        assert tuple(leaf.shape) == tuple(ref[name].shape), name
        assert leaf.dtype == cfg.compute_dtype, name
        assert torch.equal(leaf, b[name]), name
    assert cfg.num_params() == jllama.PRESETS["debug"].num_params()
    assert tllama.PRESETS["7b"].num_params() == \
        jllama.PRESETS["7b"].num_params()


def test_params_from_jax_rejects_wrong_shape():
    jcfg, tcfg = _configs("xla")
    np_params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(0), jcfg))
    np_params["layers"]["wq"] = np_params["layers"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="layers/wq"):
        params_from_jax(np_params, tcfg, device="cpu")
