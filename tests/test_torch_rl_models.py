"""ray_tpu_torch's policy networks, conv encoder, Gaussian distribution,
RLModule and Catalog against the JAX package's.

CPU, float32 on both sides, JAX's params carried over through numpy
(``models/convert.py:policy_params_from_jax``). Values within 1e-5
absolute (tests/test_long_context.py:34); the Nature CNN's 3,136-wide
dense layer sums enough terms that its outputs are held within 1e-5 of
their largest |value| instead (the 1e-4 relative bound of :57 is the
looser of the two). Tree shapes are held exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import models as jmodels
from ray_tpu.rl import rl_module as jrlm
from ray_tpu.rl.env import EnvSpec as JEnvSpec
from ray_tpu_torch.models.convert import (params_to_numpy,
                                          policy_params_from_jax)
from ray_tpu_torch.parallel.train_step import _leaves
from ray_tpu_torch.rl import models as tmodels
from ray_tpu_torch.rl import rl_module as trlm
from ray_tpu_torch.rl.env import EnvSpec

ATOL = 1e-5
FLAT = EnvSpec(obs_dim=5, num_actions=3)
CONT = EnvSpec(obs_dim=3, action_dim=2, action_low=-2.0, action_high=2.0)
SMALL_PIX = EnvSpec(obs_shape=(16, 16, 1), num_actions=4)
NATURE = EnvSpec(obs_shape=(84, 84, 4), num_actions=6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _j(spec):
    return JEnvSpec(**dataclasses.asdict(spec))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in _leaves(tree).items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=0, atol=atol)


def _obs(spec, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,) + spec.obs_dims).astype(np.float32)


@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_mlp_forward_matches_jax(act):
    jp = jmodels.init_mlp(jax.random.key(0), [5, 16, 16, 3])
    if act == "relu":
        jp["act"] = jnp.zeros(1)
    tp = {"layers": [{k: torch.tensor(np.asarray(v)) for k, v in l.items()}
                     for l in jp["layers"]]}
    if act == "relu":
        tp["act"] = torch.zeros(1)
    x = _obs(FLAT, 9)
    _close(tmodels.mlp_forward(tp, torch.tensor(x)),
           jmodels.mlp_forward(jp, jnp.asarray(x)))


@pytest.mark.parametrize("spec,n", [(SMALL_PIX, 3), (NATURE, 2)],
                         ids=["small_16x16x1", "nature_84x84x4"])
def test_cnn_policy_matches_jax(spec, n):
    """The whole pixel policy (conv stack, NHWC flatten, heads) with JAX's
    params: features, logits and values."""
    jp = jmodels.init_policy(jax.random.key(1), _j(spec))
    tp = policy_params_from_jax(_np(jp), spec, device="cpu")
    assert _shapes(tp) == _shapes(_np(jp)) \
        == tmodels.policy_param_shapes(spec)
    # a [T, N] lead, as IMPALA's loss feeds it
    x = _obs(spec, 2 * n, seed=2).reshape((2, n) + spec.obs_dims)
    feats = tmodels.cnn_forward(tp["enc"], torch.tensor(x))
    want = jmodels.cnn_forward(jp["enc"], jnp.asarray(x))
    assert feats.shape == want.shape == (2, n, 512)
    scale = float(np.abs(np.asarray(want)).max())
    _close(feats, want, ATOL * max(1.0, scale))
    for fn in ("policy_logits", "value"):
        got = getattr(tmodels, fn)(tp, torch.tensor(x))
        ref = getattr(jmodels, fn)(jp, jnp.asarray(x))
        _close(got, ref, ATOL * max(1.0, float(np.abs(np.asarray(ref)).max())))


def test_gaussian_logp_and_entropy_match_jax():
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(7, 3)).astype(np.float32)
    log_std = rng.normal(0, 0.5, size=3).astype(np.float32)
    acts = rng.normal(size=(7, 3)).astype(np.float32)
    _close(tmodels.gaussian_logp(torch.tensor(mean), torch.tensor(log_std),
                                 torch.tensor(acts)),
           jmodels.gaussian_logp(mean, log_std, acts))
    _close(tmodels.gaussian_entropy(torch.tensor(log_std)),
           jmodels.gaussian_entropy(log_std))
    g = torch.Generator().manual_seed(0)
    s = tmodels.gaussian_sample(g, torch.zeros(20000, 1),
                                torch.full((1,), np.log(2.0)))
    assert abs(float(s.std()) - 2.0) < 0.05


@pytest.mark.parametrize("spec,ms", [
    (FLAT, {}), (FLAT, {"activation": "relu", "hidden": (8, 8)}),
    (CONT, {"hidden": (16,)}), (SMALL_PIX, {"encoder_out": 64}),
    (NATURE, {}), (EnvSpec(obs_shape=(40, 40, 3), action_dim=2),
                   {"encoder": "cnn", "encoder_out": 32})],
    ids=["mlp_tanh", "mlp_relu", "mlp_continuous", "cnn_small", "cnn_nature",
         "cnn_continuous"])
def test_catalog_matches_jax(spec, ms):
    """Catalog trees shaped like JAX's, and with JAX's params carried over
    the module's forwards equal JAX's."""
    jmod = jrlm.Catalog.build(_j(spec), jrlm.ModuleSpec(**ms), seed=3)
    tmod = trlm.Catalog.build(spec, trlm.ModuleSpec(**ms), seed=3,
                              device="cpu")
    jtree = _np(jmod.params)
    assert _shapes(tmod.params) == _shapes(jtree)
    assert tmod.num_params() == jmod.num_params()
    full = trlm.ModuleSpec(**ms)
    tmod.params = policy_params_from_jax(
        jtree, spec, tuple(full.hidden), activation=full.activation,
        encoder_out=full.encoder_out, device="cpu")
    for name, v in _leaves(tmod.params).items():   # markers stay zero
        if name.endswith("/s") or name.endswith("/act"):
            assert not v.any()
    obs = _obs(spec, 3, seed=5)
    got, want = tmod.forward_train(obs), jmod.forward_train(obs)
    for k in ("action_logits", "values"):
        _close(got[k], want[k],
               ATOL * max(1.0, float(np.abs(np.asarray(want[k])).max())))
    if spec.discrete:
        np.testing.assert_array_equal(tmod.forward_inference(obs),
                                      jmod.forward_inference(obs))
    else:
        np.testing.assert_allclose(tmod.forward_inference(obs),
                                   jmod.forward_inference(obs), atol=ATOL)
    acts, logp = tmod.forward_exploration(obs, torch.Generator())
    assert acts.shape == jmod.forward_inference(obs).shape
    assert logp.shape == (3,)
    # get_state gives back JAX's tree; set_state takes it
    state = tmod.get_state()
    jax.tree_util.tree_map(np.testing.assert_array_equal, state, jtree)
    tmod.set_state(jtree)
    assert _shapes(tmod.params) == _shapes(jtree)


def test_catalog_refusals_and_custom_builder():
    for mod, spec in ((jrlm, _j(CONT)), (trlm, CONT)):
        with pytest.raises(ValueError, match="unknown module builder"):
            mod.Catalog.build(spec, mod.ModuleSpec(encoder="nope"),
                              **({"device": "cpu"} if mod is trlm else {}))
        with pytest.raises(ValueError, match="free_log_std=True"):
            mod.Catalog.build(spec, mod.ModuleSpec(free_log_std=False),
                              **({"device": "cpu"} if mod is trlm else {}))
        with pytest.raises(ValueError, match="pixel EnvSpec"):
            mod.Catalog.build(spec, mod.ModuleSpec(encoder="cnn"),
                              **({"device": "cpu"} if mod is trlm else {}))
        with pytest.raises(ValueError, match="unknown activation"):
            mod.Catalog.build(spec, mod.ModuleSpec(activation="gelu"),
                              **({"device": "cpu"} if mod is trlm else {}))

    def wide(gen, spec, ms):
        return {"pi": tmodels.init_mlp(gen, [spec.obs_dim, 32, 2]),
                "vf": tmodels.init_mlp(gen, [spec.obs_dim, 32, 1]),
                "log_std": torch.zeros(2, device=gen.device)}

    trlm.register_module_builder("wide_test", wide)
    mod = trlm.Catalog.build(CONT, trlm.ModuleSpec(encoder="wide_test"),
                             device="cpu")
    assert mod.params["pi"]["layers"][0]["w"].shape == (3, 32)
    ma = trlm.MultiAgentRLModule.build({"b": FLAT, "a": CONT},
                                       device="cpu")
    assert sorted(ma.keys()) == ["a", "b"] and "a" in ma
    state = ma.get_state()
    ma.set_state(state)
    assert _shapes(ma["b"].params) == _shapes(state["b"])


def test_policy_converter_checks_shapes_and_round_trips():
    jp = _np(jmodels.init_policy(jax.random.key(0), _j(CONT), (16, 16)))
    tp = policy_params_from_jax(jp, CONT, (16, 16), device="cpu")
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_numpy(tp), jp)
    with pytest.raises(ValueError, match="shape"):
        policy_params_from_jax(jp, CONT, (16, 8), device="cpu")
    with pytest.raises(KeyError, match="log_std"):
        policy_params_from_jax({k: v for k, v in jp.items()
                                if k != "log_std"}, CONT, (16, 16),
                               device="cpu")
    with pytest.raises(KeyError, match="act"):
        policy_params_from_jax(jp, CONT, (16, 16), activation="relu",
                               device="cpu")
