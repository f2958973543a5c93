"""The port's sharded MoE step against JAX's on a mesh.

As ``test_torch_sharded_train.py`` (a gloo gang of 8 ranks against JAX's
8 virtual CPU devices, fp32 compute, the same bounds and the same
exception for Adam's eps regime), with the data of JAX's own sharded MoE
test (``tests/test_model_moe.py:105``): ``moe-debug`` under
``auto_mesh(8, tp=2, ep=2)`` (fsdp 2, ep 2, tp 2), params from
``key(0)``, tokens [8, 33] from ``key(1)``,
``default_optimizer(total_steps=10)``; the experts genuinely split over
ep. The gang holds itself to ``LIMIT_S``.

Ring and Ulysses attention on a 4-rank gang at (sp 2, tp 2) against
JAX's MoE steps under the same impl at (fsdp 2, sp 2, tp 2), with the
same data and bounds: the stream is split over sp, the routing still
takes the whole batch's tokens, as JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gang as gang
from ray_tpu.models import moe as jmoe
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel.sharding import shard_pytree as jshard_pytree
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import params_from_jax
from test_torch_sharded_train import _check, _flat, _moments

LIMIT_S = 180
SP_IMPLS = ("ring", "ulysses")
STEPS = 3
OPT = dict(total_steps=10)


def jax_steps(cfg, params, batch, mesh, rules, opt, loss_fn=None):
    """JAX's ``make_train_step(mesh=...)`` for ``STEPS`` steps from
    ``params`` placed by ``rules``: what ``_check`` compares."""
    params = jshard_pytree(params, mesh, rules)
    state = jax.jit(opt.init)(params)
    step = jts.make_train_step(cfg, opt, loss_fn, mesh=mesh)
    placed = jts.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                             mesh)
    losses, norms, nus = [], [], []
    for _ in range(STEPS):
        params, state, m = step(params, state, placed)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        nus.append(_moments(state)["nu"])
    return {"loss": losses, "grad_norm": norms,
            "params": _flat(jax.tree_util.tree_map(np.asarray, params)),
            "moments": _moments(state), "nu_by_step": nus}


def _data(tmp_path_factory, name):
    """The test's data (module docstring): JAX's config, params and
    tokens, and the gang's common arguments (the port's copies saved
    under a new directory)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    tmp = tmp_path_factory.mktemp(name)
    jcfg = dataclasses.replace(jmoe.PRESETS["moe-debug"],
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tmoe.PRESETS["moe-debug"],
                               compute_dtype=torch.float32)
    jp = jax.tree_util.tree_map(np.asarray,
                                jmoe.init_params(jax.random.key(0), jcfg))
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (8, 33), 0,
                                           jcfg.vocab_size))
    torch.save(params_from_jax(jp, tcfg, device="cpu", dtype=torch.float32),
               tmp / "moe.pt")
    np.savez(tmp / "moe.npz", tokens=tokens)
    return tmp, jcfg, jp, {"tokens": tokens}, dict(
        family="moe", preset="moe-debug", steps=STEPS, opt=OPT,
        params=str(tmp / "moe.pt"), batch=str(tmp / "moe.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp, jcfg, jp, batch, common = _data(tmp_path_factory, "sharded_moe")
    g = gang.start("train", 8, tmp, LIMIT_S, mesh=dict(fsdp=2, ep=2, tp=2),
                   impls=["xla"], **common)
    ref = jax_steps(jcfg, jp, batch, jts.auto_mesh(8, tp=2, ep=2)[0],
                    jmoe.sharding_rules(), jts.default_optimizer(**OPT))
    return ref, g.result()


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """JAX's and the port's MoE steps under each of ``SP_IMPLS``, the
    port's on a 4-rank (sp 2, tp 2) gang."""
    tmp, jcfg, jp, batch, common = _data(tmp_path_factory,
                                         "sharded_moe_sp")
    g = gang.start("train", 4, tmp, LIMIT_S, mesh=dict(sp=2, tp=2),
                   impls=list(SP_IMPLS), **common)
    ref = {impl: jax_steps(dataclasses.replace(jcfg, attn_impl=impl), jp,
                           batch, jts.auto_mesh(8, tp=2, sp=2)[0],
                           jmoe.sharding_rules(),
                           jts.default_optimizer(**OPT))
           for impl in SP_IMPLS}
    return ref, g.result()


def test_moe_ep_step_matches_jax(runs):
    ref, got = runs
    _check(got[0]["xla"], ref, OPT)
    # lr > 0 from step 2: the loss moved
    assert ref["loss"][2] != ref["loss"][1]


def test_moe_experts_split_over_ep(runs):
    """The expert leaves (and their moments) are split over ep, as JAX's
    ``test_moe_sharded_train_step_ep_axis`` asserts of its own."""
    from torch.distributed.tensor import Shard

    _, got = runs
    names = ("fsdp", "ep", "tp")
    for rank in got:
        run = rank["xla"]
        for leaf in ("layers/e_gate", "layers/e_up", "layers/e_down"):
            assert run["placements"][leaf][names.index("ep")] == Shard(1)
            assert run["mu_placements"][leaf] == run["placements"][leaf]


@pytest.mark.parametrize("impl", SP_IMPLS)
def test_moe_sequence_parallel_step_matches_jax(sp_runs, impl):
    """Three MoE steps under ring or Ulysses attention at (sp 2, tp 2)
    equal JAX's under the same impl, every rank with the same losses."""
    ref, got = sp_runs
    for rank in got:
        assert rank[impl]["loss"] == got[0][impl]["loss"]
    _check(got[0][impl], ref[impl], OPT)
