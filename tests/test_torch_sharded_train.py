"""The port's sharded train step against JAX's on a mesh.

The port runs as a gang of gloo ranks on the CPU (``_torch_gang``), JAX
on its 8 virtual CPU devices (``rt_test_platform.py``), both from the
data of JAX's own sharded test (``tests/test_model_llama.py:116-135``):
the ``debug`` preset's params from ``jax.random.key(0)``, tokens [8, 33]
from ``key(1)``, ``default_optimizer(lr=1e-3, warmup_steps=1,
total_steps=50)``, fp32 compute. Three steps under (dp 2, fsdp 2, tp 2)
on 8 ranks against JAX's 8-device step, for ``xla`` and ``flash``
attention; (fsdp 4) and (fsdp 2, tp 2, chunked loss) on 4 ranks against
the same references (a layout changes only the summation order). Loss
and grad_norm per step, and Adam's moments after, within 1e-4 of the
reference's max |value| (the train tests' bound, tests/test_torch_train.py);
every param after within that bound too, except an element that some
step updated with a nonzero sqrt(v_hat) under 100x Adam's eps (1e-6,
JAX's v after that step): there Adam's update m_hat / (sqrt(v_hat) + eps) turns fp32
summation-order noise into up to lr a step (JAX's own xla and flash steps
differ by 6e-5 at the one such element of this data, w_down[1, 110, 35],
first gradient -2.2e-8), so it is held to the most Adam can move it,
2 x the lr applied.
The 8-rank gang also reports one step's gradient placements and its
collectives (``CommDebugMode``, and by the mesh axis of each group).
Each gang holds itself to ``LIMIT_S``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gang as gang
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel import train_step as tts

REL = 1e-4
LIMIT_S = 180
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=50)
MESH8 = dict(dp=2, fsdp=2, tp=2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _flat(tree):
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update({f"{name}/{k}": v for k, v in node.items()})
        else:
            out[name] = node
    return out


def _moments(state):
    """optax ``chain(clip, adamw)``'s (mu, nu) trees, flat by name."""
    adam = state[1][0]
    return {m: _flat(jax.tree_util.tree_map(np.asarray, getattr(adam, m)))
            for m in ("mu", "nu")}


def _jax_run(params, tokens, impl):
    cfg = dataclasses.replace(jllama.PRESETS["debug"],
                              compute_dtype=jnp.float32, attn_impl=impl)
    mesh = jmake_mesh(JMeshConfig(**MESH8), jax.devices())
    opt = jts.default_optimizer(**OPT)
    params = jax.device_put(
        params, jllama.sharding_rules().tree_shardings(params, mesh))
    state = jax.jit(opt.init)(params)
    step = jts.make_train_step(cfg, opt, mesh=mesh)
    batch = jts.shard_batch({"tokens": tokens}, mesh)
    losses, norms, nus = [], [], []
    for _ in range(STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        nus.append(_moments(state)["nu"])
    return {"loss": losses, "grad_norm": norms,
            "params": _flat(jax.tree_util.tree_map(np.asarray, params)),
            "moments": _moments(state), "nu_by_step": nus}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    tmp = tmp_path_factory.mktemp("sharded_train")
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32)
    jp = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(0), jcfg))
    tokens = np.asarray(jax.random.randint(
        jax.random.key(1), (8, 33), 0, jcfg.vocab_size, dtype=jnp.int32))
    torch.save(params_from_jax(jp, tcfg, device="cpu", dtype=torch.float32),
               tmp / "params.pt")
    np.savez(tmp / "batch.npz", tokens=tokens)
    common = dict(preset="debug", steps=STEPS, opt=OPT,
                  params=str(tmp / "params.pt"),
                  batch=str(tmp / "batch.npz"))
    gangs = {
        "8": gang.start("train", 8, tmp, LIMIT_S, mesh=MESH8,
                        impls=["xla", "flash"], probe=True, **common),
        "fsdp4": gang.start("train", 4, tmp, LIMIT_S, mesh=dict(fsdp=4),
                            impls=["xla"], **common),
        "fsdp2_tp2": gang.start("train", 4, tmp, LIMIT_S,
                                mesh=dict(fsdp=2, tp=2), impls=["flash"],
                                cfg={"loss_chunk": 16}, driver=2,
                                **common),
    }
    ref = {impl: _jax_run(jp, tokens, impl) for impl in ("xla", "flash")}
    return ref, {k: g.result() for k, g in gangs.items()}


def _check(got, want, opt_kwargs=OPT):
    for key in ("loss", "grad_norm"):
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            assert abs(a - b) / abs(b) < REL, (key, i, a, b)
    assert got["count"] == STEPS
    for m in ("mu", "nu"):
        for name, ref in want["moments"][m].items():
            assert _rel(got["moments"][m][name], ref) < REL, (m, name)
    opt = tts.default_optimizer(**opt_kwargs)
    lr_applied = sum(opt.schedule(c) for c in range(STEPS))
    for name, ref in want["params"].items():
        diff = np.abs(got["params"][name] - ref)
        noise = np.zeros(ref.shape, bool)
        for i, nu in enumerate(want["nu_by_step"]):
            rms = np.sqrt(nu[name] / (1 - tts.B2 ** (i + 1)))
            noise |= (rms > 0) & (rms < 100 * tts.EPS)
        assert diff[~noise].max(initial=0) <= REL * np.abs(ref).max(), name
        assert diff[noise].max(initial=0) <= 2 * lr_applied, name


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dp_fsdp_tp_step_matches_jax(runs, impl):
    ref, got = runs
    _check(got["8"][0][impl], ref[impl])


@pytest.mark.parametrize("layout,impl", [("fsdp4", "xla"),
                                         ("fsdp2_tp2", "flash")])
def test_four_rank_layouts_match_jax(runs, layout, impl):
    ref, got = runs
    _check(got[layout][0][impl], ref[impl])
    # every rank read the same metrics
    for rank in got[layout][1:]:
        assert rank[impl]["loss"] == got[layout][0][impl]["loss"]


def test_sharded_step_driver_matches_jax_and_the_plain_loop(runs):
    """``StepDriver(mesh=(fsdp 2, tp 2), steps_per_launch=2)`` over three
    batches (one fused launch of two steps, one single-step tail) against
    JAX's three steps and the port's plain ``make_train_step`` loop."""
    ref, got = runs
    drv = got["fsdp2_tp2"][0]["driver"]
    assert (drv["launches"], drv["steps"]) == (2, STEPS)
    _check(drv, ref["flash"])
    for a, b in zip(drv["loss"], drv["plain_loss"]):
        assert abs(a - b) / abs(b) < REL
    plain = dict(ref["flash"], params=drv["plain_params"])
    _check(dict(drv, moments=ref["flash"]["moments"]), plain)


class _Mesh:
    mesh_dim_names = ("dp", "fsdp", "tp")


def test_state_and_gradients_carry_the_rules_placements(runs):
    """Params and moments sit where ``sharding_rules`` puts them on the
    compute mesh. Backward leaves each fsdp-sharded weight's gradient in
    its param's placements (the gather's backward reduce-scattered it) and
    a replicated norm scale's partial over every axis; the optimizer gets
    every gradient in its param's placements."""
    from torch.distributed.tensor import Partial

    _, got = runs
    rules = tllama.sharding_rules()
    for rank in got["8"]:
        run, probe = rank["xla"], rank["probe"]
        for name, places in run["placements"].items():
            want = sharding.placements(rules.spec_for(name), _Mesh())
            assert places == want, name
            assert run["mu_placements"][name] == want, name
            raw = probe["backward_placements"][name]
            if any(p.is_shard() for p in want):
                assert raw == want, name
            else:
                assert raw == (Partial(),) * 3, name
        assert probe["update_placements"] == run["placements"]


def test_collectives_are_zero3_and_megatron(runs):
    """One (dp 2, fsdp 2, tp 2) step's collectives by mesh axis, ZeRO-3
    over fsdp: each fsdp-sharded weight (7 a layer, embed, lm_head) is
    all-gathered where it is used, the layer weights again in the remat
    recompute, and its gradient reduce-scattered once; besides those only
    all-reduces of scalars and norm-scale gradients run over fsdp (the
    loss, the clip norm, three [L or 1, d] norms). dp all-reduces the
    gradients; tp all-reduces the residual stream's shares, and the
    vocab-sharded loss gathers its logits over tp once."""
    _, got = runs
    comm = got["8"][0]["probe"]["comm"]
    axis, nbytes = comm["by_axis"], comm["bytes_by_axis"]
    weights = 7 * 2 + 2
    assert axis["all_gather_into_tensor@fsdp"] == weights + 7 * 2
    assert axis["reduce_scatter_tensor@fsdp"] == weights
    assert comm["backward"]["reduce_scatter_tensor"] == weights
    assert set(axis) == {
        "all_gather_into_tensor@fsdp", "reduce_scatter_tensor@fsdp",
        "all_reduce@fsdp", "all_reduce@dp", "all_reduce@tp",
        "all_gather_into_tensor@tp"}
    assert nbytes["all_reduce@fsdp"] <= 4 * (3 * 2 * 64 + 4)
    assert axis["all_reduce@dp"] >= weights
    assert axis["all_gather_into_tensor@tp"] == 1
    assert sum(comm["by_type"].values()) == sum(axis.values())
