"""The port's train step under sequence and pipeline parallelism against
JAX's on its 8 virtual CPU devices (``tests/test_long_context.py:162-194``).

The data of the sharded train tests (``test_torch_sharded_train.py``):
the ``debug`` preset's params from ``jax.random.key(0)``, tokens [8, 33]
from ``key(1)``, ``default_optimizer(lr=1e-3, warmup_steps=1,
total_steps=50)``, fp32 compute, three steps, held with that file's
bound (1e-4 of max |value| for loss, grad_norm, moments and params).

- ring and Ulysses attention at (sp 2, tp 2) on a 4-rank gloo gang
  against JAX's ring and Ulysses steps at (fsdp 2, sp 2, tp 2); tokens
  [8, 33] do not divide by sp, so the batch stays whole and the model
  splits its sequence after the shift. The gang's ``xla`` steps on the
  same mesh, with tokens [8, 34] that do divide (the batch split by
  sequence, JAX's rule), against the port's plain steps.
- GPipe and 1F1B (2 microbatches) at (pp 2, tp 2) against JAX's at (pp 2,
  fsdp 2, tp 2), on the pipelined rules.
- the ring loss equals the ``xla`` loss of the same params.
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
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import train_step as tts
from test_torch_sharded_train import OPT, REL, STEPS, _check, _flat, _moments

LIMIT_S = 200
PIPE = {"pipeline_axis": "pp", "pipeline_microbatches": 2}
RUNS = {
    "ring": ({"attn_impl": "ring"}, {"sp": 2}),
    "ulysses": ({"attn_impl": "ulysses"}, {"sp": 2}),
    "gpipe": (PIPE, {"pp": 2}),
    "1f1b": (dict(PIPE, pipeline_schedule="1f1b"), {"pp": 2}),
}


def _jax_run(params, tokens, fields, axes):
    cfg = dataclasses.replace(jllama.PRESETS["debug"],
                              compute_dtype=jnp.float32, **fields)
    mesh, _ = jts.auto_mesh(8, tp=2, **axes)
    opt = jts.default_optimizer(**OPT)
    rules = jllama.sharding_rules(pipeline=cfg.pipeline_axis is not None)
    params = jax.device_put(params, rules.tree_shardings(params, mesh))
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
    tmp = tmp_path_factory.mktemp("sp_pp_train")
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32)
    jp = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(0), jcfg))
    tokens = np.asarray(jax.random.randint(
        jax.random.key(1), (8, 33), 0, jcfg.vocab_size, dtype=jnp.int32))
    even = np.random.default_rng(2).integers(0, jcfg.vocab_size, (8, 34),
                                             dtype=np.int32)
    tparams = params_from_jax(jp, tcfg, device="cpu", dtype=torch.float32)
    torch.save(tparams, tmp / "params.pt")
    np.savez(tmp / "batch.npz", tokens=tokens)
    np.savez(tmp / "even.npz", tokens=even)
    common = dict(preset="debug", steps=STEPS, opt=OPT,
                  params=str(tmp / "params.pt"))
    sp_runs = {k: RUNS[k][0] for k in ("ring", "ulysses")}
    gangs = {
        "sp": gang.start("train", 4, tmp, LIMIT_S, mesh={"sp": 2, "tp": 2},
                         impls=[], batch=str(tmp / "batch.npz"),
                         runs=dict(sp_runs, xla_even={"attn_impl": "xla"}),
                         run_batches={"xla_even": {
                             "batch": str(tmp / "even.npz")}},
                         **common),
        "pp": gang.start("train", 4, tmp, LIMIT_S, mesh={"pp": 2, "tp": 2},
                         impls=[], batch=str(tmp / "batch.npz"),
                         runs={k: RUNS[k][0] for k in ("gpipe", "1f1b")},
                         **common),
    }
    ref = {name: _jax_run(jp, tokens, fields, axes)
           for name, (fields, axes) in RUNS.items()}
    opt = tts.default_optimizer(**OPT)
    plain = torch.load(tmp / "params.pt")     # the step updates in place
    state = opt.init(plain)
    step = tts.make_train_step(tcfg, opt, device="cpu")
    losses = []
    for _ in range(STEPS):
        plain, state, m = step(plain, state, {"tokens": even})
        losses.append(float(m["loss"]))
    ref["even"] = {"loss": losses, "params": {
        k: v.numpy() for k, v in tts._leaves(plain).items()}}
    return ref, {k: g.result() for k, g in gangs.items()}, (tcfg, tparams,
                                                            tokens)


@pytest.mark.parametrize("name", list(RUNS))
def test_sp_and_pp_steps_match_jax(runs, name):
    ref, got, _ = runs
    layout = "sp" if name in ("ring", "ulysses") else "pp"
    for rank in got[layout]:
        assert rank[name]["loss"] == got[layout][0][name]["loss"]
    _check(got[layout][0][name], ref[name])


def test_state_carries_the_pipelined_rules(runs):
    """Under a pipeline axis the layer stack is split over pp and every
    other leaf replicated (JAX's pipelined rules), moments alike."""
    from torch.distributed.tensor import Replicate, Shard

    _, got, _ = runs
    for name in ("gpipe", "1f1b"):
        run = got["pp"][0][name]
        for leaf, places in run["placements"].items():
            want = (Shard(0) if leaf.startswith("layers/") else Replicate(),
                    Replicate())
            assert places == want, leaf
            assert run["mu_placements"][leaf] == want, leaf


def test_tokens_split_by_sequence_match_the_plain_step(runs):
    """Tokens [8, 34] divide by sp: the batch is placed split by sequence
    (JAX's rule); three ``xla`` steps on (sp 2, tp 2) equal the plain
    steps within the bound."""
    ref, got, _ = runs
    run = got["sp"][0]["xla_even"]
    for a, b in zip(run["loss"], ref["even"]["loss"]):
        assert abs(a - b) / abs(b) < REL
    for name, want in ref["even"]["params"].items():
        diff = np.abs(run["params"][name] - want).max()
        assert diff <= REL * np.abs(want).max(), name


def test_ring_loss_matches_xla_loss(runs):
    """Same params and tokens: the ring step's first loss (sp 2, tp 2)
    equals the plain ``xla`` loss (JAX's test holds its bf16 pair to 5e-3;
    here both are fp32)."""
    _, got, (cfg, params, tokens) = runs
    loss = float(tllama.lm_loss(params, {"tokens": torch.tensor(tokens)},
                                cfg))
    assert abs(got["sp"][0]["ring"]["loss"][0] - loss) / loss < REL
