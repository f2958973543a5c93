"""The port's partition rules, placements and sharding plan
(``ray_tpu_torch/parallel/sharding.py``, ``plan.py``) against
``ray_tpu.parallel``:

- every family's rules give each param the spec JAX's give it, and cover
  every matrix (``tests/test_model_llama.py:138``);
- for the same mesh coordinates a rank's local block of a DTensor (made by
  ``sharding.distribute``, rank r of an 8-rank group with torch's
  ``fake`` backend, which runs no collective) is the block JAX's
  ``NamedSharding`` gives device r, for every param spec of the rules and
  the batch spec, whose dim is sharded over two axes (dp-major);
- plan-mode selection, batch placement and ``compile_step``'s check, as
  ``tests/test_zz_train_fast.py:179-260`` holds JAX's.
"""

import contextlib
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import plan as jplan
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import plan as tplan
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel import train_step as tts

FAMILIES = {
    "llama": (jllama, tllama, "debug", lambda m, c: m.init_params(
        jax.random.key(0), c)),
    "moe": (jmoe, tmoe, "moe-debug", lambda m, c: m.init_params(
        jax.random.key(0), c)),
    "vit": (jvit, tvit, "debug", lambda m, c: m.init_params(
        jax.random.key(0), c)),
}
MESHES = [dict(dp=2, fsdp=2, tp=2), dict(fsdp=4, tp=2), dict(dp=2, fsdp=4),
          dict(fsdp=2, ep=2, tp=2)]


@contextlib.contextmanager
def fake_rank(rank: int, world: int = 8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _flat_paths(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in flat}


def _jax_specs(family):
    jm, _, preset, init = FAMILIES[family]
    abstract = jax.eval_shape(lambda: init(jm, jm.PRESETS[preset]))
    rules = jm.sharding_rules()
    return abstract, _flat_paths(rules.tree_specs(abstract))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_rules_give_jax_specs_and_cover_every_matrix(family):
    _, tm, preset, _ = FAMILIES[family]
    abstract, jspecs = _jax_specs(family)
    cfg = tm.PRESETS[preset]
    rules = tm.sharding_rules()
    shapes = cfg.param_shapes()
    specs = rules.tree_specs(tm._unflatten(
        {n: torch.empty(s, device="meta") for n, s in shapes.items()}))
    tspecs = {f"{k}/{n}" if isinstance(v, dict) else k: s
              for k, v in specs.items()
              for n, s in (v.items() if isinstance(v, dict) else [(k, v)])}
    assert set(tspecs) == set(jspecs)
    for path, spec in tspecs.items():
        assert tuple(spec) == tuple(jspecs[path]), path
        if len(shapes[path]) >= 2 and "norm" not in path and \
                family != "vit":
            assert spec != sharding.P(), f"unsharded matrix at {path}"


def test_pipeline_rules_name_item_9():
    """The pipelined rules (item 9 of the roadmap) are JAX's: the layer
    stack over pp, every other leaf replicated; MoE refuses them, as JAX's
    does."""
    abstract, _ = _jax_specs("llama")
    jspecs = _flat_paths(jllama.sharding_rules(pipeline=True).tree_specs(
        abstract))
    trules = tllama.sharding_rules(pipeline=True)
    for path, spec in jspecs.items():
        assert tuple(trules.spec_for(path)) == tuple(spec), path
    assert tuple(trules.spec_for("layers/wq")) == ("pp",)
    for mod in (tmoe, jmoe):
        with pytest.raises(NotImplementedError, match="MoE family"):
            mod.sharding_rules(pipeline=True)
    assert tuple(tllama.data_rules().spec_for("tokens")) == tuple(
        jllama.data_rules().spec_for("tokens"))
    assert tuple(sharding.data_spec()) == tuple(jsharding.data_spec())
    assert tuple(sharding.data_spec("sp")) == tuple(
        jsharding.data_spec("sp"))


def _cases(kw):
    """(name, shape, spec) for every llama and moe param and two batch
    leaves, at shapes the mesh divides."""
    out = []
    for family in ("llama", "moe"):
        abstract, jspecs = _jax_specs(family)
        shapes = {p: leaf.shape for p, leaf in _flat_paths(abstract).items()}
        for path, spec in jspecs.items():
            out.append((f"{family}:{path}", shapes[path], spec))
    out.append(("tokens", (8, 33), jsharding.data_spec()))
    out.append(("rows_cols", (8, 6), jax.sharding.PartitionSpec(
        ("dp", "fsdp"), "tp")))
    return out


@pytest.mark.parametrize("kw", MESHES)
def test_local_block_is_jax_shard_of_that_device(kw):
    jm = jmesh.make_mesh(jmesh.MeshConfig(**kw), jax.devices())
    cases = _cases(kw)
    rng = np.random.default_rng(0)
    values = {name: rng.standard_normal(shape).astype(np.float32)
              for name, shape, _ in cases}
    want = {name: NamedSharding(jm, spec).devices_indices_map(shape)
            for name, shape, spec in cases}
    for rank in range(8):
        device = jax.devices()[rank]
        with fake_rank(rank):
            mesh = tmesh.make_mesh(tmesh.MeshConfig(**kw), device_type="cpu")
            cm = sharding.compute_mesh(mesh)
            for name, shape, spec in cases:
                places = sharding.placements(sharding.P(*spec), cm,
                                             len(shape))
                dt = sharding.distribute(values[name], cm, places)
                assert tuple(dt.shape) == shape
                np.testing.assert_array_equal(
                    dt.to_local().numpy(), values[name][want[name][device]],
                    err_msg=f"{name} rank {rank} {kw}")


def test_placements_refuse_what_jax_refuses():
    class Mesh:
        mesh_dim_names = ("dp", "fsdp", "tp")

    with pytest.raises(ValueError, match="more entries"):
        sharding.placements(sharding.P("tp", None, "fsdp"), Mesh(), 2)
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(sharding.P("tp", "tp"), Mesh())
    with pytest.raises(ValueError, match="unknown mesh axis"):
        sharding.placements(sharding.P("model"), Mesh())
    # dp-major is what DTensor's mesh order says; fsdp-major it cannot
    assert sharding.placements(sharding.P(("dp", "fsdp")), Mesh()) == (
        Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="out of mesh order"):
        sharding.placements(sharding.P(("fsdp", "dp")), Mesh())


def test_shard_pytree_places_tensors_and_passes_the_rest():
    cfg = dataclasses.replace(tllama.PRESETS["debug"],
                              compute_dtype=torch.float32)
    params = tllama.init_params(cfg, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    with fake_rank(3):
        mesh = tmesh.make_mesh(tmesh.MeshConfig(dp=2, fsdp=2, tp=2),
                               device_type="cpu")
        placed = sharding.shard_pytree({"p": params, "n": 7}, mesh,
                                       tllama.sharding_rules())
        assert placed["n"] == 7
        wq = placed["p"]["layers"]["wq"]
        assert wq.placements == (Replicate(), Shard(1), Shard(2))
        assert wq.to_local().shape == (2, 32, 32)


# ---- the sharding plan (tests/test_zz_train_fast.py:179-260) ----------------

def _by_name(tree: dict) -> dict:
    """A params-shaped tree of placements, by flat name."""
    return {f"{k}/{n}" if isinstance(v, dict) else k: x
            for k, v in tree.items()
            for n, x in (v.items() if isinstance(v, dict) else [(k, v)])}


def test_plan_mode_selection_and_placement():
    cfg = tllama.PRESETS["debug"]
    jcfg = jllama.PRESETS["debug"]
    jmesh8, _ = jts.auto_mesh(8, tp=2)
    assert jplan.plan_mode(jcfg, jmesh8) == jplan.PJIT
    with fake_rank(0):
        mesh, mcfg = tts.auto_mesh(8, tp=2, device_type="cpu")
        assert (mcfg.fsdp, mcfg.tp) == (4, 2)
        assert tplan.plan_mode(cfg, mesh) == tplan.PJIT
        # manual-collective bodies (item 9): JAX's shard_map mode
        jsp8, _ = jts.auto_mesh(8, tp=1, sp=2)
        tsp8 = tts.auto_mesh(8, tp=1, sp=2, device_type="cpu")[0]
        for fields, jm, tm in (({"attn_impl": "ring"}, jmesh8, mesh),
                               ({"attn_impl": "ulysses"}, jmesh8, mesh),
                               ({"pipeline_axis": "pp"}, jmesh8, mesh),
                               ({}, jsp8, tsp8)):
            want = jplan.plan_mode(dataclasses.replace(jcfg, **fields), jm)
            assert want == jplan.SHARD_MAP
            assert tplan.plan_mode(dataclasses.replace(cfg, **fields),
                                   tm) == want
        assert tplan.plan_mode(types.SimpleNamespace(pipeline_axis="pp"),
                               None) == tplan.SHARD_MAP
        # the sequence over a non-trivial sp axis where it divides (JAX's
        # rule), rows over (dp, fsdp) always
        splan = tplan.compile_plan(cfg, tsp8)
        jsplan = jplan.compile_plan(jcfg, jsp8)
        for n in (33, 34):
            got = splan.place_batch({"t": np.zeros((8, n), np.int32)})["t"]
            want = jsplan.place_batch({"t": np.zeros((8, n), np.int32)})["t"]
            assert tuple(got.placements) == sharding.placements(
                want.sharding.spec, splan.compute_mesh, 2), n
            assert (got.placements[1] == Shard(1)) == (n % 2 == 0)
        plan = tplan.compile_plan(cfg, mesh)
        toks = np.zeros((8, 33), np.int32)
        via_plan = plan.place_batch({"tokens": toks})["tokens"]
        via_shard_batch = tts.shard_batch({"tokens": toks}, mesh)["tokens"]
        assert via_plan.placements == via_shard_batch.placements == (
            Shard(0), Replicate())
        assert via_plan.to_local().shape == (2, 33)
        stacked = plan.place_batch({"tokens": np.zeros((2, 8, 33))},
                                   stacked=True)["tokens"]
        assert stacked.placements == (Shard(1), Replicate())
        # a placed leaf comes back as it is
        assert plan.place_batch({"t": via_plan})["t"] is via_plan
        assert plan.batch_sharding(2, False, False) is \
            plan.batch_sharding(2, False, False)
        assert plan.replicated() == (Replicate(), Replicate())
        assert sharding.named_sharding(mesh, ("dp", "fsdp"), "tp") == (
            Shard(0), Shard(1))
        assert tplan.placement_plan(mesh) is tplan.placement_plan(mesh)
        with pytest.raises(ValueError, match="not divisible"):
            plan.place_batch({"tokens": np.zeros((6, 33))})
        # the planned state placements are where init_sharded_state puts
        # the state
        opt = tts.default_optimizer(total_steps=10)
        params_pl, opt_pl = plan.state_shardings(opt)
        params, state = tts.init_sharded_state(
            dataclasses.replace(cfg, compute_dtype=torch.float32), mesh,
            opt, generator=torch.Generator().manual_seed(0))
        live = {k: v.placements for k, v in tts._leaves(params).items()}
        assert live == _by_name(params_pl)
        assert {k: v.placements for k, v in state["mu"].items()} == \
            opt_pl["mu"]
        assert plan.state_shardings(opt) is plan.state_shardings(opt)


def test_compile_plan_checks_sp_and_pp_splits():
    """Pipeline stages take equal blocks of layers, Ulysses splits each tp
    rank's q heads over sp, and ring or Ulysses attention splits the
    sequence in equal chunks: PlanErrors, raised before any step runs.
    compile_step keeps JAX's both-or-neither rule in shard_map mode."""
    cfg = tllama.PRESETS["debug"]           # 2 layers, 4 q heads
    with fake_rank(0):
        pp4 = tts.auto_mesh(8, tp=1, pp=4, device_type="cpu")[0]
        with pytest.raises(tplan.PlanError, match="n_layers=2 .* pp=4"):
            tplan.compile_plan(dataclasses.replace(cfg, pipeline_axis="pp"),
                               pp4)
        sp4_tp2 = tts.auto_mesh(8, tp=2, sp=4, device_type="cpu")[0]
        uly = dataclasses.replace(cfg, attn_impl="ulysses")
        with pytest.raises(tplan.PlanError, match="2 q heads .* sp=4"):
            tplan.compile_plan(uly, sp4_tp2)
        plan = tplan.compile_plan(dataclasses.replace(cfg, attn_impl="ring"),
                                  sp4_tp2)
        assert plan.mode == tplan.SHARD_MAP
        with pytest.raises(tplan.PlanError, match="both"):
            tplan.compile_step(lambda x: x, plan, out_shardings=(None,))
        x = sharding.distribute(torch.zeros(2, 33, 4), plan.compute_mesh,
                                plan.replicated())
        with pytest.raises(tplan.PlanError, match="33 does not divide by "
                                                  "sp=4"):
            sharding.split_sequence(x)
        x = sharding.distribute(torch.zeros(2, 32, 4), plan.compute_mesh,
                                plan.replicated())
        split = sharding.split_sequence(x)
        assert split.placements == (Shard(1), Replicate())   # (sp, tp)
        assert split.to_local().shape == (2, 8, 4)
        assert sharding.gather_sequence(split).placements == x.placements


def test_compile_plan_checks_splits_and_compile_step_both_shardings():
    cfg = tllama.PRESETS["debug"]           # 4 q heads, 2 kv heads
    with fake_rank(0):
        mesh, _ = tts.auto_mesh(8, tp=4, device_type="cpu")
        with pytest.raises(tplan.PlanError, match="n_kv_heads=2"):
            tplan.compile_plan(cfg, mesh)
        with pytest.raises(tplan.PlanError, match="n_experts=4"):
            tplan.compile_plan(tmoe.PRESETS["moe-debug"],
                               tts.auto_mesh(8, tp=1, ep=8,
                                             device_type="cpu")[0])
        plan = tplan.compile_plan(cfg, tts.auto_mesh(8, tp=2,
                                                     device_type="cpu")[0])
        with pytest.raises(tplan.PlanError, match="both"):
            tplan.compile_step(lambda x: x, plan, in_shardings=(None,))
    with pytest.raises(tplan.PlanError, match="needs a mesh"):
        tplan.compile_plan(cfg, None)
    jp = jplan.compile_plan(jllama.PRESETS["debug"],
                            jts.auto_mesh(8, tp=2)[0])
    with pytest.raises(jplan.PlanError, match="both"):
        jplan.compile_step(lambda x: x, jp, in_shardings=(None,),
                           donate_argnums=())
