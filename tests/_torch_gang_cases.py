"""What the ranks of a ``_torch_gang`` run: each case takes (rank, world,
args) and returns what the test compares, as plain Python and numpy.
Imports neither jax nor ``ray_tpu``."""

from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch
import torch.distributed.tensor.debug

import _collective_ops
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh


FAMILIES = {"llama": tllama, "moe": tmoe, "vit": tvit}


def _cfg(args):
    """``args["preset"]`` of ``args["family"]`` (default llama) in fp32,
    with ``args["cfg"]``'s fields replaced."""
    fam = FAMILIES[args.get("family", "llama")]
    return dataclasses.replace(fam.PRESETS[args["preset"]],
                               compute_dtype=torch.float32,
                               **args.get("cfg", {}))


def _mesh(args):
    return make_mesh(MeshConfig(**args["mesh"]), device_type="cpu")


def _full(tree) -> dict:
    """A copy of every leaf's global value (a collective: all ranks call
    it; a replicated DTensor's full tensor is its own storage)."""
    return {k: (v.full_tensor() if sharding.is_sharded(v) else v).numpy()
            .copy() for k, v in tts._leaves(tree).items()}


def _placements(tree) -> dict:
    return {k: tuple(v.placements) for k, v in tts._leaves(tree).items()}


class AxisComm(torch.distributed.tensor.debug.CommDebugMode):
    """CommDebugMode (collectives by type, forward and backward) that also
    counts each collective, and the bytes of its input, by the mesh axis
    whose group it ran on."""

    def __init__(self, mesh):
        super().__init__()
        self.by_group = {mesh.get_group(i).group_name: name
                         for i, name in enumerate(mesh.mesh_dim_names)}
        self.by_axis = collections.Counter()
        self.bytes_by_axis = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and not isinstance(
                func, torch._ops.HigherOrderOperator):
            names = [a for a in args if isinstance(a, str)
                     and a in self.by_group]
            if names:
                key = (func._overloadpacket.__name__,
                       self.by_group[names[0]])
                self.by_axis[key] += 1
                self.bytes_by_axis[key] += args[0].nbytes
        return out

    def summary(self) -> dict:
        glob = self.comm_module_counts.get("Global", {})
        return {"by_type": {k.__name__: v for k, v in
                            self.get_comm_counts().items()},
                "forward": {k.__name__: v for k, v in
                            glob.get("forward", {}).items()},
                "backward": {k.__name__: v for k, v in
                             glob.get("backward", {}).items()},
                "by_axis": {f"{op}@{axis}": n for (op, axis), n in
                            self.by_axis.items()},
                "bytes_by_axis": {f"{op}@{axis}": n for (op, axis), n in
                                  self.bytes_by_axis.items()}}


class _Recording:
    """An optimizer that records the placements of the gradients it is
    handed, then updates as the wrapped one does."""

    def __init__(self, opt):
        self.opt, self.seen = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, params, grads, state):
        self.seen = {k: tuple(g.placements) for k, g in grads.items()}
        return self.opt.update(params, grads, state)


def _probe(cfg, mesh, params, opt, batch) -> dict:
    """The placements of one step's gradients as backward leaves them and
    as the optimizer gets them, and one step's collectives
    (``AxisComm``)."""
    plan = tts.compile_plan(cfg, mesh)
    placed = plan.place_batch(batch)
    fam = tts.model_family(cfg)
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        _, grads = tts.value_and_grad(
            lambda p: fam.lm_loss(p, placed, cfg), params)
    rec = _Recording(opt)
    state = rec.init(params)
    step = tts.make_train_step(cfg, rec, plan=plan)
    comm = AxisComm(plan.compute_mesh)
    with comm:
        step(params, state, batch)
    return {"backward_placements": {k: tuple(g.placements)
                                    for k, g in grads.items()},
            "update_placements": rec.seen, "comm": comm.summary()}


def _batch(args) -> dict:
    with np.load(args["batch"]) as z:
        return {k: z[k] for k in z.files}


def _drive(args, mesh, params0, batch, opt, loss_fn) -> dict:
    """``StepDriver(mesh=..., steps_per_launch=K)`` over ``args["steps"]``
    copies of the batch (fused launches, then a ragged single-step tail)
    against ``make_train_step``'s plain loop on the whole params."""
    from ray_tpu_torch.train.driver import StepDriver

    cfg = dataclasses.replace(_cfg(args), attn_impl=args["impls"][0])
    fam = FAMILIES[args.get("family", "llama")]
    params = sharding.shard_pytree(params0, mesh, fam.sharding_rules())
    state = opt.init(params)
    drv = StepDriver(cfg, opt, mesh=mesh, loss_fn=loss_fn,
                     steps_per_launch=args["driver"])
    losses, norms = [], []

    def on_launch(m):
        losses.extend(np.atleast_1d(m["loss"].numpy()).tolist())
        norms.extend(np.atleast_1d(m["grad_norm"].numpy()).tolist())

    params, state, _ = drv.run(params, state,
                               iter([batch] * args["steps"]),
                               on_launch=on_launch)
    drv.recorder.close()
    plain = torch.load(args["params"])
    pstate = opt.init(plain)
    step = tts.make_train_step(cfg, opt, loss_fn, device="cpu")
    plain_losses = []
    for _ in range(args["steps"]):
        plain, pstate, m = step(plain, pstate, batch)
        plain_losses.append(float(m["loss"]))
    full = _full(params)
    return {"loss": losses, "grad_norm": norms,
            "params": full, "moments": {m: _full(state[m])
                                        for m in ("mu", "nu")},
            "count": state["count"],
            "launches": drv.launches, "steps": drv.steps,
            "plain_loss": plain_losses,
            "plain_params": {k: v.numpy()
                             for k, v in tts._leaves(plain).items()}}


def _rules(fam, cfg):
    """The family's rules for ``cfg`` (the pipelined layout under a
    pipeline axis)."""
    if getattr(cfg, "pipeline_axis", None) is not None:
        return fam.sharding_rules(pipeline=True)
    return fam.sharding_rules()


def train(rank, world, args):
    """``args["steps"]`` steps of ``make_train_step(mesh=...)`` from the
    saved params of ``args["family"]`` (ViT through ``cls_loss``), once
    per attention impl (``"-"``: the config's own), or once per named
    config variant of ``args["runs"]`` (fields to replace), each on
    ``args["batch"]`` or its own of ``args["run_batches"]``; per run the
    losses, grad norms, final params and moments (rank 0) and the
    placements the state carries."""
    mesh = _mesh(args)
    params0 = torch.load(args["params"])
    opt = tts.default_optimizer(**args["opt"])
    fam = FAMILIES[args.get("family", "llama")]
    loss_fn = tvit.cls_loss if fam is tvit else None
    runs = args.get("runs") or {
        impl: {} if impl == "-" else {"attn_impl": impl}
        for impl in args["impls"]}
    out = {}
    for impl, fields in runs.items():
        batch = _batch(dict(args, **args.get("run_batches", {}).get(
            impl, {})))
        cfg = dataclasses.replace(_cfg(args), **fields)
        params = sharding.shard_pytree(params0, mesh, _rules(fam, cfg))
        state = opt.init(params)
        step = tts.make_train_step(cfg, opt, loss_fn, mesh=mesh)
        losses, norms, secs = [], [], []
        for _ in range(args["steps"]):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)
        full = _full(params)
        moments = {m: _full(state[m]) for m in ("mu", "nu")}
        out[impl] = {"loss": losses, "grad_norm": norms, "seconds": secs,
                     "params": full if rank == 0 else None,
                     "moments": moments if rank == 0 else None,
                     "placements": _placements(params),
                     "mu_placements": _placements(state["mu"]),
                     "count": state["count"]}
    if args.get("driver"):
        out["driver"] = _drive(args, mesh, params0, batch, opt, loss_fn)
    if args.get("probe"):
        cfg = dataclasses.replace(_cfg(args), attn_impl=args["impls"][0])
        params = sharding.shard_pytree(params0, mesh, fam.sharding_rules())
        out["probe"] = _probe(cfg, mesh, params, opt, batch)
    return out


def checkpoint(rank, world, args):
    """``init_sharded_state`` of ``debug`` under ``auto_mesh(4, tp=4)``,
    saved blocking (params) and async (params and moments, the params then
    changed in place before the fence); restored into the same placements
    and into (fsdp 2, tp 2)."""
    from ray_tpu_torch.train.checkpoint import Checkpoint

    cfg = _cfg(args)
    opt = tts.default_optimizer()
    mesh_a, _ = tts.auto_mesh(world, tp=4, device_type="cpu")
    mesh_b = make_mesh(MeshConfig(fsdp=2, tp=2), device_type="cpu")
    params, state = tts.init_sharded_state(
        cfg, mesh_a, opt, generator=torch.Generator().manual_seed(3))
    full = _full(params)
    ckpt = Checkpoint(args["dir"])
    ckpt.save_pytree(params, "params")
    written = ckpt.last_save["bytes"]
    ckpt.save_pytree({"params": params, "mu": state["mu"],
                      "count": state["count"]}, "state", blocking=False)
    for leaf in tts._leaves(params).values():
        leaf.to_local().add_(1.0)      # after the snapshot: not saved
    ckpt.wait_pending()
    rules = tllama.sharding_rules()
    same = ckpt.load_pytree("params", rules, mesh=mesh_a)
    other = ckpt.load_pytree("params", rules, mesh=mesh_b)
    back = ckpt.load_pytree("state", {"params": _placements(params)},
                            mesh=mesh_a)
    total = sum(math.prod(s) for s in cfg.param_shapes().values())
    return {
        "full": full if rank == 0 else None,
        "written": written, "total_numel": total,
        "saved_placements": _placements(params),
        "same_placements": _placements(same),
        "other_placements": _placements(other),
        "local_numel": {k: sum(v.to_local().numel() for v in
                               tts._leaves(t).values())
                        for k, t in (("saved", params), ("same", same),
                                     ("other", other))},
        "same_full": _full(same), "other_full": _full(other),
        "async_full": _full(back["params"]),
        "async_placements": _placements(back["params"]),
        "async_mu_whole": all(not sharding.is_sharded(v) and v.shape == (
            full[k].shape if k in full else v.shape)
            for k, v in back["mu"].items()),
        "async_count": back["count"],
    }


def collective(rank, world, args):
    """``collective_ops`` on a group of every rank, then a subgroup of the
    last two (only they join it) and a group of one per rank."""
    from ray_tpu_torch import collective as col

    col.init_collective_group(world, rank, "all")
    out = _collective_ops.run(col, rank, lambda t: t.numpy())
    if rank >= world - 2:
        col.init_collective_group(2, rank - (world - 2), "pair")
        out["pair"] = col.allreduce(np.array([float(rank)]), "pair").numpy()
        col.destroy_collective_group("pair")
    col.init_collective_group(1, 0, f"solo{rank}")
    x = torch.arange(3.0)
    solo = col.allreduce(x, f"solo{rank}")
    out["solo_copy"] = bool(torch.equal(solo, x) and solo is not x)
    out["stats"] = col.group_stats("all")
    col.barrier("all")
    col.destroy_collective_group("all")
    col.destroy_collective_group(f"solo{rank}")
    return out


def _grads_full(grads) -> dict:
    """Global values of a gradient dict (partial ones summed)."""
    return {k: (g.full_tensor() if sharding.is_sharded(g) else g).numpy()
            .copy() for k, g in grads.items()}


def sp_attention(rank, world, args):
    """``sequence_parallel_attention`` for each impl of ``args["impls"]``
    on each saved q/k/v set (``<set>_q`` ...) under each mesh of
    ``args["meshes"]``, the inputs placed as JAX's shard_map takes them
    (batch over dp and fsdp, sequence over sp, heads over tp): the output
    and the gradients of sum(o ** 2), as global values. With
    ``check_heads``, the message of Ulysses' refusal of 2 q heads at sp
    4."""
    from ray_tpu_torch.parallel import context

    with np.load(args["qkv"]) as z:
        data = {k: torch.from_numpy(z[k]) for k in z.files}
    out = {}
    for mesh_name, shape in args["meshes"].items():
        mesh = make_mesh(MeshConfig(**shape), device_type="cpu")
        cmesh = sharding.compute_mesh(mesh)
        spec = sharding.activation_placements(
            cmesh, {0: sharding.BATCH_AXES, 1: ("sp",), 2: ("tp",)})
        for name in args["sets"]:
            for impl in args["impls"]:
                qkv = [sharding.distribute(data[f"{name}_{n}"], cmesh, spec)
                       .requires_grad_(True) for n in "qkv"]
                with context.mesh_scope(mesh):
                    o = context.sequence_parallel_attention(*qkv, impl=impl)
                grads = torch.autograd.grad(o, qkv, 2 * o.detach())
                out[f"{mesh_name}/{name}/{impl}"] = {
                    "o": o.full_tensor().detach().numpy(),
                    **{f"d{n}": g.full_tensor().numpy()
                       for n, g in zip("qkv", grads)}}
        if args.get("check_heads") and shape == {"sp": 4}:
            x = torch.zeros(1, 4, 2, 16)
            try:
                context.ulysses_attention(x, x, x,
                                          context.axis_group(mesh, "sp"))
            except ValueError as e:
                out["heads_error"] = str(e)
    return out


def pipeline_tanh(rank, world, args):
    """JAX's tanh stack (``tests/test_long_context.py:113-159``) through
    ``pipeline_apply``: the output at (pp 4) without remat, and at (pp 2,
    fsdp 2) with remat the output and the weights' gradient of
    sum(y ** 2)."""
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    def stage(stage_ws, h):
        for w in stage_ws["w"].unbind(0):
            h = torch.tanh(h @ w)
        return h

    with np.load(args["data"]) as z:
        data = {k: torch.from_numpy(z[k]) for k in z.files}
    mesh = make_mesh(MeshConfig(pp=4), device_type="cpu")
    y = pipeline_apply(stage, {"w": data["ws4"]}, data["x4"], mesh,
                       num_microbatches=4, remat=False)
    out = {"pp4": y.full_tensor().numpy()}
    mesh = make_mesh(MeshConfig(pp=2, fsdp=2), device_type="cpu")
    cmesh = sharding.compute_mesh(mesh)
    w = sharding.distribute(data["ws2"], cmesh, sharding.placements(
        sharding.P("pp"), cmesh, 3)).requires_grad_(True)
    y = pipeline_apply(stage, {"w": w}, data["x2"], mesh,
                       num_microbatches=2)
    g, = torch.autograd.grad(y, [w], 2 * y.detach())
    out["pp2"] = y.full_tensor().detach().numpy()
    out["pp2_grad"] = g.full_tensor().numpy()
    return out


def llama_pipeline(rank, world, args):
    """The ``debug`` preset's loss and gradients under both schedules on
    ``args["mesh"]`` (``pipeline_microbatches`` 4, the pipelined rules,
    inside ``mesh_scope``), for each saved batch variant: GPipe through
    ``lm_loss``, 1F1B through ``lm_loss_and_grads_1f1b``."""
    from ray_tpu_torch.parallel import context

    mesh = _mesh(args)
    base = _cfg(args)
    params = sharding.shard_pytree(torch.load(args["params"]), mesh,
                                   tllama.sharding_rules(pipeline=True))
    with np.load(args["batch"]) as z:
        data = {k: z[k] for k in z.files}
    out = {}
    for variant, keys in args["variants"].items():
        batch = {k.split("/")[-1]: data[k] for k in keys}
        for schedule in ("gpipe", "1f1b"):
            cfg = dataclasses.replace(base, pipeline_axis="pp",
                                      pipeline_microbatches=4,
                                      pipeline_schedule=schedule)
            plan = tts.compile_plan(cfg, mesh)
            placed = plan.place_batch(batch)
            with context.mesh_scope(mesh):
                loss, grads = tts._grad_fn(cfg, None)(params, placed)
            if sharding.is_sharded(loss):
                loss = loss.full_tensor()
            out[f"{variant}/{schedule}"] = {"loss": float(loss),
                                            "grads": _grads_full(grads)}
    return out


CASES = {"train": train, "checkpoint": checkpoint, "collective": collective,
         "sp_attention": sp_attention, "pipeline_tanh": pipeline_tanh,
         "llama_pipeline": llama_pipeline}
