"""The training step on one device (port of ``ray_tpu/parallel/train_step.py``).

``default_optimizer`` is optax's ``chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))`` written out (JAX leaves it to
optax, not to a kernel). ``make_train_step`` returns ``(params, opt_state,
batch) -> (params, opt_state, {"loss", "grad_norm"})``: the loss and its
gradients through the config's family (``model_family``: the Llama
decoder or the MoE; ``attn_impl="flash"`` runs the CUDA flash kernels
forward and backward), then the optimizer. Both step functions run under
the step profiler's hook (``_instrumented``), one predicate a step while
profiling is off. ``Adam`` is the constant-rate ``optax.adam`` (optionally
behind a global-norm clip) that the RLHF learner and the fused PPO
iteration use; both optimizers share one moment update (``_adam_apply``).
``value_and_grad`` is ``jax.value_and_grad`` over a params tree.

Unlike JAX, which donates the buffers to a pure function, the step updates
params and optimizer state in place and returns the same objects: at the
1b preset that saves a 4.4 GB copy of the fp32 params (and 8.8 GB of
moments) a step.

On a mesh (``mesh=`` or ``plan=``) params and moments are DTensors placed
by the family's rules (``init_sharded_state``), each batch is placed by
the plan (its rows over dp and fsdp), and the same loss runs on them, as
JAX's runs under GSPMD (the models' docstrings say how). Each gradient is
redistributed to its param's placements (the fsdp reduce-scatter where
autograd left it partial), the global-norm clip sums squares across the
shards, and the moment update runs on each rank's local blocks, which
share one placement. 1f1b is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, check_params_on, resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from ray_tpu_torch.parallel.plan import (Plan, compile_plan, compile_step,
                                         placement_plan)
from ray_tpu_torch.util import step_profiler

Batch = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.95, 1e-8    # JAX's default_optimizer passes these
ADAM_B2 = 0.999                  # optax.adam's default (b1, eps as above)


def _leaves(params) -> Dict[str, torch.Tensor]:
    """Every param tensor by its path, parts joined by ``/``: the Llama
    family's layer weights as ``layers/<name>``, a list's items by index
    (an MLP's ``pi/layers/0/w``)."""
    flat = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            flat[prefix] = node
            return
        for k, child in items:
            walk(f"{prefix}/{k}" if prefix else str(k), child)

    walk("", params)
    return flat


def _zeros_f32(t: torch.Tensor) -> torch.Tensor:
    """fp32 zeros placed as ``t`` (a DTensor's made from its local block:
    no strategy search)."""
    if not sharding.is_sharded(t):
        return torch.zeros_like(t, dtype=torch.float32)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        torch.zeros_like(t.to_local(), dtype=torch.float32), t.device_mesh,
        t.placements, run_check=False, shape=t.shape, stride=t.stride())


def _adam_init(params) -> dict:
    leaves = _leaves(params)
    zeros = lambda: {k: _zeros_f32(t) for k, t in leaves.items()}
    return {"count": 0, "mu": zeros(), "nu": zeros()}


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm over every leaf, as torch's
    ``get_total_norm`` computes it (each leaf's norm, then the norm of
    those). A DTensor leaf (Shard or Replicate, never Partial) takes its
    block's norm, squared and summed over the mesh dims that shard it (a
    replicated dim holds the same block on each rank and counts once):
    one all-reduce per placement. On one rank the result is
    ``get_total_norm``'s to the bit (sqrt(x * x) == x in IEEE
    arithmetic)."""
    vals = list(grads.values())
    if not any(sharding.is_sharded(g) for g in vals):
        return torch.nn.utils.get_total_norm(vals)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    norms = list(torch._foreach_norm([_local(g) for g in vals]))
    groups: Dict[Tuple, list] = {}
    for i, g in enumerate(vals):
        if not sharding.is_sharded(g):
            continue
        if any(p.is_partial() for p in g.placements):
            raise ValueError(f"a partial gradient ({g.placements}) has no "
                             f"norm of its own: redistribute it first")
        if any(p.is_shard() for p in g.placements):
            key = (g.device_mesh, tuple(Partial() if p.is_shard() else
                                        Replicate() for p in g.placements))
            groups.setdefault(key, []).append(i)
    for (mesh, places), idx in groups.items():
        sq = torch.stack([norms[i] for i in idx]).square()
        total = DTensor.from_local(sq, mesh, places).full_tensor().sqrt()
        for j, i in enumerate(idx):
            norms[i] = total[j]
    return torch.linalg.vector_norm(torch.stack(norms))


def _clip_scale(grads: Dict[str, torch.Tensor], max_norm: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global norm, scale): ``optax.clip_by_global_norm``'s factor,
    max_norm / norm when the norm is at least ``max_norm``, else 1. A
    device tensor: no host read."""
    norm = global_norm(grads)
    return norm, torch.where(norm < max_norm, 1.0, max_norm / norm)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (its storage: in-place ops update it), a
    plain tensor itself."""
    return t.to_local() if sharding.is_sharded(t) else t


@torch.no_grad()
def _adam_apply(params, grads: Dict[str, torch.Tensor], state: dict, *,
                lr: float, b1: float, b2: float, eps: float,
                scale: Optional[torch.Tensor] = None,
                weight_decay: float = 0.0) -> None:
    """One Adam step in place, optax's arithmetic: each grad times
    ``scale`` (the clip factor; consumed in place), moments m = b1 m +
    (1 - b1) g and v = b2 v + (1 - b2) g^2 bias-corrected by the count
    after its increment, update m^ / (sqrt(v^) + eps) plus
    ``weight_decay`` * param, then the param moves by -lr times it."""
    count = state["count"] + 1
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    # a param, its gradient and moments share one placement, so the
    # update is elementwise on each rank's blocks
    for name, p in _leaves(params).items():
        p, g = _local(p), _local(grads[name])
        g = g if scale is None else g.mul_(scale)
        m, v = _local(state["mu"][name]), _local(state["nu"][name])
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        if weight_decay:
            u.add_(p, alpha=weight_decay)
        p.add_(u, alpha=-lr)
    state["count"] = count


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Clip by the global norm, then AdamW on a warmup-cosine schedule, with
    optax's arithmetic:

    - clip (``optax.clip_by_global_norm``): g * grad_clip / norm when the
      norm is at least ``grad_clip``, g otherwise;
    - moments m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, bias-corrected
      by the update count after its increment; update m^ / (sqrt(v^) + eps)
      plus ``weight_decay`` * param on every leaf (optax's default mask);
    - the update times -lr(count), with count taken before its increment
      (``warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup +
      1))``): the first step has lr 0 and moves no param, though the
      moments update.
    """

    lr: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    grad_clip: float

    def schedule(self, count: int) -> float:
        """Linear warmup from 0, then cosine decay to 0."""
        warm = self.warmup_steps
        if count < warm:
            return self.lr * count / warm
        decay = max(self.total_steps, warm + 1) - warm
        t = min(count - warm, decay)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    def init(self, params: llama.Params) -> dict:
        return _adam_init(params)

    def update(self, params: llama.Params, grads: Dict[str, torch.Tensor],
               state: dict) -> torch.Tensor:
        """Apply one step to ``params`` and ``state`` in place; returns the
        global norm of ``grads`` before clipping. ``grads`` is consumed (it
        is clipped in place)."""
        norm, clip = _clip_scale(grads, self.grad_clip)
        _adam_apply(params, grads, state, lr=self.schedule(state["count"]),
                    b1=B1, b2=B2, eps=EPS, scale=clip,
                    weight_decay=self.weight_decay)
        return norm


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr)`` at a constant rate, behind
    ``optax.clip_by_global_norm(grad_clip)`` when ``grad_clip`` is set
    (``optax.chain(clip_by_global_norm(c), adam(lr))``): optax's defaults
    b1 0.9, b2 0.999, eps 1e-8, no weight decay, no schedule, so the first
    step already moves by ``lr``. The RLHF learner and the fused PPO
    iteration train with it (``ray_tpu/rl/rlhf/pipeline.py:164``,
    ``ray_tpu/rl/anakin.py:73-74``)."""

    lr: float
    grad_clip: Optional[float] = None

    def init(self, params) -> dict:
        return _adam_init(params)

    def update(self, params, grads: Dict[str, torch.Tensor],
               state: dict) -> torch.Tensor:
        """Apply one step to ``params`` and ``state`` in place; returns the
        global norm of ``grads`` (before clipping, when clipped). ``grads``
        is consumed."""
        if self.grad_clip is None:
            norm, clip = global_norm(grads), None
        else:
            norm, clip = _clip_scale(grads, self.grad_clip)
        _adam_apply(params, grads, state, lr=self.lr, b1=B1, b2=ADAM_B2,
                    eps=EPS, scale=clip)
        return norm


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup_steps: int = 100, total_steps: int = 10000,
                      grad_clip: float = 1.0) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
                 total_steps=total_steps, grad_clip=grad_clip)


def model_family(cfg):
    """The module implementing ``cfg``'s family (``init_params`` /
    ``lm_loss``): the MoE family for a ``MoEConfig``, the Llama decoder
    otherwise."""
    from ray_tpu_torch.models import moe

    return moe if isinstance(cfg, moe.MoEConfig) else llama


def supports_multi_step(cfg) -> bool:
    """Whether ``make_multi_step`` can fuse K steps for this config. JAX's
    1f1b pipeline schedule cannot; the port's configs have no pipeline
    fields (1f1b is not ported), so this is always true here and the
    driver's degrade logic reads like JAX's."""
    return not (getattr(cfg, "pipeline_axis", None) is not None
                and getattr(cfg, "pipeline_schedule", "gpipe") == "1f1b")


def init_state(cfg: llama.LlamaConfig, optimizer: AdamW, *,
               generator: torch.Generator, device: DeviceLike = None
               ) -> Tuple[llama.Params, dict]:
    """fp32 master params of ``cfg``'s family from ``generator`` (which
    must live on ``device``) and the optimizer's zero state; the
    one-device stand-in for JAX's ``init_sharded_state``."""
    params = model_family(cfg).init_params(cfg, generator=generator,
                                           device=device,
                                           dtype=torch.float32)
    return params, optimizer.init(params)


def init_sharded_state(cfg: llama.LlamaConfig, mesh, optimizer: AdamW, *,
                       generator: torch.Generator,
                       rules: Optional[sharding.ShardingRules] = None
                       ) -> Tuple[llama.Params, dict]:
    """fp32 master params of ``cfg``'s family placed by its sharding rules
    (or ``rules``) on ``mesh``, and the optimizer's zero state placed
    alike. The leaves are drawn one at a time from ``generator`` (on the
    mesh's device, seeded the same on every rank: every rank draws each
    whole leaf, keeps its block and drops the rest before the next), so
    no rank ever holds the whole tree. The values are ``init_state``'s
    for the same generator."""
    from ray_tpu_torch.parallel.mesh import _check_device_type

    _check_device_type(mesh.device_type)
    fam = model_family(cfg)
    rules = rules or fam.sharding_rules()
    cmesh = sharding.compute_mesh(mesh)
    device = sharding._mesh_device(cmesh)
    placed = {}
    for name, leaf in fam.init_leaves(cfg, generator=generator,
                                      device=device, dtype=torch.float32):
        placed[name] = sharding.distribute(
            leaf, cmesh, sharding.placements(rules.spec_for(name), cmesh,
                                             leaf.ndim))
        del leaf
    params = fam._unflatten(placed)
    return params, optimizer.init(params)


def _to_device(batch: Batch, device: torch.device) -> Batch:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def value_and_grad(fn: Callable, params, has_aux: bool = False):
    """``jax.value_and_grad`` over a params tree: ``fn(params)`` gives a
    scalar loss (``(loss, aux)`` with ``has_aux``); returns that output,
    detached, and the loss's gradient for every leaf by its ``_leaves``
    name (zeros for a leaf the loss does not reach)."""
    leaves = _leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        out = fn(params)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    detach = lambda t: t.detach() if isinstance(t, torch.Tensor) else t
    if has_aux:
        out = (detach(out[0]), {k: detach(v) for k, v in out[1].items()})
    else:
        out = detach(out)
    return out, dict(zip(leaves, grads))


def make_train_step(cfg: llama.LlamaConfig, optimizer: AdamW,
                    loss_fn: Optional[Callable] = None,
                    device: DeviceLike = None, *, mesh=None,
                    plan: Optional[Plan] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}), params and state updated in place (the same objects come
    back). ``batch`` holds tokens [B, S+1] (numpy or tensors; moved to the
    device). ``grad_norm`` is the global norm before clipping. The metrics
    are 0-d tensors on the device: reading them waits for the step.
    ``loss_fn`` defaults to the family's ``lm_loss``.

    With ``mesh`` (or ``plan``) the step runs through the sharding plan
    (``compile_plan(cfg, mesh)`` unless given) on DTensor params and
    state (``init_sharded_state``); each rank passes the same global
    batch and keeps its rows; the metrics come back as plain tensors
    holding the global values, on every rank."""
    step = _step_fn(cfg, optimizer, loss_fn, device, mesh, plan)
    return _instrumented(step, cfg)


def _plan_for(cfg, mesh, plan: Optional[Plan], device: DeviceLike
              ) -> Optional[Plan]:
    if mesh is None and plan is None:
        return None
    if device is not None:
        raise ValueError("pass a mesh (or plan) or a device, not both: a "
                         "mesh decides its own device")
    return plan if plan is not None else compile_plan(cfg, mesh)


def _sharded_step_fn(cfg, optimizer: AdamW, loss_fn: Optional[Callable],
                     plan: Plan) -> Callable:
    """The uninstrumented single step on a mesh. The family's own loss
    pins the state to the plan's placements, as JAX's pjit does; a custom
    ``loss_fn`` may train params the rules do not describe, so its state
    keeps the placements it comes with."""
    custom = loss_fn is not None
    loss_fn = loss_fn or model_family(cfg).lm_loss

    def step(params, opt_state, batch):
        batch = plan.place_batch(batch)
        loss, grads = value_and_grad(lambda p: loss_fn(p, batch, cfg),
                                     params)
        leaves = _leaves(params)
        grads = {k: g if g.placements == leaves[k].placements
                 else g.redistribute(leaves[k].device_mesh,
                                     leaves[k].placements)
                 for k, g in grads.items()}
        gnorm = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss.full_tensor(),
                                   "grad_norm": gnorm}

    pinned = {}
    if not custom:
        params_pl, opt_pl = plan.state_shardings(optimizer)
        pinned = {"in_shardings": (params_pl, opt_pl, None),
                  "out_shardings": (params_pl, opt_pl, None)}
    return compile_step(step, plan, **pinned)


def _step_fn(cfg, optimizer: AdamW, loss_fn: Optional[Callable],
             device: DeviceLike, mesh=None,
             plan: Optional[Plan] = None) -> Callable:
    """The uninstrumented single step of ``make_train_step``."""
    plan = _plan_for(cfg, mesh, plan, device)
    if plan is not None:
        return _sharded_step_fn(cfg, optimizer, loss_fn, plan)
    device = resolve_device(device)
    loss_fn = loss_fn or model_family(cfg).lm_loss

    def step(params, opt_state, batch):
        check_params_on(params, device)
        batch = _to_device(batch, device)
        loss, grads = value_and_grad(lambda p: loss_fn(p, batch, cfg),
                                     params)
        gnorm = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_multi_step(cfg: llama.LlamaConfig, optimizer: AdamW, n_steps: int,
                    loss_fn: Optional[Callable] = None,
                    device: DeviceLike = None, *, mesh=None,
                    plan: Optional[Plan] = None) -> Callable:
    """K train steps over a stacked batch: (params, opt_state, batches) ->
    (params, opt_state, metrics) with each leaf of ``batches`` [K, ...] and
    each metric [K]. JAX fuses the K steps into one ``lax.scan`` program;
    here they are a loop of ``make_train_step``'s step, with no host read
    between them. ``mesh``/``plan`` as for ``make_train_step``; a stacked
    batch placed by ``plan.place_batch(..., stacked=True)`` is sliced per
    step where it lies."""
    if not supports_multi_step(cfg):
        raise NotImplementedError("multi-step over the 1f1b schedule is "
                                  "unsupported; use single-step "
                                  "(StepDriver degrades automatically)")
    step = _step_fn(cfg, optimizer, loss_fn, device, mesh, plan)

    def steps(params, opt_state, batches):
        for k, v in batches.items():
            if len(v) != n_steps:
                raise ValueError(f"batch leaf {k!r} stacks {len(v)} steps, "
                                 f"want {n_steps}")
        per_step = []
        for i in range(n_steps):
            params, opt_state, m = step(params, opt_state,
                                        {k: v[i] for k, v in batches.items()})
            per_step.append(m)
        return params, opt_state, {k: torch.stack([m[k] for m in per_step])
                                   for k in per_step[0]}

    return _instrumented(steps, cfg, stacked=True, steps_per_launch=n_steps)


def shard_batch(batch: Batch, mesh, stacked: bool = False) -> Batch:
    """Place a host batch on the mesh (the per-mesh cached plan's
    ``place_batch``): the batch dim over (dp, fsdp); ``stacked`` batches
    [K, B, ...] keep the step axis replicated."""
    return placement_plan(mesh).place_batch(batch, stacked=stacked)


def auto_mesh(n_devices: int, ranks=None, *, tp: Optional[int] = None,
              sp: int = 1, pp: int = 1, dp: int = 1, ep: int = 1,
              device_type: str = "cuda") -> Tuple[object, MeshConfig]:
    """JAX's layout for n devices: fsdp-dominant, with a tp=min(4, n)
    inner axis when n allows; sp/pp/ep carve off their axes."""
    if tp is None:
        tp = 1
        for cand in (4, 2):
            if (n_devices % (cand * sp * pp * dp * ep) == 0
                    and n_devices >= cand * 2):
                tp = cand
                break
    cfg = MeshConfig.for_devices(n_devices, tp=tp, sp=sp, pp=pp, dp=dp,
                                 ep=ep)
    return make_mesh(cfg, ranks, device_type=device_type), cfg


def _batch_tokens(batch, stacked: bool = False) -> Tuple[int, int]:
    """(trained tokens, seq len) of one step's batch. Token batches are
    [B, S+1] ([K, B, S+1] stacked): S positions train per row. A batch with
    no usable token-shaped leaf gives (0, 1)."""
    need = 3 if stacked else 2
    leaf = batch.get("tokens") if isinstance(batch, dict) else None
    if leaf is None or np.ndim(leaf) < need:
        values = batch.values() if isinstance(batch, dict) else ()
        cands = [x for x in values if np.ndim(x) >= need]
        if not cands:
            return 0, 1
        leaf = cands[0]
    shape = tuple(leaf.shape)
    if stacked:
        k, b, s1 = shape[:3]
        return k * b * max(1, s1 - 1), max(1, s1 - 1)
    b, s1 = shape[:2]
    return b * max(1, s1 - 1), max(1, s1 - 1)


def _signature(batch) -> Tuple:
    """Shapes and dtypes of a batch's leaves, by key: what a new jit-cache
    entry would be keyed on in JAX."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in batch.items()))


_PROGRAM_IDS = itertools.count()


def _instrumented(fn: Callable, cfg, stacked: bool = False,
                  steps_per_launch: int = 1) -> Callable:
    """The (params, opt_state, batch) entry point every trainer calls: the
    step profiler's per-step record (wall / compile / dispatch / device
    sync split, analytic MFU) around ``fn``. Disabled profiling costs one
    predicate per step. The profiler key is a fresh counter value per
    built step, never ``id(fn)``, which CPython reuses after GC and would
    book a new program's first call as dispatch.

    ``run._signatures`` collects the batch signatures (leaf shapes and
    dtypes) the program has run: eager PyTorch compiles nothing, and their
    count stands in for the size of JAX's jit cache (1 once warm for a
    steady feed)."""
    program_id = next(_PROGRAM_IDS)
    signatures = set()

    def run(params, opt_state, batch):
        signatures.add(_signature(batch))
        if not step_profiler.is_enabled():
            return fn(params, opt_state, batch)
        from ray_tpu_torch.util import flops as F

        tokens, seq = _batch_tokens(batch, stacked)
        return step_profiler.profiled_call(
            "train", fn, (params, opt_state, batch),
            key=("train", program_id), tokens=tokens,
            steps=steps_per_launch,
            flops=tokens * F.train_flops_per_token(cfg, seq))

    run._signatures = signatures
    return run
