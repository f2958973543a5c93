"""The sharding plan: placements as a carried object (port of
``ray_tpu/parallel/plan.py``).

A :class:`Plan` works out once per (config, mesh) where the params, the
optimizer state and each batch leaf live, and the step builders
(``make_train_step``, ``make_multi_step``), the ``StepDriver`` and
``shard_batch`` carry it instead of re-deriving placement per call.

JAX compiles a step in one of two modes: **pjit**, pure GSPMD with the
plan's in/out shardings pinned, or **shard_map**, for bodies with manual
collective regions (pipeline stages, ring/Ulysses attention over ``sp``).
The port's counterpart of the first is eager DTensor propagation; the
second is not ported (ROADMAP.md Queue 1 item 9), so ``plan_mode`` raises
a :class:`PlanError` for the configs and meshes that would need it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.sharding import P

PJIT = "pjit"
SHARD_MAP = "shard_map"
_ITEM_9 = "not ported yet (ROADMAP.md Queue 1 item 9)"


class PlanError(ValueError):
    """A plan/compile request that cannot be satisfied, with a hint."""

    def __init__(self, message: str, hint: str = ""):
        super().__init__(message + (f" ({hint})" if hint else ""))
        self.hint = hint


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name`` (1 when it has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(name)] if name in names else 1


def plan_mode(cfg: Any, mesh) -> str:
    """JAX's mode for ``cfg``'s step: ``PJIT`` for pure GSPMD bodies. A
    pipeline axis, ring/Ulysses attention or a non-trivial ``sp`` axis
    need JAX's ``SHARD_MAP`` mode, which the port lacks: PlanError."""
    if getattr(cfg, "pipeline_axis", None) is not None:
        raise PlanError(f"pipeline stages need the {SHARD_MAP} mode",
                        _ITEM_9)
    if getattr(cfg, "attn_impl", "") in ("ring", "ulysses"):
        raise PlanError(f"attn_impl={cfg.attn_impl!r} needs the "
                        f"{SHARD_MAP} mode", _ITEM_9)
    if mesh is not None and axis_size(mesh, "sp") > 1:
        raise PlanError(f"a non-trivial sp axis needs the {SHARD_MAP} mode",
                        _ITEM_9)
    return PJIT


def _check_splits(cfg: Any, mesh) -> None:
    """Heads split over tp keep GQA's head map local only when both head
    counts divide by it; experts split over ep must divide too."""
    tp, ep = axis_size(mesh, "tp"), axis_size(mesh, "ep")
    for field in ("n_heads", "n_kv_heads"):
        n = getattr(cfg, field, None)
        if n is not None and n % tp:
            raise PlanError(f"{field}={n} does not divide by tp={tp}",
                            "attention splits heads contiguously over tp")
    n = getattr(cfg, "n_experts", None)
    if n is not None and n % ep:
        raise PlanError(f"n_experts={n} does not divide by ep={ep}")


def abstract_params(cfg: Any) -> Dict[str, Any]:
    """``cfg``'s params tree with ``meta`` tensors for leaves: shapes
    only, nothing allocated (JAX's ``eval_shape`` of the init)."""
    from ray_tpu_torch.parallel.train_step import model_family

    fam = model_family(cfg)
    return fam._unflatten({n: torch.empty(s, device="meta")
                           for n, s in cfg.param_shapes().items()})


@dataclasses.dataclass
class Plan:
    """Placements for one (config, mesh) pair. DTensors live on
    ``compute_mesh`` (``sharding.compute_mesh``). State placements come
    from the model family's rules over the config's shapes, cached per
    optimizer; batch placements are cached per (ndim, shard_seq,
    stacked)."""

    mesh: Any
    mode: str
    cfg: Any = None
    rules: Any = None

    def __post_init__(self):
        self.compute_mesh = sharding.compute_mesh(self.mesh)
        self.device = sharding._mesh_device(self.compute_mesh)
        self._lock = threading.Lock()
        self._batch_cache: Dict[Any, tuple] = {}
        self._state: Dict[int, Tuple[Any, Any]] = {}
        self._opt_refs: Dict[int, Any] = {}

    def _rules(self):
        if self.rules is None:
            from ray_tpu_torch.parallel.train_step import model_family

            self.rules = model_family(self.cfg).sharding_rules()
        return self.rules

    def state_shardings(self, optimizer) -> Tuple[Any, Any]:
        """(params placements, optimizer-state placements) trees for
        ``cfg`` under ``optimizer``, from ``meta`` shapes (nothing
        allocated); computed once per optimizer."""
        key = id(optimizer)
        with self._lock:
            # pin the optimizer so a collected one cannot hand its id (and
            # this entry) to another
            self._opt_refs[key] = optimizer
            hit = self._state.get(key)
        if hit is not None:
            return hit
        rules = self._rules()
        abstract = abstract_params(self.cfg)
        # the moments' paths (mu/<leaf>, nu/<leaf>) end in the params',
        # so the same rules place them; the count falls to replicated
        out = (rules.tree_placements(abstract, self.mesh),
               rules.tree_placements(optimizer.init(abstract), self.mesh))
        with self._lock:
            self._state[key] = out
        return out

    def batch_sharding(self, ndim: int, shard_seq: bool,
                       stacked: bool) -> tuple:
        """The placements of one batch leaf: the batch dim over (dp, fsdp),
        the sequence over sp where ``shard_seq``; a stacked [K, ...] leaf
        keeps its leading step axis replicated."""
        key = (ndim, shard_seq, stacked)
        with self._lock:
            hit = self._batch_cache.get(key)
            if hit is None:
                lead = (None,) if stacked else ()
                spec = P(*lead, sharding.BATCH_AXES,
                         *(("sp",) if shard_seq else ()))
                hit = sharding.placements(spec, self.compute_mesh, ndim)
                self._batch_cache[key] = hit
            return hit

    def place_batch(self, batch: Any, stacked: bool = False) -> Any:
        """Place a host batch (the global batch, the same on every rank)
        on the mesh: each rank keeps its rows, batch dim over (dp, fsdp),
        without a collective. A leaf already placed so comes back as it
        is; one placed otherwise is redistributed."""
        from torch.distributed.tensor import DTensor

        bdim = 1 if stacked else 0
        split = (axis_size(self.mesh, "dp") * axis_size(self.mesh, "fsdp"))

        def place(path, x):
            if not isinstance(x, (torch.Tensor, np.ndarray)):
                return x
            target = self.batch_sharding(x.ndim, False, stacked)
            if isinstance(x, DTensor):
                return x if x.placements == target else x.redistribute(
                    self.compute_mesh, target)
            if x.shape[bdim] % split:
                raise ValueError(
                    f"batch leaf {path!r} has {x.shape[bdim]} rows, not "
                    f"divisible by dp*fsdp={split}")
            return sharding.distribute(x, self.compute_mesh, target,
                                       self.device)

        return sharding._walk(batch, place)

    def replicated(self) -> tuple:
        """The fully replicated placements (metrics)."""
        return sharding.placements(P(), self.compute_mesh)


def compile_plan(cfg: Any, mesh, rules: Any = None) -> Plan:
    """The sharding plan for ``cfg`` on ``mesh``."""
    if mesh is None:
        raise PlanError("compile_plan needs a mesh",
                        "pass the mesh the step will run under")
    mode = plan_mode(cfg, mesh)
    _check_splits(cfg, mesh)
    return Plan(mesh=mesh, mode=mode, cfg=cfg, rules=rules)


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement

    return isinstance(x, tuple) and bool(x) and all(
        isinstance(p, Placement) for p in x)


def _apply(tree: Any, shardings: Any, fn: Callable) -> Any:
    """``fn(leaf, placements)`` over ``tree``'s tensor leaves, with
    ``shardings`` a matching tree or one placements tuple for a whole
    subtree (JAX's prefix shardings); ``None`` leaves a subtree alone."""
    if shardings is None:
        return tree
    if _is_placements(shardings):
        return sharding._walk(tree, lambda _, x: fn(x, shardings)
                              if isinstance(x, (torch.Tensor, np.ndarray))
                              else x)
    if isinstance(tree, dict):
        return {k: _apply(v, shardings.get(k), fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_apply(v, s, fn) for v, s in zip(tree, shardings))
    return tree


def compile_step(body: Callable, plan: Optional[Plan], *,
                 in_shardings: Any = None,
                 out_shardings: Any = None) -> Callable:
    """``body`` run under the plan: DTensor propagation with plain tensors
    (the RoPE tables, scalars) taken as replicated. With ``in_shardings``
    and ``out_shardings`` (both or neither: one without the other is a
    config bug, as in JAX) each argument leaf is placed or redistributed
    to its pinned placements on the way in and each output leaf on the
    way out. No plan: ``body`` itself."""
    if (in_shardings is None) != (out_shardings is None):
        raise PlanError(
            "compile_step requires both in_shardings and out_shardings "
            "when either is given",
            "pass both sharding arguments or omit them to infer from args")
    if plan is None:
        return body
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    cmesh = plan.compute_mesh

    def place_in(x, places):
        if isinstance(x, DTensor):
            return x if x.placements == places else x.redistribute(
                cmesh, places)
        return sharding.distribute(x, cmesh, places, plan.device)

    def place_out(x, places):
        if not isinstance(x, DTensor) or x.placements == places:
            return x
        return x.redistribute(cmesh, places)

    def run(*args):
        if in_shardings is not None:
            args = tuple(_apply(a, s, place_in)
                         for a, s in zip(args, in_shardings))
        with implicit_replication():
            out = body(*args)
        if out_shardings is not None:
            out = _apply(out, out_shardings, place_out)
        return out

    return run


# ---- per-mesh placement-plan cache ------------------------------------------
# shard_batch is called per batch from every trainer loop; one placement
# Plan per mesh derives the batch placements once, not per call.
_placement_lock = threading.Lock()
# keyed by the mesh object (equal layouts over other process groups compare
# equal), which the entry keeps alive so its id is not reused
_placement_plans: Dict[int, Plan] = {}  # rt: guarded-by(_placement_lock)


def placement_plan(mesh) -> Plan:
    """The cached batch-placement plan for ``mesh``."""
    with _placement_lock:
        plan = _placement_plans.get(id(mesh))
        if plan is None:
            if len(_placement_plans) > 64:  # meshes are few; tests make many
                _placement_plans.clear()
            plan = Plan(mesh=mesh, mode=PJIT)
            _placement_plans[id(mesh)] = plan
        return plan
