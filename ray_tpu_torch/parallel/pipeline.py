"""Pipeline parallelism: microbatch pipelining over a mesh axis (port of
``ray_tpu/parallel/pipeline.py``).

Each rank of the ``pp`` group holds one stage: its [L/P, ...] block of
the stacked layer weights. The schedules are JAX's ticks written out by
hand: at each tick a rank runs its stage on one microbatch, then one
``batch_isend_irecv`` moves activations to the next rank and cotangents
to the previous one. Autograd cannot cross ranks, so the backward is
hand-written too.

Two schedules:
  - **GPipe** (``pipeline_spmd``/``pipeline_apply``): m + p - 1 forward
    ticks, then the same ticks in reverse for the backward (an
    ``autograd.Function``). Activations of all m microbatches live until
    the backward (with ``remat``, only each stage's input: the stage runs
    again in the backward).
  - **1F1B** (``pipeline_1f1b``): forward and backward interleaved over
    m + 2p - 1 ticks; every backward is a ``torch.autograd.grad`` of stage
    plus loss head on the stashed input (full remat by construction), so
    at most 2p - 1 microbatch inputs are stashed whatever m is.

JAX's schedules are one SPMD program, so every rank computes at every
tick and masks what it must not keep; eager PyTorch branches instead. A
rank computes only its valid ticks, the 1F1B loss head runs only on the
last stage (JAX evaluates it on every rank with its cotangent masked to
zero), and the last stage's 1F1B forward, whose output goes nowhere, is
not run: its backward recomputes it. The values are JAX's;
``schedule_stats`` keeps JAX's cost model of its own program.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.context import (axis_group, group_rank,
                                            group_size)
from ray_tpu_torch.parallel.sharding import P


def _microbatch(x: Optional[torch.Tensor], m: int):
    """[B, ...] -> [m, B/m, ...] (``None`` stays ``None``)."""
    if x is None:
        return None
    return x.reshape(m, x.shape[0] // m, *x.shape[1:])


def _hop(group, sends: Sequence[Tuple[torch.Tensor, int]],
         recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """One tick's exchange on ``group``: each (tensor, group rank) of
    ``sends`` sent, each (buffer, group rank) of ``recvs`` filled, in one
    ``batch_isend_irecv``."""
    if not sends and not recvs:
        return
    import torch.distributed as dist

    peer = lambda r: dist.get_global_rank(group, r)
    ops = [dist.P2POp(dist.isend, x.contiguous(), peer(r), group)
           for x, r in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer(r), group) for buf, r in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def _broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` from group rank ``src`` on every rank of ``group``."""
    if group_size(group) > 1:
        import torch.distributed as dist

        dist.broadcast(x, dist.get_global_rank(group, src), group=group)
    return x


def _grad(outputs, inputs, grad_outputs):
    """``torch.autograd.grad`` with zeros for inputs the outputs do not
    reach."""
    return torch.autograd.grad(outputs, inputs, grad_outputs,
                               allow_unused=True, materialize_grads=True)


class _GPipeRun:
    """One GPipe call on this rank: the forward ticks, and what the
    backward ticks need (each microbatch's stage input, or with ``remat``
    off its graph)."""

    def __init__(self, stage_fn, names, group, m, extras, remat):
        self.stage_fn, self.names, self.group = stage_fn, names, group
        self.m, self.extras, self.remat = m, extras, remat
        self.p, self.r = group_size(group), group_rank(group)

    def _stage(self, w, a, j):
        if self.extras is None:
            return self.stage_fn(w, a)
        return self.stage_fn(w, a, self.extras[j])

    def forward(self, x: torch.Tensor, leaves) -> torch.Tensor:
        p, r, m = self.p, self.r, self.m
        xs = _microbatch(x, m)
        self.x_shape, self.x_dtype = x.shape, x.dtype
        self.w = {k: t.detach().requires_grad_(True)
                  for k, t in zip(self.names, leaves)}
        self.saved: Dict[int, Any] = {}
        outputs = torch.empty_like(xs)
        recv = None
        for t in range(m + p - 1):
            j, y = t - r, None      # stage r works on microbatch t - r
            if 0 <= j < m:
                a = xs[j] if r == 0 else recv
                if self.remat:
                    self.saved[j] = a
                    with torch.no_grad():
                        y = self._stage(self.w, a, j)
                else:
                    a = a.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = self._stage(self.w, a, j)
                    self.saved[j] = (a, y)
                    y = y.detach()
                if r == p - 1:
                    outputs[j] = y
            sends = [(y, r + 1)] if y is not None and r < p - 1 else []
            recvs = []
            if r > 0 and 0 <= t + 1 - r < m:
                recv = torch.empty_like(xs[0])
                recvs = [(recv, r - 1)]
            _hop(self.group, sends, recvs)
        # the outputs live on the last rank: every rank returns them (JAX's
        # psum of the last rank's outputs)
        return _broadcast(outputs, p - 1, self.group).reshape(x.shape)

    def backward(self, g: torch.Tensor):
        """The forward ticks in reverse: the last rank starts from the
        output cotangent, the others from what the next rank sends."""
        p, r, m = self.p, self.r, self.m
        gs = _microbatch(g, m)
        w = self.w
        gw = {k: torch.zeros_like(t) for k, t in w.items()}
        gx = torch.zeros(gs.shape, dtype=self.x_dtype, device=gs.device)
        recv = None
        for t in reversed(range(m + p - 1)):
            j, ga = t - r, None
            if 0 <= j < m:
                gy = gs[j] if r == p - 1 else recv
                if self.remat:
                    a = self.saved.pop(j).detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = self._stage(w, a, j)
                else:
                    a, y = self.saved.pop(j)
                grads = _grad(y, [a, *w.values()], gy.to(y.dtype))
                ga = grads[0]
                for k, d in zip(w, grads[1:]):
                    gw[k].add_(d)
                if r == 0:
                    gx[j] = ga
            sends = [(ga, r - 1)] if ga is not None and r > 0 else []
            recvs = []
            if r < p - 1 and 0 <= t - 1 - r < m:
                recv = torch.empty_like(gs[0])
                recvs = [(recv, r + 1)]
            _hop(self.group, sends, recvs)
        # every pp rank holds the input replicated: each gets its gradient
        gx = _broadcast(gx, 0, self.group).reshape(self.x_shape)
        return gx, [gw[k] for k in self.names]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _GPipeRun, x, *leaves):
        ctx.run = run
        return run.forward(x, leaves)

    @staticmethod
    def backward(ctx, g):
        gx, gleaves = ctx.run.backward(g)
        return (None, gx, *gleaves)


def pipeline_spmd(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                  x: torch.Tensor, group, num_microbatches: int,
                  extras: Optional[torch.Tensor] = None, *,
                  remat: bool = False) -> torch.Tensor:
    """GPipe over ``group`` (the pp ranks; ``None`` for a pipeline of one)
    on this rank's local blocks: ``stage_fn(stage_params, mb)``, or
    ``stage_fn(stage_params, mb, extras_mb)`` with ``extras``, is this
    rank's slice of the network on one microbatch. ``x``: this rank's
    [B, ...] rows (every pp rank passes the same); B must divide by
    ``num_microbatches``. ``extras`` ([B, ...], e.g. segment ids) is
    indexed locally at each tick, never sent through the pipe. Returns
    the last stage's output on every pp rank. Differentiable (to ``x`` and
    ``stage_params``); with ``remat`` each stage runs again in the
    backward instead of keeping its activations."""
    m = num_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by {m} "
                         f"microbatches")
    names = list(stage_params)
    run = _GPipeRun(stage_fn, names, group, m, _microbatch(extras, m), remat)
    return _GPipe.apply(run, x, *(stage_params[k] for k in names))


def _axes_of(spec: P) -> Tuple[str, ...]:
    """Every mesh axis a spec names."""
    out = []
    for entry in spec:
        out += [entry] if isinstance(entry, str) else list(entry or ())
    return tuple(out)


def _placed(x, cmesh, places: tuple):
    """``x`` as a DTensor with ``places``: a plain tensor is taken as the
    global value every rank holds (JAX's ``device_put``)."""
    if sharding.is_sharded(x):
        return x if x.placements == places else x.redistribute(cmesh, places)
    return sharding.distribute(x, cmesh, places)


def _with(places: tuple, names, axes, placement) -> tuple:
    """``places`` with the mesh dims of ``axes`` set to ``placement``."""
    return tuple(placement if n in axes else p
                 for n, p in zip(names, places))


def pipeline_apply(stage_fn: Callable, params: Dict[str, torch.Tensor],
                   x, mesh, *, axis_name: str = "pp",
                   num_microbatches: int = 4,
                   batch_axes: Tuple = (("dp", "fsdp"),),
                   param_layer_axis: int = 0, remat: bool = True,
                   extras=None):
    """GPipe over ``mesh``'s ``axis_name`` through ``local_map`` (JAX's
    ``shard_map``). ``params``: leaves stacking ALL layers on
    ``param_layer_axis``, split over ``axis_name`` so each rank's
    ``stage_fn`` sees its [L/P, ...] block; ``x``: [B, ...] activations
    with the batch over ``batch_axes`` (a partition spec's entries);
    ``extras``: optional per-example side input (segment ids) placed like
    ``x``. DTensors are redistributed where needed, plain tensors taken as
    the global value on every rank. Returns a DTensor placed like ``x``.
    A weight's local gradient is partial over the batch axes (its rows'
    share)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    cmesh = sharding.compute_mesh(mesh)
    names = cmesh.mesh_dim_names
    group = axis_group(mesh, axis_name)
    xspec = P(*batch_axes)
    x_pl = sharding.placements(xspec, cmesh)
    data = _axes_of(xspec)
    keys = list(params)
    p_pls = [sharding.placements(P(*([None] * param_layer_axis), axis_name),
                                 cmesh, params[k].ndim) for k in keys]
    g_pls = [_with(pl, names, data, Partial()) for pl in p_pls]
    args = [_placed(x, cmesh, x_pl)]
    args += [_placed(params[k], cmesh, pl) for k, pl in zip(keys, p_pls)]
    in_pls, grad_pls = [x_pl, *p_pls], [x_pl, *g_pls]
    if extras is not None:
        ex_pl = sharding.placements(xspec, cmesh, extras.ndim)
        args.append(_placed(extras, cmesh, ex_pl))
        in_pls.append(ex_pl)
        grad_pls.append(ex_pl)

    def body(xx, *rest):
        leaves = dict(zip(keys, rest[:len(keys)]))
        ex = rest[len(keys)] if extras is not None else None
        return pipeline_spmd(stage_fn, leaves, xx, group, num_microbatches,
                             extras=ex, remat=remat)

    return local_map(body, out_placements=(x_pl,),
                     in_placements=tuple(in_pls),
                     in_grad_placements=tuple(grad_pls), device_mesh=cmesh,
                     redistribute_inputs=True)(*args)


def pipeline_1f1b(stage_fn: Callable, head_loss_fn: Callable,
                  layer_params: Dict[str, torch.Tensor],
                  head_params: Dict[str, torch.Tensor], x, targets, mesh,
                  *, axis_name: str = "pp", num_microbatches: int = 4,
                  batch_axes: Tuple = ("dp", "fsdp", "tp"),
                  segments=None, loss_mask=None):
    """Interleaved forward and backward (1F1B) with manual per-stage
    backward passes. Returns ``(loss, layer_grads, head_grads, x_grads)``.

    T = m + 2p - 1 ticks. At tick t rank r first reads the stash slot of
    microbatch ``t - 2p + 1 + r`` for its backward (the forward of tick t
    may reuse the slot), runs the forward of microbatch ``t - r`` and
    stashes its input in slot ``mb % (2p - 1)``, then the backward: a
    ``torch.autograd.grad`` of the stage (the last rank: stage + final
    loss head) on the stashed input, driven on the last rank by the
    loss's cotangent ``cnt_mb / total_cnt`` (the loss is the global mean
    over tokens; ``total_cnt`` is the mask's sum over the batch axes)
    and elsewhere by the cotangent the next rank sent. Then activations
    hop forward and cotangents back.

    ``stage_fn(layers, h, seg)``; ``head_loss_fn(head_params, y, tgt,
    mask) -> mean nll``. ``layer_params``: [L, ...] stacked leaves split
    over ``axis_name`` on dim 0; ``head_params`` replicated; ``x``,
    ``targets``, ``segments``, ``loss_mask``: rows over ``batch_axes``.
    The gradients come back as DTensors partial over the batch axes
    (layers, split over ``axis_name``) and over ``axis_name`` too (head:
    only the last stage's are nonzero); ``x_grads`` is placed like ``x``
    but partial over ``axis_name`` (only the first stage's nonzero); the
    caller's redistribution sums them, as JAX's psums do. The loss is a
    plain tensor, the same on every rank."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    m = num_microbatches
    cmesh = sharding.compute_mesh(mesh)
    names = cmesh.mesh_dim_names
    group = axis_group(mesh, axis_name)
    batch_axes = tuple(batch_axes)
    x_pl = sharding.placements(P(batch_axes), cmesh)
    mask = (torch.ones_like(targets, dtype=torch.float32)
            if loss_mask is None else loss_mask.float())
    total = mask.sum()
    total = (total.full_tensor() if sharding.is_sharded(total)
             else total).clamp(min=1.0)
    lkeys, hkeys = list(layer_params), list(head_params)
    l_pls = [sharding.placements(P(axis_name), cmesh, layer_params[k].ndim)
             for k in lkeys]
    h_pls = [sharding.placements(P(), cmesh) for _ in hkeys]
    rows_of = lambda t: _placed(t, cmesh, sharding.placements(
        P(batch_axes), cmesh, t.ndim))
    args = [_placed(x, cmesh, x_pl), rows_of(targets), rows_of(mask)]
    args += [_placed(layer_params[k], cmesh, pl)
             for k, pl in zip(lkeys, l_pls)]
    args += [_placed(head_params[k], cmesh, pl)
             for k, pl in zip(hkeys, h_pls)]
    if segments is not None:
        args.append(rows_of(segments))
    in_pls = tuple(a.placements for a in args)

    def body(xx, tt, mm, *rest):
        w = dict(zip(lkeys, rest[:len(lkeys)]))
        head = dict(zip(hkeys, rest[len(lkeys):len(lkeys) + len(hkeys)]))
        ss = rest[-1] if segments is not None else None
        return _one_f_one_b(stage_fn, head_loss_fn, w, head, xx, tt, mm, ss,
                            group, m, total)

    data = tuple(a for a in batch_axes if a in names)
    everywhere = data + (axis_name,)
    scalar = _with(sharding.placements(P(), cmesh), names, everywhere,
                   Partial())
    g_l = [_with(pl, names, data, Partial()) for pl in l_pls]
    g_h = [_with(pl, names, everywhere, Partial()) for pl in h_pls]
    g_x = _with(x_pl, names, (axis_name,), Partial())
    out = local_map(body, out_placements=(scalar, scalar, *g_l, *g_h, g_x),
                    in_placements=in_pls, device_mesh=cmesh,
                    redistribute_inputs=True)(*args)
    nll, cnt = out[0].full_tensor(), out[1].full_tensor()
    loss = nll / cnt.clamp(min=1.0)
    layer_grads = dict(zip(lkeys, out[2:2 + len(lkeys)]))
    head_grads = dict(zip(hkeys, out[2 + len(lkeys):-1]))
    return loss, layer_grads, head_grads, out[-1]


def _one_f_one_b(stage_fn, head_loss_fn, w, head, x, targets, mask, segs,
                 group, m, total):
    """``pipeline_1f1b``'s ticks on this rank's local blocks: (nll sum,
    token count, layer grads, head grads, x grads), each this rank's
    share."""
    p, r = group_size(group), group_rank(group)
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by {m} "
                         f"microbatches")
    xs, ts, ms = (_microbatch(a, m) for a in (x, targets, mask))
    sg = _microbatch(segs, m)
    seg = lambda j: None if sg is None else sg[j]
    n_slots = 2 * p - 1
    stash = [None] * n_slots
    last = r == p - 1
    w_ = {k: t.detach().requires_grad_(True) for k, t in w.items()}
    head_ = {k: t.detach().requires_grad_(True) for k, t in head.items()}
    gw = {k: torch.zeros_like(t) for k, t in w.items()}
    gh = {k: torch.zeros_like(t) for k, t in head.items()}
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    gx = torch.zeros_like(xs)
    f_recv = b_recv = None
    for t in range(m + 2 * p - 1):
        # the backward's stash read first: B(mb, r=0) at tick mb + 2p - 1
        # and F(mb + 2p - 1, r=0) share a tick and a slot
        mb = t - 2 * p + 1 + r
        a_b = stash[mb % n_slots] if 0 <= mb < m else None
        mf = t - r
        y_f = None
        if 0 <= mf < m:
            a_f = xs[mf] if r == 0 else f_recv
            stash[mf % n_slots] = a_f
            if not last:            # the last stage's output goes nowhere
                with torch.no_grad():
                    y_f = stage_fn(w, a_f, seg(mf))
        g_a = None
        if a_b is not None:
            a = a_b.detach().requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(w_, a, seg(mb))
                if last:
                    cnt_b = ms[mb].sum()
                    mean_nll = head_loss_fn(head_, y, ts[mb], ms[mb])
                    grads = _grad(mean_nll, [*w_.values(), *head_.values(),
                                             a], cnt_b / total)
                    nll += mean_nll.detach() * cnt_b
                    cnt += cnt_b
                    for k, d in zip(head_, grads[len(w_):-1]):
                        gh[k].add_(d)
                else:
                    grads = _grad(y, [*w_.values(), a], b_recv.to(y.dtype))
            for k, d in zip(w_, grads):
                gw[k].add_(d)
            g_a = grads[-1]
            if r == 0:
                gx[mb] = g_a
        sends, recvs = [], []
        if y_f is not None:
            sends.append((y_f, r + 1))
        if g_a is not None and r > 0:
            sends.append((g_a, r - 1))
        if r > 0 and 0 <= t + 1 - r < m:
            f_recv = torch.empty_like(xs[0])
            recvs.append((f_recv, r - 1))
        if not last and 0 <= t + 2 - 2 * p + r < m:
            b_recv = torch.empty_like(xs[0])
            recvs.append((b_recv, r + 1))
        _hop(group, sends, recvs)
    return (nll, cnt, *gw.values(), *gh.values(), gx.reshape(x.shape))


def schedule_stats(schedule: str, p: int, m: int) -> dict:
    """JAX's analytic cost model of its two schedules (unit = one
    stage-forward; a backward is 2 units). At a fixed activation-stash
    budget, 1F1B's O(P) stash admits a much larger M and so a smaller idle
    fraction; at equal M the durations are comparable."""
    if schedule == "gpipe":
        useful = 3 * m
        total = 3 * (m + p - 1)
        return {"ticks": m + p - 1, "stage_computes": total,
                "idle_stage_computes": total - useful,
                "idle_fraction": (total - useful) / total,
                "peak_stash_microbatches": m}
    if schedule == "1f1b":
        ticks = m + 2 * p - 1
        useful = 3 * m
        total = 3 * ticks
        return {"ticks": ticks, "stage_computes": total,
                "idle_stage_computes": total - useful,
                "idle_fraction": (total - useful) / total,
                "peak_stash_microbatches": 2 * p - 1}
    raise ValueError(f"unknown schedule {schedule!r}")


def max_microbatches_for_stash(schedule: str, p: int,
                               stash_budget: int) -> int:
    """Largest M whose activation stash fits ``stash_budget``
    microbatches."""
    if schedule == "gpipe":
        return stash_budget
    if schedule == "1f1b":
        return 10 ** 9 if stash_budget >= 2 * p - 1 else 0
    raise ValueError(f"unknown schedule {schedule!r}")
