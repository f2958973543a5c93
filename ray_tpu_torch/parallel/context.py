"""Sequence (context) parallelism: ring attention and Ulysses all-to-all
(port of ``ray_tpu/parallel/context.py``).

- **Ring attention**: each rank of the ``sp`` group holds one contiguous
  chunk of the sequence; k and v chunks rotate around the group (one
  ``batch_isend_irecv`` hop a step), each step runs the flash forward on
  one chunk at its ``q_offset`` and merges its (o, lse) into fp32
  accumulators by streaming log-sum-exp. The backward runs one
  ``flash_vjp_chunk`` a step from the global (o, lse), and dk and dv ride
  the ring with k and v until they are home. Memory per rank is O(s/P);
  the result is exact.
- **Ulysses**: an all-to-all re-shards [b, s/P, h, d] to [b, s, h/P, d],
  each rank attends over the whole sequence for its heads, and a second
  all-to-all undoes it.

JAX runs both inside ``shard_map``; here they take a rank's local blocks
and the ``sp`` process group (``None`` where the mesh has no ``sp`` axis
of size > 1, as JAX's ``axis_size`` is 1 there: a ring of one exchanges
nothing, an all-to-all of one is the identity).
``sequence_parallel_attention`` is the DTensor entry (``local_map``, the
counterpart of ``shard_map``); the mesh comes from the ambient
``mesh_scope``, which the train step sets.

The ring loops take the ranks they run and the rotation as arguments:
``ring_rotation(group)`` moves one chunk to the next rank of the group,
``memory_rotation`` moves every rank's chunk when all the ranks of a ring
are held in one process (``chip_smoke.py`` holds the chunked arithmetic
against the whole-sequence kernels that way, on one device).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, Optional, Sequence

import torch

from ray_tpu_torch.ops.attention import NEG_INF, mha
from ray_tpu_torch.ops.flash import (flash_attention,
                                     flash_attention_with_lse,
                                     flash_vjp_chunk, merge_partials)
from ray_tpu_torch.parallel import sharding

_CURRENT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_mesh", default=None)

SP_IMPLS = ("ring", "ulysses")


@contextlib.contextmanager
def mesh_scope(mesh):
    """Make ``mesh`` the ambient mesh for the model's sequence-parallel
    attention and pipeline regions."""
    token = _CURRENT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT_MESH.reset(token)


def current_mesh():
    return _CURRENT_MESH.get()


def axis_group(mesh, axis_name: str):
    """The process group of ``mesh``'s axis ``axis_name`` that holds this
    rank, or ``None`` where the axis has size 1 (the compute mesh keeps
    no dim for it)."""
    cmesh = sharding.compute_mesh(mesh)
    names = cmesh.mesh_dim_names
    if axis_name not in names or cmesh.shape[names.index(axis_name)] == 1:
        return None
    return cmesh.get_group(axis_name)


def group_size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    import torch.distributed as dist

    return 0 if group is None else dist.get_rank(group)


def _merge(o1, lse1, o2, lse2):
    """Two partial-softmax results merged (``context._merge``): the port's
    ``merge_partials`` of two; lse [b,h,s], o [b,s,h,d] in o1's dtype."""
    return merge_partials([o1, o2], [lse1, lse2])


def ring_rotation(group) -> Callable:
    """``rotate(*lists)``: each list holds this rank's one tensor; each is
    sent to the next rank of ``group`` and replaced by what the previous
    rank sent, all in one ``batch_isend_irecv``. A group of one (or
    ``None``) exchanges nothing."""
    import torch.distributed as dist

    p = group_size(group)
    if p == 1:
        return lambda *lists: lists
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % p)
    prv = dist.get_global_rank(group, (me - 1) % p)

    def rotate(*lists):
        ops, outs = [], []
        for (x,) in lists:
            x = x.contiguous()
            buf = torch.empty_like(x)
            ops += [dist.P2POp(dist.isend, x, nxt, group),
                    dist.P2POp(dist.irecv, buf, prv, group)]
            outs.append([buf])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(outs)

    return rotate


def memory_rotation(*lists):
    """The ring's hop for every rank held in one process: rank i gets
    what rank i - 1 held."""
    return tuple([xs[-1], *xs[:-1]] for xs in lists)


def ring_forward(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor], ranks: Sequence[int], p: int,
                 rotate: Callable, causal: bool = True,
                 scale: Optional[float] = None) -> List[tuple]:
    """JAX's ``_ring_fwd_loop`` for the ranks ``ranks`` of a ring of ``p``
    (this process's one rank, or all of them held in memory), each with
    its chunk q, k, v [b, s_loc, h, d]: p steps; at step t rank ``my``
    attends to the chunk of ``src = (my - t) % p`` at ``q_offset = (my -
    src) * s_loc`` (a chunk after ``my`` is fully masked: o 0, lse
    NEG_INF, weight 0) and merges it into fp32 accumulators pairwise, in
    JAX's step order; then k and v rotate. Returns (o in q's dtype, lse
    fp32 [b, h, s_loc]) for each rank."""
    s_loc = qs[0].shape[1]
    acc = [(torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((q.shape[0], q.shape[2], s_loc), NEG_INF,
                       dtype=torch.float32, device=q.device)) for q in qs]
    kts, vts = list(ks), list(vs)
    for t in range(p):
        for i, my in enumerate(ranks):
            src = (my - t) % p
            ot, lset = flash_attention_with_lse(
                qs[i], kts[i], vts[i], causal=causal, scale=scale,
                q_offset=(my - src) * s_loc)
            acc[i] = _merge(*acc[i], ot.float(), lset)
        if t < p - 1:       # JAX's last hop brings k and v home unused
            kts, vts = rotate(kts, vts)
    return [(o.to(q.dtype), lse) for (o, lse), q in zip(acc, qs)]


def ring_backward(qs, ks, vs, os, dos, lses, ranks: Sequence[int], p: int,
                  rotate: Callable, causal: bool = True,
                  scale: Optional[float] = None) -> List[tuple]:
    """JAX's ``_ring_bwd`` for the ranks ``ranks``: p steps of
    ``flash_vjp_chunk`` from each rank's global (o, lse), dq summed in
    place and each chunk's dk and dv summed in fp32 accumulators that
    rotate with k and v. After p steps and p rotations every accumulator
    is back at the rank that owns its chunk. Returns (dq, dk, dv) in
    q's, k's and v's dtypes for each rank."""
    s_loc = qs[0].shape[1]
    f32 = lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                device=x.device)
    dq = [f32(q) for q in qs]
    dk, dv = [f32(k) for k in ks], [f32(v) for v in vs]
    kts, vts = list(ks), list(vs)
    for t in range(p):
        for i, my in enumerate(ranks):
            src = (my - t) % p
            dq_c, dk_c, dv_c = flash_vjp_chunk(
                qs[i], kts[i], vts[i], os[i], dos[i], lses[i],
                q_offset=(my - src) * s_loc, causal=causal, scale=scale)
            dq[i].add_(dq_c.float())
            dk[i].add_(dk_c.float())
            dv[i].add_(dv_c.float())
        if t < p - 1:
            kts, vts, dk, dv = rotate(kts, vts, dk, dv)
        else:
            dk, dv = rotate(dk, dv)
    return [(a.to(q.dtype), b.to(k.dtype), c.to(v.dtype))
            for a, b, c, q, k, v in zip(dq, dk, dv, qs, ks, vs)]


class _RingAttention(torch.autograd.Function):
    """``ring_forward`` forward, ``ring_backward`` backward on this rank's
    chunk: JAX's ``ring_attention`` custom VJP. Saves (q, k, v, o, lse),
    o already in q's dtype, as JAX saves it."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        p, my = group_size(group), group_rank(group)
        (o, lse), = ring_forward([q], [k], [v], [my], p,
                                 ring_rotation(group), causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        (dq, dk, dv), = ring_backward(
            [q], [k], [v], [o], [do], [lse], [group_rank(group)],
            group_size(group), ring_rotation(group), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence split over ``group``: q, k, v are
    this rank's [b, s_loc, h, d] chunk (rank r of the group holds
    positions [r * s_loc, (r + 1) * s_loc)). Differentiable."""
    return _RingAttention.apply(q, k, v, group, causal, scale)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 in equal pieces; it only permutes
    pieces between ranks, so its transpose is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _seq_to_heads(x: torch.Tensor, group, p: int) -> torch.Tensor:
    """[b, s/P, h, d] -> [b, s, h/P, d]: head chunk j goes to rank j, the
    sequence pieces come back in rank order (JAX's tiled
    ``all_to_all(split_axis=2, concat_axis=1)``)."""
    b, s, h, d = x.shape
    x = x.reshape(b, s, p, h // p, d).permute(2, 0, 1, 3, 4)
    y = _AllToAll.apply(x, group)                 # [p, b, s, h/P, d]
    return y.permute(1, 0, 2, 3, 4).reshape(b, p * s, h // p, d)


def _heads_to_seq(x: torch.Tensor, group, p: int) -> torch.Tensor:
    """[b, s, h/P, d] -> [b, s/P, h, d], the inverse of ``_seq_to_heads``."""
    b, n, hp, d = x.shape
    x = x.reshape(b, p, n // p, hp, d).permute(1, 0, 2, 3, 4)
    y = _AllToAll.apply(x, group)                 # [p, b, s/P, h/P, d]
    return y.permute(1, 2, 0, 3, 4).reshape(b, n // p, p * hp, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, causal: bool = True,
                      scale: Optional[float] = None,
                      use_flash: bool = True) -> torch.Tensor:
    """All-to-all sequence parallelism on this rank's [b, s/P, h, d]
    chunk: re-shard sequence to heads, attend (``flash_attention``, or
    ``mha`` with ``use_flash=False``), undo. Requires hq % P == 0; the kv
    heads are repeated up to hq first where P does not divide them (GQA).
    Differentiable through both all-to-alls."""
    p = group_size(group)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % p:
        raise ValueError(f"ulysses: q heads {hq} not divisible by sp={p}")
    if hkv % p:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if p > 1:
        q, k, v = (_seq_to_heads(x, group, p) for x in (q, k, v))
    if use_flash:
        og = flash_attention(q, k, v, causal=causal, scale=scale)
    else:
        og = mha(q, k, v, causal=causal, scale=scale)
    return _heads_to_seq(og, group, p) if p > 1 else og


def sequence_parallel_attention(q, k, v, *, impl: str = "ring",
                                axis_name: str = "sp", mesh=None,
                                causal: bool = True,
                                scale: Optional[float] = None):
    """Ring or Ulysses attention over ``mesh``'s ``axis_name`` (default:
    the ambient ``mesh_scope``'s mesh). DTensors [b, s, h, d] (batch over
    dp and fsdp, sequence over ``axis_name``, heads over tp) run through
    ``local_map`` on each rank's blocks; plain tensors are taken as a
    rank's blocks already (a model block inside ``sharding.rows_map``).
    Differentiable."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError(
            "sequence_parallel_attention needs a mesh (use parallel.context."
            "mesh_scope(mesh) around the step, or pass mesh=).")
    if impl not in SP_IMPLS:
        raise ValueError(f"unknown sp impl {impl!r}")
    group = axis_group(mesh, axis_name)
    fn = ring_attention if impl == "ring" else ulysses_attention

    def local(qq, kk, vv):
        return fn(qq, kk, vv, group, causal, scale)

    if not sharding.is_sharded(q):
        return local(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    cmesh = sharding.compute_mesh(mesh)
    spec = sharding.activation_placements(
        cmesh, {0: sharding.BATCH_AXES, 1: (axis_name,), 2: ("tp",)})
    return local_map(local, out_placements=(spec,),
                     in_placements=(spec,) * 3,
                     in_grad_placements=(spec,) * 3, device_mesh=cmesh,
                     redistribute_inputs=True)(q, k, v)
