"""Partition rules: tree paths to partition specs to DTensor placements
(port of ``ray_tpu/parallel/sharding.py``).

A model family ships ``(path_regex, spec)`` rules; applied to a params
tree they give each leaf its placement on the mesh, as JAX's give each a
``NamedSharding``. A spec names, for each tensor dim, the mesh axis (or
axes, major first) that shards it; a mesh axis named by no dim
replicates. ``("dp", "fsdp")`` on one dim is dp-major: DTensor shards a
dim over several mesh dims in mesh order, the order of ``AXIS_ORDER``.

DTensors live on the mesh's **compute mesh**: its axes of size > 1
(``fsdp`` alone when every axis has size 1). DTensor's sharding
propagation expands each op's strategies over every mesh dim, so the
unused axes of a six-dim mesh would multiply the cost of each op's first
dispatch; a size-1 axis shards nothing, so leaving it out changes no
block.

Every rank holds the global host value of what it places
(``shard_pytree``, ``distribute``) and keeps its own block: no collective
and no full copy on the device, as JAX's ``device_put`` of a global array.
"""

from __future__ import annotations

import re
import sys
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.parallel.mesh import AXIS_ORDER

BATCH_AXES = ("dp", "fsdp")


class P(tuple):
    """A partition spec, ``jax.sharding.PartitionSpec``'s counterpart: one
    entry per leading tensor dim, each ``None`` (not sharded), a mesh axis
    name, or a tuple of axis names (sharded over all of them, major
    first). Trailing dims it does not name are not sharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _walk(tree: Any, fn, path: Tuple[str, ...] = ()):
    """``tree`` (dicts, lists, tuples) with every leaf replaced by
    ``fn(path_string, leaf)``."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


class ShardingRules:
    """Ordered (regex, spec) rules; the first that matches a leaf's path
    (its dict keys and list indices joined by ``/``) wins."""

    def __init__(self, rules: Sequence[Tuple[str, P]], default: P = P()):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]
        self._default = default

    def spec_for(self, path_string: str) -> P:
        for pat, spec in self._rules:
            if pat.search(path_string):
                return spec
        return self._default

    def tree_specs(self, tree: Any):
        """A tree of specs shaped like ``tree``."""
        return _walk(tree, lambda path, _: self.spec_for(path))

    def tree_placements(self, tree: Any, mesh):
        """A tree of DTensor placements (on ``compute_mesh(mesh)``) shaped
        like ``tree``: ``tree_shardings``' counterpart."""
        cmesh = compute_mesh(mesh)
        return _walk(tree, lambda path, leaf: placements(
            self.spec_for(path), cmesh, getattr(leaf, "ndim", None)))


def compute_mesh(mesh):
    """The sub-mesh DTensors are placed on: ``mesh``'s axes of size > 1,
    or its ``fsdp`` axis (else its first) when none is. A mesh that is
    already one is returned as it is. Kept on the mesh object (meshes of
    equal layout compare equal across process groups, so no cache keyed
    by value would do)."""
    sub = getattr(mesh, "_rt_compute_mesh", None)
    if sub is not None:
        return sub
    names = mesh.mesh_dim_names
    if names is None or any(n not in AXIS_ORDER for n in names):
        raise ValueError(f"mesh dims must be named from {AXIS_ORDER}, got "
                         f"{names}")
    active = tuple(n for n, size in zip(names, mesh.shape) if size > 1)
    if not active:
        active = ("fsdp",) if "fsdp" in names else names[:1]
    sub = mesh if active == names else mesh[active]
    mesh._rt_compute_mesh = sub
    return sub


def placements(spec: P, mesh, ndim: Optional[int] = None) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a compute mesh):
    ``Shard(d)`` on each mesh dim that spec entry ``d`` names,
    ``Replicate()`` on the others. Axes the mesh lacks (size 1) shard
    nothing and are skipped. Raises, as JAX does, for a spec longer than
    the tensor or naming an axis twice, and for axes sharing a dim out of
    mesh order (DTensor's placements cannot say that)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        for a in axes:
            if a not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {a!r} in {spec}")
            if a in dim_of:
                raise ValueError(f"axis {a!r} appears twice in {spec}")
            dim_of[a] = d
        present = [a for a in axes if a in names]
        if present != sorted(present, key=names.index):
            raise ValueError(f"spec {spec} shards dim {d} over {axes} out "
                             f"of mesh order {names}")
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in names)


def named_sharding(mesh, *axes) -> tuple:
    """The placements of ``P(*axes)`` on ``mesh``'s compute mesh."""
    return placements(P(*axes), compute_mesh(mesh))


def data_spec(extra_seq_axis: Optional[str] = None) -> P:
    """[batch, seq, ...] inputs: batch over the data axes, seq over sp if
    used."""
    return P(BATCH_AXES, extra_seq_axis)


def chunk_span(n: int, k: int, i: int) -> Tuple[int, int]:
    """(start, length) of piece ``i`` of ``n`` split ``k`` ways as
    ``torch.chunk`` (and DTensor's ``Shard``) split it: pieces of
    ceil(n / k), the last ones shorter or empty."""
    size = -(-n // k)
    start = min(i * size, n)
    return start, min(start + size, n) - start


def block_box(shape: Sequence[int], mesh_shape: Sequence[int],
              places: tuple, coord: Sequence[int]
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(offsets, sizes) of the block of a global ``shape`` that the mesh
    coordinate ``coord`` holds under ``places``: each sharded mesh dim, in
    mesh order, takes its coordinate's piece of what the earlier ones
    left, so several mesh dims on one tensor dim split it major first, as
    DTensor does."""
    off, size = [0] * len(shape), list(shape)
    for i, p in enumerate(places):
        if p.is_shard():
            start, n = chunk_span(size[p.dim], mesh_shape[i], coord[i])
            off[p.dim] += start
            size[p.dim] = n
    return tuple(off), tuple(size)


def local_block(x: torch.Tensor, mesh, places: tuple) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``places`` on ``mesh``
    (a view)."""
    off, size = block_box(x.shape, mesh.shape, places, mesh.get_coordinate())
    for d, (o, n) in enumerate(zip(off, size)):
        if (o, n) != (0, x.shape[d]):
            x = x.narrow(d, o, n)
    return x


def distribute(x, mesh, places: tuple, device=None):
    """A DTensor of the global ``x`` (a tensor or numpy array, the same on
    every rank) placed by ``places`` on ``mesh``: each rank copies only its
    block to ``device`` (default: ``x``'s for a tensor, the mesh's device
    otherwise). No collective runs."""
    from torch.distributed.tensor import DTensor

    x = torch.as_tensor(x)
    if device is None:
        device = x.device if x.device.type == mesh.device_type else \
            _mesh_device(mesh)
    block = local_block(x, mesh, places)
    # a copy even where the block is already on the device, so the local
    # tensor does not keep the global one's storage alive
    local = block.to(device, copy=True,
                     memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=x.shape, stride=_contiguous_strides(
                                  x.shape))


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, acc = [], 1
    for n in reversed(tuple(shape)):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_pytree(tree: Any, mesh, rules: ShardingRules):
    """Place every tensor leaf of ``tree`` (global values, the same on
    every rank) by ``rules`` on ``mesh``'s compute mesh (used at init and
    restore); other leaves stay as they are."""
    cmesh = compute_mesh(mesh)

    def place(path, leaf):
        if not isinstance(leaf, (torch.Tensor, np.ndarray)):
            return leaf
        return distribute(leaf, cmesh,
                          placements(rules.spec_for(path), cmesh, leaf.ndim))

    return _walk(tree, place)


# ---- helpers the model families call on DTensor params ----------------------

def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor (the model runs on a mesh). Nothing can
    be one before ``torch.distributed.tensor`` is imported, so the plain
    path never pays for that import (about 2 s)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def gather_fsdp(w):
    """``w`` all-gathered over the mesh's fsdp axis, its other placements
    kept; a plain tensor or one not sharded over fsdp comes back as it
    is. The models call it on each weight where it is used, after the
    cast to the compute dtype: ZeRO-3, as JAX's rules mean it. The
    gather's backward reduce-scatters the weight's gradient over fsdp
    (and all-reduces it over dp, where the batch is split)."""
    if not is_sharded(w):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    if "fsdp" not in names:
        return w
    i = names.index("fsdp")
    if not w.placements[i].is_shard():
        return w
    places = list(w.placements)
    places[i] = Replicate()
    return w.redistribute(w.device_mesh, places)


def activation_placements(mesh, dims: Dict[int, Tuple[str, ...]]) -> tuple:
    """Placements of an activation on ``mesh``: ``dims`` maps a tensor
    dim to the mesh axes that shard it (e.g. ``{0: BATCH_AXES, 2:
    ("tp",)}`` for [b, s, heads, d]); every other mesh dim replicates."""
    from torch.distributed.tensor import Replicate, Shard

    axis_dim = {a: d for d, axes in dims.items() for a in axes}
    return tuple(Shard(axis_dim[n]) if n in axis_dim else Replicate()
                 for n in mesh.mesh_dim_names)


def _seq_split(x) -> bool:
    """Whether the residual stream ``x`` has its sequence (dim 1) split
    over ``sp`` (ring or Ulysses attention: ``split_sequence``)."""
    from torch.distributed.tensor import Shard

    names = x.device_mesh.mesh_dim_names
    return "sp" in names and x.placements[names.index("sp")] == Shard(1)


def stream_placements(x) -> tuple:
    """The residual stream's placements for ``x``: rows over the data
    axes, the sequence over sp where ``x`` has it split so, every other
    mesh dim replicated."""
    seq = ("sp",) if _seq_split(x) else ()
    return activation_placements(x.device_mesh, {0: BATCH_AXES, 1: seq})


def split_sequence(x):
    """The residual stream ``x`` [b, s, d] with its sequence split over
    ``sp`` (a slice of each rank's rows, no collective), for ring or
    Ulysses attention: the blocks then run on each rank's chunk. A plain
    tensor, or a mesh without an sp axis of size > 1, comes back as it
    is. Raises PlanError where sp does not divide s (the ring's chunks
    are equal, as JAX's shard_map needs)."""
    from torch.distributed.tensor import Shard

    if not is_sharded(x) or "sp" not in x.device_mesh.mesh_dim_names:
        return x
    names = x.device_mesh.mesh_dim_names
    sp = x.device_mesh.shape[names.index("sp")]
    if x.shape[1] % sp:
        from ray_tpu_torch.parallel.plan import PlanError

        raise PlanError(f"sequence {x.shape[1]} does not divide by sp={sp}",
                        "ring and Ulysses attention split the sequence "
                        "into equal chunks")
    places = list(x.placements)
    places[names.index("sp")] = Shard(1)
    return x.redistribute(x.device_mesh, places)


def gather_sequence(x):
    """``split_sequence`` undone: the stream all-gathered over sp (its
    backward takes each rank's chunk of the gradient)."""
    if not is_sharded(x) or not _seq_split(x):
        return x
    from torch.distributed.tensor import Replicate

    places = list(x.placements)
    places[x.device_mesh.mesh_dim_names.index("sp")] = Replicate()
    return x.redistribute(x.device_mesh, places)


def sequence_block(x, *tables: torch.Tensor) -> tuple:
    """``tables`` ([s, ...], e.g. the RoPE sin and cos) cut to the
    positions of the sequence block of ``x`` ([b, s, ...]) this rank
    holds: all of them unless ``x`` splits its sequence."""
    if not is_sharded(x):
        return tables
    mesh = x.device_mesh
    off, size = block_box(x.shape, mesh.shape, x.placements,
                          mesh.get_coordinate())
    if (off[1], size[1]) == (0, x.shape[1]):
        return tables
    return tuple(t.narrow(0, off[1], size[1]) for t in tables)


def rows_map(fn, x, weights: tuple, ids: tuple = ()):
    """``fn(x, *weights, *ids)`` on each rank's blocks, through
    ``torch.distributed.tensor.experimental.local_map``, for a block that
    reads the residual stream ``x`` and returns what it adds to it (a
    pre-norm attention or MLP, tensor-parallel as Megatron's):

    - ``x``: rows over the data axes, its sequence over sp where it is
      split so (``split_sequence``), replicated over tp and the rest
      (redistributed so where it is not);
    - each weight: as given (gathered over fsdp by the caller), its
      heads or ff columns over tp;
    - ``ids``: DTensors of rows (segment ids), no gradient;
    - the output: rows, **partial over tp**: each tp rank's share, over
      its heads or ff columns; the residual add sums the shares (an
      all-reduce over tp).

    The local gradients it declares: ``x``'s is partial over tp (each
    rank's share through its columns); a weight's is partial over the
    data axes (its rows' share: the fsdp gather's backward reduce-scatters
    it, dp all-reduces it), over sp where the sequence is split (its
    chunk's share), and, for a weight replicated over tp (a norm scale,
    upstream of the split columns), over tp too."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rows = stream_placements(x)
    shares = tuple(Partial() if n == "tp" else p for n, p in zip(names, rows))
    partial_axes = BATCH_AXES + (("sp",) if _seq_split(x) else ())

    def grad_of(w):
        return tuple(Partial() if n in partial_axes or (
            n == "tp" and not p.is_shard()) else p
            for n, p in zip(names, w.placements))

    return local_map(
        fn, out_placements=(shares,),
        in_placements=(rows, *(w.placements for w in weights),
                       *(rows for _ in ids)),
        in_grad_placements=(shares, *(grad_of(w) for w in weights),
                            *(rows for _ in ids)),
        device_mesh=mesh, redistribute_inputs=True)(x, *weights, *ids)


def residual_add(x, delta):
    """``x + delta``, on a mesh in the residual stream's placement
    (``stream_placements``): ``delta`` (a block's shares, partial over
    tp) and ``x`` are redistributed to it (the tp all-reduce) and added
    on the local blocks, which skips DTensor's strategy search for the
    add."""
    if not is_sharded(x):
        return x + delta
    from torch.distributed.tensor.experimental import local_map

    rows = stream_placements(x)
    return local_map(torch.add, out_placements=(rows,),
                     in_placements=(rows, rows), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, delta)


def embedding(tokens, table, dtype: torch.dtype):
    """``table[tokens].to(dtype)`` on a mesh, ``table`` (gathered over
    fsdp) with its rows split over tp by vocab: each tp rank looks up the
    tokens in its rows and zeros the rest, so the output (rows over the
    data axes) is partial over tp and the first use sums it. Rows are cast
    after the lookup, so the gradient accumulates over repeated tokens in
    the table's dtype. The table's local gradient is its rows' share of
    the batch: partial over the data axes, exact per vocab block."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    tp = table.placements[names.index("tp")] if "tp" in names else \
        Replicate()
    if not (tp.is_replicate() or tp == Shard(0)):
        raise ValueError(f"the embedding table must split its rows over tp,"
                         f" not {table.placements}")
    lo = block_box(table.shape, mesh.shape, table.placements,
                   mesh.get_coordinate())[0][0]
    rows = activation_placements(mesh, {0: BATCH_AXES})
    split = tp.is_shard()
    out = tuple(Partial() if n == "tp" and split else p
                for n, p in zip(names, rows))
    grad = tuple(Partial() if n in BATCH_AXES else p
                 for n, p in zip(names, table.placements))

    def lookup(table, tokens):
        idx = tokens.long() - lo
        inside = (idx >= 0) & (idx < table.shape[0])
        found = table[torch.where(inside, idx, 0)].to(dtype)
        return torch.where(inside[..., None], found, 0)

    return local_map(lookup, out_placements=(out,),
                     in_placements=(table.placements, rows),
                     in_grad_placements=(grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)
