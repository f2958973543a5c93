"""Device meshes over the ranks of a process group (port of
``ray_tpu/parallel/mesh.py``).

The axis convention is JAX's, (pp, dp, fsdp, sp, ep, tp) major to minor:

- ``dp``: pure data parallel (params replicated), outermost so that in a
  multi-host job it spans hosts;
- ``fsdp``: a data axis whose lanes also shard params and optimizer state
  (ZeRO-3);
- ``tp``: tensor parallel, innermost so its all-reduces stay on the
  fastest links (NVLink within a host);
- ``sp`` (sequence), ``ep`` (experts) and ``pp`` (pipeline stages).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named ``AXIS_ORDER``; rank ``r`` of the default process group sits where
JAX puts device ``r``. One rank drives one device, so JAX's devices
become ranks and a slice (a group of devices on one interconnect) becomes
a host. ``pg_slice_assignments`` and ``mesh_for_slice_group`` read the
cluster runtime's placement groups and are not ported yet (ROADMAP
item R4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")
DCN_AXES_DEFAULT = ("dp",)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.ep * self.pp

    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    @classmethod
    def for_devices(cls, n: int, *, tp: int = 1, sp: int = 1, ep: int = 1,
                    pp: int = 1, dp: int = 1) -> "MeshConfig":
        """Fill the fsdp axis with whatever ``n`` leaves over."""
        denom = tp * sp * ep * pp * dp
        if n % denom:
            raise ValueError(
                f"{n} devices not divisible by tp*sp*ep*pp*dp={denom}")
        return cls(dp=dp, fsdp=n // denom, tp=tp, sp=sp, ep=ep, pp=pp)


def _check_device_type(device_type: str) -> None:
    """``cuda`` needs a CUDA device: nothing falls back to the CPU unless
    the caller passes ``device_type="cpu"``."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on cuda by default and no CUDA device is "
            "available; pass device_type='cpu' (and a gloo process group) "
            "to run on the CPU")


def _world_size() -> int:
    """The default process group's size; raises when there is none."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the default process group: call "
            "collective.bootstrap_torch_distributed (or "
            "torch.distributed.init_process_group) first")
    return dist.get_world_size()


def _device_mesh(layout: np.ndarray, device_type: str):
    """A DeviceMesh over the rank array ``layout`` (dims in AXIS_ORDER)."""
    from torch.distributed.device_mesh import DeviceMesh

    _check_device_type(device_type)
    _world_size()
    return DeviceMesh(device_type, torch.as_tensor(layout, dtype=torch.int),
                      mesh_dim_names=AXIS_ORDER)


def make_mesh(config: MeshConfig, ranks: Optional[Sequence[int]] = None, *,
              device_type: str = "cuda"):
    """The mesh of ``config`` over ``ranks`` (default: every rank of the
    default group, in order): rank ``ranks[i]`` at the row-major position
    ``i``, as JAX's ``make_mesh`` places ``devices[i]``. Every rank of the
    default group must call it."""
    _check_device_type(device_type)
    ranks = list(ranks) if ranks is not None else list(range(_world_size()))
    n = config.num_devices
    if len(ranks) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(ranks)}")
    layout = np.array(ranks[:n]).reshape(config.axis_sizes())
    return _device_mesh(layout, device_type)


def hybrid_layout(config: MeshConfig, slice_ranks: Sequence[Sequence[int]],
                  dcn_axes: Sequence[str] = DCN_AXES_DEFAULT) -> np.ndarray:
    """The rank array [pp, dp, fsdp, sp, ep, tp] of ``make_hybrid_mesh``:
    the ``dcn_axes`` span the slices (hosts), every other axis stays
    within one. Raises as JAX's does."""
    for a in dcn_axes:
        if a not in AXIS_ORDER:
            raise ValueError(f"unknown dcn axis {a!r}")
    n_slices = len(slice_ranks)
    dcn_order = [a for a in AXIS_ORDER if a in dcn_axes]
    ici_order = [a for a in AXIS_ORDER if a not in dcn_axes]
    dcn_sizes = [getattr(config, a) for a in dcn_order]
    ici_sizes = [getattr(config, a) for a in ici_order]
    if math.prod(dcn_sizes) != n_slices:
        raise ValueError(
            f"dcn axes {dcn_order} sizes {dcn_sizes} must multiply to the "
            f"slice count {n_slices}")
    per_slice = math.prod(ici_sizes)
    sizes = {len(s) for s in slice_ranks}
    if len(sizes) != 1:
        raise ValueError(f"slices must be equal-sized, got {sorted(sizes)}")
    if sizes.pop() != per_slice:
        raise ValueError(
            f"each slice needs exactly {per_slice} devices for axes "
            f"{ici_order} (got {len(slice_ranks[0])}); silently idling "
            f"devices is never what you want: shrink/grow the inner axes")
    arr = np.array([list(s) for s in slice_ranks]).reshape(
        dcn_sizes + ici_sizes)
    # dims are [dcn axes..., ici axes...]; put them in AXIS_ORDER so the
    # partition specs do not depend on the layout
    current = dcn_order + ici_order
    return arr.transpose([current.index(a) for a in AXIS_ORDER])


def make_hybrid_mesh(config: MeshConfig,
                     slice_ranks: Sequence[Sequence[int]],
                     dcn_axes: Sequence[str] = DCN_AXES_DEFAULT, *,
                     device_type: str = "cuda"):
    """A mesh for a multi-host job: ``slice_ranks`` groups the ranks by
    host (equal sizes); the ``dcn_axes`` (default ``dp``) span hosts and
    every other axis stays within a host, so fsdp all-gathers and tp
    all-reduces ride NVLink. The product of the dcn axis sizes must equal
    the host count, the other axes must use exactly one host's ranks."""
    return _device_mesh(hybrid_layout(config, slice_ranks, dcn_axes),
                        device_type)


def slices_from_process_slices(process_slices: Sequence[str],
                               ranks: Optional[Sequence[int]] = None
                               ) -> list:
    """Ranks grouped by slice (host) name: ``process_slices[i]`` names the
    slice of rank ``ranks[i]`` (default: rank ``i``). Slices follow the
    order of first appearance, so every rank derives the same grouping
    without coordination."""
    ranks = list(ranks) if ranks is not None else list(
        range(len(process_slices)))
    groups: dict = {}
    for rank, name in zip(ranks, process_slices):
        groups.setdefault(name, []).append(rank)
    return list(groups.values())


def hybrid_mesh_from_process_slices(config: MeshConfig,
                                    process_slices: Sequence[str],
                                    ranks: Optional[Sequence[int]] = None,
                                    dcn_axes: Sequence[str]
                                    = DCN_AXES_DEFAULT, *,
                                    device_type: str = "cuda"):
    """``make_hybrid_mesh`` from a rank -> slice-name assignment
    (``slices_from_process_slices``)."""
    return make_hybrid_mesh(
        config, slices_from_process_slices(process_slices, ranks), dcn_axes,
        device_type=device_type)


def balanced_factors(n: int, k: int = 3) -> Tuple[int, ...]:
    """Split n into k roughly-balanced integer factors (largest first)."""
    factors = [1] * k
    remaining = n
    for i in range(k - 1):
        f = int(round(remaining ** (1 / (k - i))))
        while f > 1 and remaining % f:
            f -= 1
        factors[i] = max(f, 1)
        remaining //= factors[i]
    factors[k - 1] = remaining
    assert math.prod(factors) == n
    return tuple(sorted(factors, reverse=True))
