"""The resource algebra: predefined + custom resources, GPU first-class
(port of ``ray_tpu/core/resources.py``, where the TPU is).

As in the reference's resource model (``src/ray/common/scheduling/``,
``scheduling_ids.h:43-46``), ``GPU`` is predefined alongside CPU/memory,
with per-instance accounting (which GPU indices a task holds →
``CUDA_VISIBLE_DEVICES``); nodes carry labels for label-aware placement.

Quantities are fixed-point (10^-4 granularity) like the reference's
``FixedPoint`` (``fixed_point.h``) so fractional resources compare exactly.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

CPU = "CPU"
GPU = "GPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"

PREDEFINED = (CPU, GPU, MEMORY, OBJECT_STORE_MEMORY)

GRANULARITY = 10000  # fixed-point denominator


def _fp(x: float) -> int:
    return round(x * GRANULARITY)


class ResourceSet:
    """An immutable bag of resource quantities (fixed-point internally)."""

    __slots__ = ("_q",)

    def __init__(self, quantities: Optional[Mapping[str, float]] = None):
        self._q: Dict[str, int] = {}
        for name, val in (quantities or {}).items():
            fv = _fp(val)
            if fv < 0:
                raise ValueError(f"negative resource {name}={val}")
            if fv:
                self._q[name] = fv

    @classmethod
    def _from_fp(cls, q: Dict[str, int]) -> "ResourceSet":
        rs = cls()
        rs._q = {k: v for k, v in q.items() if v}
        return rs

    def get(self, name: str) -> float:
        return self._q.get(name, 0) / GRANULARITY

    def names(self):
        return self._q.keys()

    def is_empty(self) -> bool:
        return not self._q

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(other._q.get(k, 0) >= v for k, v in self._q.items())

    def add(self, other: "ResourceSet") -> "ResourceSet":
        q = dict(self._q)
        for k, v in other._q.items():
            q[k] = q.get(k, 0) + v
        return ResourceSet._from_fp(q)

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        q = dict(self._q)
        for k, v in other._q.items():
            nv = q.get(k, 0) - v
            if nv < 0:
                raise ValueError(f"resource {k} would go negative")
            q[k] = nv
        return ResourceSet._from_fp(q)

    def to_dict(self) -> Dict[str, float]:
        return {k: v / GRANULARITY for k, v in self._q.items()}

    def __eq__(self, other) -> bool:
        return isinstance(other, ResourceSet) and other._q == self._q

    def __repr__(self) -> str:
        return f"ResourceSet({self.to_dict()})"


class NodeResources:
    """A node's total and available resources plus per-instance GPU state.

    Reference analog: ``NodeResources`` + ``ResourceInstanceSet``
    (``cluster_resource_data.h``) — the per-instance part is what lets a task
    holding ``num_gpus=2`` be pinned to specific GPU indices.
    """

    def __init__(self, total: Mapping[str, float], labels: Optional[Mapping[str, str]] = None):
        self.total = ResourceSet(total)
        self.available = ResourceSet(total)
        self.labels: Dict[str, str] = dict(labels or {})
        n_gpu = int(self.total.get(GPU))
        self._free_gpus: List[int] = list(range(n_gpu))

    def can_fit(self, req: ResourceSet) -> bool:
        return req.is_subset_of(self.available)

    def is_feasible(self, req: ResourceSet) -> bool:
        return req.is_subset_of(self.total)

    def allocate(self, req: ResourceSet) -> Dict[str, List[int]]:
        """Deduct ``req``; returns instance assignment (GPU indices)."""
        self.available = self.available.subtract(req)
        assignment: Dict[str, List[int]] = {}
        n_gpu = int(req.get(GPU))
        if n_gpu:
            if len(self._free_gpus) < n_gpu:
                # undo and fail — should not happen if can_fit() was checked
                self.available = self.available.add(req)
                raise ValueError("GPU instance accounting out of sync")
            assignment[GPU] = self._free_gpus[:n_gpu]
            del self._free_gpus[:n_gpu]
        return assignment

    def release(self, req: ResourceSet, assignment: Optional[Dict[str, List[int]]] = None) -> None:
        self.available = self.available.add(req)
        if assignment and GPU in assignment:
            self._free_gpus.extend(assignment[GPU])
            self._free_gpus.sort()

    def utilization(self, req: ResourceSet) -> float:
        """Critical-resource utilization if ``req`` were placed here.

        Reference analog: the scorer inside ``HybridSchedulingPolicy``
        (``hybrid_scheduling_policy.h:29-48``).
        """
        util = 0.0
        after = self.available.subtract(req) if req.is_subset_of(self.available) else ResourceSet()
        for name in set(self.total.names()) | set(req.names()):
            tot = self.total.get(name)
            if tot <= 0:
                continue
            util = max(util, 1.0 - after.get(name) / tot)
        return util

    def to_dict(self) -> Dict:
        return {
            "total": self.total.to_dict(),
            "available": self.available.to_dict(),
            "labels": dict(self.labels),
        }
