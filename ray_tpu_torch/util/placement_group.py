"""Placement groups: atomic gang reservation of resources across nodes.

Reference analog: ``python/ray/util/placement_group.py`` +
``GcsPlacementGroupManager``/``GcsPlacementGroupScheduler`` (2-phase commit
of bundles across raylets, ``gcs_placement_group_scheduler.h:137-222``).

Gang extension: ``slice_group()`` builds the PG shape of a multi-host GPU
gang — one bundle per host, STRICT_SPREAD, each bundle holding the host's
GPUs — the primitive under multi-host meshes (JAX's is a TPU pod slice).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch.core.resources import CPU, GPU
from ray_tpu_torch.core.task_spec import PlacementGroupStrategy

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until all bundles are committed (2PC done); True on success.

        (The reference returns an ObjectRef from ``pg.ready()``; here readiness
        is a control-plane long-poll — same blocking semantics via ``wait``.)
        """
        from ray_tpu_torch.core.worker import global_worker

        backend = global_worker()._require_backend()
        if not hasattr(backend, "_gcs"):
            return True  # local mode: reservation is trivially satisfied
        reply = backend.io.run(backend._gcs.call("wait_placement_group", {
            "pg_id": self.id.hex(), "timeout": timeout if timeout is not None else 3600.0}))
        return reply.get("state") == "CREATED"

    def ready(self) -> "PlacementGroup":
        if not self.wait():
            raise TimeoutError(f"placement group {self.id} not ready")
        return self

    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self.bundles)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for b in bundles:
        if not b or all(v == 0 for v in b.values()):
            raise ValueError(f"empty bundle {b!r}")
        if any(v < 0 for v in b.values()):
            raise ValueError(f"negative resource in bundle {b!r}")
    from ray_tpu_torch.core.worker import global_worker

    backend = global_worker()._require_backend()
    pg_id = PlacementGroupID.from_random()
    if not hasattr(backend, "_gcs"):
        return PlacementGroup(pg_id, bundles, strategy)  # local mode no-op
    reply = backend.io.run(backend._gcs.call("create_placement_group", {
        "pg_id": pg_id.hex(), "bundles": bundles, "strategy": strategy,
        "name": name, "lifetime": lifetime}))
    if reply.get("error"):
        raise ValueError(reply["error"])
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch.core.worker import global_worker

    backend = global_worker()._require_backend()
    if not hasattr(backend, "_gcs"):
        return
    backend.io.run(backend._gcs.call("remove_placement_group",
                                     {"pg_id": pg.id.hex()}))


def placement_group_table() -> List[Dict]:
    from ray_tpu_torch.core.worker import global_worker

    backend = global_worker()._require_backend()
    if not hasattr(backend, "_gcs"):
        return []
    return backend.io.run(backend._gcs.call("list_placement_groups", {}))


def slice_group(num_hosts: int, gpus_per_host: int = 8,
                cpus_per_host: float = 1, strategy: str = "STRICT_SPREAD",
                name: str = "") -> PlacementGroup:
    """A PG shaped like a multi-host GPU gang: one bundle per host,
    all-or-nothing.

    STRICT_SPREAD pins each bundle to a distinct host so the gang maps 1:1
    onto the hosts; GPUs within a bundle are a contiguous block on that
    host (per-instance accounting in the raylet).
    """
    bundle = {GPU: float(gpus_per_host), CPU: float(cpus_per_host)}
    return placement_group([dict(bundle) for _ in range(num_hosts)],
                           strategy=strategy, name=name)


class PlacementGroupSchedulingStrategy:
    """Option value for ``.options(scheduling_strategy=...)``."""

    def __init__(self, placement_group: PlacementGroup,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        idx = placement_group_bundle_index
        if idx < -1 or idx >= placement_group.bundle_count:
            raise ValueError(
                f"bundle index {idx} out of range for a "
                f"{placement_group.bundle_count}-bundle placement group")
        self.placement_group = placement_group
        self.bundle_index = idx
        self.capture_child_tasks = placement_group_capture_child_tasks

    def to_spec(self) -> PlacementGroupStrategy:
        return PlacementGroupStrategy(
            placement_group_id_hex=self.placement_group.id.hex(),
            bundle_index=self.bundle_index,
            capture_child_tasks=self.capture_child_tasks)
