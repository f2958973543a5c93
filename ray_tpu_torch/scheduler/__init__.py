"""Cluster scheduling: node selection policies + the cluster resource view.

Shared by the GCS (actor/PG scheduling, task spillback routing) and each
raylet (local queueing + spillback decisions) — the two halves of the
reference's two-level design (``ClusterTaskManager``/``LocalTaskManager``).
"""

from ray_tpu_torch.scheduler.policy import (  # noqa: F401
    HybridPolicy,
    NodeAffinityPolicy,
    NodeLabelPolicy,
    SpreadPolicy,
    pick_node,
)
