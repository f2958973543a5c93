"""Task and actor specifications + options validation.

Equivalent of the reference's ``TaskSpecification``
(``src/ray/common/task/task_spec.h``) and the Python options layer
(``python/ray/_private/ray_option_utils.py``): a language-neutral record of
what to run, with what resources, under which scheduling strategy. Functions
are exported once to the GCS function table and referenced by id
(``_private/function_manager.py``), so specs stay small on the hot path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, TaskID
from ray_tpu_torch.core.resources import CPU, GPU, ResourceSet


@dataclasses.dataclass
class SchedulingStrategy:
    """Base: DEFAULT hybrid policy."""

    kind: str = "DEFAULT"


@dataclasses.dataclass
class SpreadStrategy(SchedulingStrategy):
    kind: str = "SPREAD"


@dataclasses.dataclass
class NodeAffinityStrategy(SchedulingStrategy):
    kind: str = "NODE_AFFINITY"
    node_id_hex: str = ""
    soft: bool = False


@dataclasses.dataclass
class NodeLabelStrategy(SchedulingStrategy):
    """Schedule onto nodes matching label constraints (reference:
    ``NodeLabelSchedulingPolicy`` + ``NodeLabelSchedulingStrategy``).

    ``hard`` must match; ``soft`` prefers matching nodes but falls back.
    Each value is one match expression:

    - ``"v"``        — label equals v (In)
    - ``["a", "b"]`` — label in {a, b} (In)
    - ``"!v"``       — label not equal v (NotIn)
    - ``"*"``        — label exists (Exists)
    - ``"!*"``       — label absent (DoesNotExist)

    e.g. ``NodeLabelStrategy(hard={"rack": "r0"},
    soft={"accelerator-type": ["GPU-H100", "GPU-A100"]})``.
    """

    kind: str = "NODE_LABEL"
    hard: Dict[str, Any] = dataclasses.field(default_factory=dict)
    soft: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PlacementGroupStrategy(SchedulingStrategy):
    kind: str = "PLACEMENT_GROUP"
    placement_group_id_hex: str = ""
    bundle_index: int = -1
    capture_child_tasks: bool = False


_VALID_OPTIONS = {
    "num_cpus", "num_gpus", "memory", "resources", "name",
    "lifetime", "max_retries", "max_restarts", "max_task_retries",
    "num_returns", "scheduling_strategy", "placement_group",
    "placement_group_bundle_index", "max_concurrency", "runtime_env",
    "namespace", "get_if_exists", "max_pending_calls", "retry_exceptions",
    "concurrency_groups", "label_selector", "_stream_max_buffer",
    "deadline_s", "on_overload",
}


def validate_options(opts: Dict[str, Any], for_actor: bool) -> Dict[str, Any]:
    for k in opts:
        if k not in _VALID_OPTIONS:
            raise ValueError(f"invalid option {k!r}; valid: {sorted(_VALID_OPTIONS)}")
    for k in ("num_cpus", "num_gpus", "memory"):
        v = opts.get(k)
        if v is not None and (not isinstance(v, (int, float)) or v < 0):
            raise ValueError(f"{k} must be a non-negative number, got {v!r}")
    n_gpus = opts.get("num_gpus")
    if n_gpus is not None and n_gpus > 1 and int(n_gpus) != n_gpus:
        raise ValueError("num_gpus must be a whole number when > 1 (GPUs are not divisible)")
    if not for_actor:
        for k in ("max_restarts", "max_task_retries", "max_concurrency"):
            if opts.get(k) is not None:
                raise ValueError(f"option {k!r} is only valid for actors")
    else:
        for k in ("deadline_s", "on_overload"):
            if opts.get(k) is not None:
                raise ValueError(f"option {k!r} is only valid for tasks")
    d = opts.get("deadline_s")
    if d is not None and (not isinstance(d, (int, float)) or d <= 0):
        raise ValueError(f"deadline_s must be a positive number, got {d!r}")
    oo = opts.get("on_overload")
    if oo not in (None, "block", "fail"):
        raise ValueError(f"on_overload must be 'block' or 'fail', got {oo!r}")
    return opts


def resources_from_options(opts: Dict[str, Any], default_num_cpus: float) -> ResourceSet:
    req: Dict[str, float] = dict(opts.get("resources") or {})
    for name in (CPU, GPU, "memory"):
        if name in req:
            raise ValueError(f"use num_cpus/num_gpus/... instead of resources[{name!r}]")
    num_cpus = opts.get("num_cpus")
    req[CPU] = default_num_cpus if num_cpus is None else num_cpus
    if opts.get("num_gpus"):
        req[GPU] = opts["num_gpus"]
    if opts.get("memory"):
        req["memory"] = opts["memory"]
    return ResourceSet(req)


@dataclasses.dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    function_id: str                       # key into the GCS function table
    function_name: str                     # human-readable, for errors/state
    args: Tuple = ()                       # already-serialized or plain values
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    num_returns: int = 1
    resources: ResourceSet = dataclasses.field(default_factory=ResourceSet)
    scheduling_strategy: SchedulingStrategy = dataclasses.field(default_factory=SchedulingStrategy)
    max_retries: int = 0
    retry_exceptions: bool = False
    runtime_env: Optional[dict] = None
    # Actor-task fields
    actor_id: Optional[ActorID] = None
    sequence_number: int = -1              # per-caller ordering for actor tasks
    is_actor_creation: bool = False

    @property
    def scheduling_key(self) -> Tuple:
        """Tasks with the same key can reuse a worker lease (reference:
        ``direct_task_transport.h`` scheduling_key)."""
        return (self.function_id, tuple(sorted(self.resources.to_dict().items())),
                self.scheduling_strategy.kind)


@dataclasses.dataclass
class ActorCreationSpec:
    actor_id: ActorID
    job_id: JobID
    class_id: str
    class_name: str
    args: Tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    resources: ResourceSet = dataclasses.field(default_factory=ResourceSet)
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    name: Optional[str] = None
    namespace: Optional[str] = None
    lifetime: Optional[str] = None         # None | "detached"
    scheduling_strategy: SchedulingStrategy = dataclasses.field(default_factory=SchedulingStrategy)
    runtime_env: Optional[dict] = None
