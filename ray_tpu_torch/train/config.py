"""Train-layer configuration objects.

Reference analog: ``ray.air.config`` (``ScalingConfig air/config.py:94``,
``FailureConfig :523``, ``CheckpointConfig :574``, ``RunConfig :723``).
Port of ``ray_tpu/train/config.py``: ScalingConfig speaks GPUs (workers ×
GPUs per worker, one by default) where JAX's speaks TPU chips and
topologies. ``gpus_per_worker=0`` (or ``use_gpu=False``) makes a CPU
gang, whose process group is gloo; a GPU gang's is NCCL.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ray_tpu_torch.core.resources import CPU, GPU


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    gpus_per_worker: int = 1
    use_gpu: bool = True
    cpus_per_worker: float = 1
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"    # SPREAD across hosts for gangs

    def __post_init__(self):
        if (self.gpus_per_worker < 0
                or int(self.gpus_per_worker) != self.gpus_per_worker):
            raise ValueError(
                f"gpus_per_worker must be a whole number >= 0, got "
                f"{self.gpus_per_worker!r}")
        if not self.use_gpu:
            self.gpus_per_worker = 0
        elif self.gpus_per_worker == 0:
            self.use_gpu = False

    def bundle(self) -> Dict[str, float]:
        b: Dict[str, float] = {CPU: self.cpus_per_worker}
        if self.gpus_per_worker:
            b[GPU] = float(self.gpus_per_worker)
        b.update(self.resources_per_worker or {})
        return b

    @property
    def backend(self) -> str:
        """The gang's process-group backend: NCCL for GPU workers, gloo
        for CPU ones (chosen from the config, never by a fallback)."""
        return "nccl" if self.use_gpu else "gloo"


@dataclasses.dataclass
class FastPathConfig:
    """The fused-K training fast path.

    ``steps_per_launch`` is the launch-amortization knob: the
    :class:`~ray_tpu_torch.train.driver.StepDriver` stacks K data-plane
    batches and runs them as ONE launch of K optimizer steps
    (``parallel/train_step.make_multi_step``), degrading to single-step
    for ragged tail batches. ``async_report`` / ``async_checkpoint`` keep ``session.report``
    metric coercion and checkpoint serialization on the session's drainer
    thread instead of the step loop.
    """

    steps_per_launch: int = 1
    async_report: bool = True
    async_checkpoint: bool = True

    def __post_init__(self):
        if self.steps_per_launch < 1:
            raise ValueError(
                f"steps_per_launch must be >= 1, got {self.steps_per_launch}")


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0  # gang restarts from last checkpoint


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    # default: <the temporary directory, TMPDIR>/ray_tpu_torch_results
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    fast_path: FastPathConfig = dataclasses.field(default_factory=FastPathConfig)
