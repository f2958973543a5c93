"""Distributed training orchestration (port of ``ray_tpu/train/``).

Reference analog: ``python/ray/train/`` — ``DataParallelTrainer`` +
``BackendExecutor`` + ``WorkerGroup`` + ``_TrainSession``. The gradient
path is never a runtime service: each worker runs the port's step
(``StepDriver``) on its GPU; the Train layer only places the gang (a
placement group), joins a torch process group when the gang has more than
one worker, moves reported metrics and checkpoints, and restarts the gang
on failure.
"""

from ray_tpu_torch.train.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    FastPathConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.train.driver import StepDriver  # noqa: F401
from ray_tpu_torch.train.session import (  # noqa: F401
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_fast_path,
    report,
)
from ray_tpu_torch.train.trainer import (  # noqa: F401
    Result,
    TorchTrainer,
    TrainingFailedError,
)
