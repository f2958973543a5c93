"""The parts of Tune the port's algorithms stand on: ``Trainable``."""

from ray_tpu_torch.tune.trainable import (  # noqa: F401
    DONE,
    TRAINING_ITERATION,
    Trainable,
)
