"""The on-policy RL algorithms: PPO, PG, A2C, IMPALA (V-trace) and APPO."""

from ray_tpu_torch.rl.algorithms.a2c import A2C, A2CConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.impala import (  # noqa: F401
    IMPALA,
    IMPALAConfig,
)
from ray_tpu_torch.rl.algorithms.pg import PG, PGConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig  # noqa: F401
