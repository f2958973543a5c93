"""Reinforcement learning on the port: the on-policy RL stack (numpy envs,
connectors, RLModule and Catalog, EnvRunner, Learner, Algorithm; PPO, PG,
A2C, IMPALA and APPO), the fused PPO iteration and RLHF. One process, one
device: JAX's actor layer (``LearnerGroup``, the policy server) is not
ported."""

from ray_tpu_torch.rl.algorithm import Algorithm  # noqa: F401
from ray_tpu_torch.rl.algorithms import (  # noqa: F401
    A2C,
    A2CConfig,
    APPO,
    APPOConfig,
    IMPALA,
    IMPALAConfig,
    PG,
    PGConfig,
    PPO,
    PPOConfig,
)
from ray_tpu_torch.rl.config import AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rl.connectors import (  # noqa: F401
    ClipObs,
    ClipReward,
    Connector,
    ConnectorPipeline,
    MeanStdFilter,
    build_connectors,
)
from ray_tpu_torch.rl.env import (  # noqa: F401
    CartPole,
    EnvSpec,
    Pendulum,
    VectorEnv,
    make_env,
    register_env,
)
from ray_tpu_torch.rl.env_runner import EnvRunner, compute_gae  # noqa: F401
from ray_tpu_torch.rl.learner import Learner, LearnerGroup  # noqa: F401
from ray_tpu_torch.rl.rl_module import (  # noqa: F401
    Catalog,
    ModuleSpec,
    MultiAgentRLModule,
    RLModule,
    register_module_builder,
)
