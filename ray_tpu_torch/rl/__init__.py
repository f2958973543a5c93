"""Reinforcement learning on the port: the RL stack (numpy envs,
connectors, RLModule and Catalog, EnvRunner, Learner, Algorithm, replay
buffers, off-policy estimators) with the on-policy (PPO, PG, A2C, IMPALA,
APPO), value-based (DQN, SimpleQ, Ape-X DQN, R2D2), continuous (DDPG,
TD3, SAC, Ape-X DDPG), offline (BC, MARWIL, CQL, CRR), multi-agent
(MultiAgentEnv, independent PPO, QMIX, MADDPG), meta-learning (MAML) and
model-based (MBMPO, DreamerV3) algorithms, the fused PPO iteration and
RLHF. One process, one device: JAX's actor layer
(``LearnerGroup``, the policy server) is not ported."""

from ray_tpu_torch.rl.algorithm import Algorithm  # noqa: F401
from ray_tpu_torch.rl.algorithms import (  # noqa: F401
    A2C,
    A2CConfig,
    ApexDDPG,
    ApexDDPGConfig,
    ApexDQN,
    ApexDQNConfig,
    APPO,
    APPOConfig,
    BC,
    BCConfig,
    CQL,
    CQLConfig,
    CRR,
    CRRConfig,
    DDPG,
    DDPGConfig,
    DQN,
    DQNConfig,
    DreamerV3,
    DreamerV3Config,
    IMPALA,
    IMPALAConfig,
    MADDPG,
    MADDPGConfig,
    MAML,
    MAMLConfig,
    MARWIL,
    MARWILConfig,
    MaskedCartPole,
    MBMPO,
    MBMPOConfig,
    PG,
    PGConfig,
    PointGoal,
    PPO,
    PPOConfig,
    QMIX,
    QMIXConfig,
    R2D2,
    R2D2Config,
    SAC,
    SACConfig,
    SimpleQ,
    SimpleQConfig,
    TD3,
    TD3Config,
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
from ray_tpu_torch.rl import ope  # noqa: F401
from ray_tpu_torch.rl.learner import Learner, LearnerGroup  # noqa: F401
from ray_tpu_torch.rl.multi_agent import (  # noqa: F401
    CoordinationGame,
    MultiAgentEnv,
    MultiAgentPPO,
    SpreadGame,
    register_multi_agent_env,
)
from ray_tpu_torch.rl.replay_buffer import (  # noqa: F401
    PrioritizedReplayBuffer,
    ReplayBuffer,
)
from ray_tpu_torch.rl.rl_module import (  # noqa: F401
    Catalog,
    ModuleSpec,
    MultiAgentRLModule,
    RLModule,
    register_module_builder,
)
