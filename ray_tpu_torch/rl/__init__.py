"""Reinforcement learning on the port: the RL stack (numpy envs,
connectors, RLModule and Catalog, EnvRunner, Learner, Algorithm, replay
buffers, off-policy estimators) with the on-policy (PPO, PG, A2C, IMPALA,
APPO), value-based (DQN, SimpleQ, Ape-X DQN, R2D2), continuous (DDPG,
TD3, SAC, Ape-X DDPG), offline (BC, MARWIL, CQL, CRR), multi-agent
(MultiAgentEnv, independent PPO, QMIX, MADDPG), meta-learning (MAML),
model-based (MBMPO, DreamerV3), population-based (ES, ARS), search
(AlphaZero, LeelaChessZero), sequence (the Decision Transformer), slate
(SlateQ) and bandit (LinUCB, LinTS) algorithms, the pixel envs
(``CatchPixels``, ``PixelWrapper``, ``FrameStack``), the fused PPO
iteration, RLHF and the external-env policy server (HTTP). Where the
port's runtime is initialized the runners, the ES/ARS and self-play
workers, the RLHF roles and a ``LearnerGroup``'s learners are actors, as
JAX's; without it an algorithm runs in one process on one device."""

from ray_tpu_torch.rl.algorithm import Algorithm  # noqa: F401
from ray_tpu_torch.rl.algorithms import (  # noqa: F401
    A2C,
    A2CConfig,
    AlphaZero,
    AlphaZeroConfig,
    ApexDDPG,
    ApexDDPGConfig,
    ApexDQN,
    ApexDQNConfig,
    APPO,
    APPOConfig,
    ARS,
    ARSConfig,
    BanditConfig,
    BanditLinTS,
    BanditLinUCB,
    BC,
    BCConfig,
    ConnectFour,
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
    DT,
    DTConfig,
    ES,
    ESConfig,
    Game,
    IMPALA,
    IMPALAConfig,
    LeelaChessZero,
    LeelaChessZeroConfig,
    MADDPG,
    MADDPGConfig,
    MAML,
    MAMLConfig,
    MARWIL,
    MARWILConfig,
    MaskedCartPole,
    MBMPO,
    MBMPOConfig,
    MCTS,
    PG,
    PGConfig,
    PointGoal,
    PPO,
    PPOConfig,
    QMIX,
    QMIXConfig,
    R2D2,
    R2D2Config,
    RecSlateEnv,
    SAC,
    SACConfig,
    SimpleQ,
    SimpleQConfig,
    SlateQ,
    SlateQConfig,
    TD3,
    TD3Config,
    TicTacToe,
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
# registers CatchPixels-v0
from ray_tpu_torch.rl import pixel_env  # noqa: F401
from ray_tpu_torch.rl.policy_server import (  # noqa: F401
    ExternalEnvRunner,
    PolicyClient,
)
from ray_tpu_torch.rl.pixel_env import (  # noqa: F401
    CatchPixels,
    FrameStack,
    PixelWrapper,
    gym_vector_env,
)
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
