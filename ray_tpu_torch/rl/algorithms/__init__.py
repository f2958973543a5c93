"""The RL algorithms of the port: on-policy (PPO, PG, A2C, IMPALA with
V-trace, APPO), value-based (DQN, SimpleQ, Ape-X DQN, R2D2), continuous
control (DDPG, TD3, SAC, Ape-X DDPG), offline (BC, MARWIL, CQL, CRR, the
Decision Transformer), multi-agent (QMIX, MADDPG), meta-learning (MAML),
model-based (MBMPO, DreamerV3), population-based (ES, ARS), search
(AlphaZero, LeelaChessZero), slate recommendation (SlateQ) and contextual
bandits (LinUCB, LinTS)."""

from ray_tpu_torch.rl.algorithms.a2c import A2C, A2CConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.alphazero import (  # noqa: F401
    AlphaZero,
    AlphaZeroConfig,
    Game,
    MCTS,
    TicTacToe,
)
from ray_tpu_torch.rl.algorithms.apex import (  # noqa: F401
    ApexDDPG,
    ApexDDPGConfig,
    ApexDQN,
    ApexDQNConfig,
)
from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.ars import ARS, ARSConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.bandits import (  # noqa: F401
    BanditConfig,
    BanditLinTS,
    BanditLinUCB,
    LinearBanditEnv,
)
from ray_tpu_torch.rl.algorithms.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.crr import CRR, CRRConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.ddpg import (  # noqa: F401
    DDPG,
    DDPGConfig,
    TD3,
    TD3Config,
)
from ray_tpu_torch.rl.algorithms.dqn import (  # noqa: F401
    DQN,
    DQNConfig,
    SimpleQ,
    SimpleQConfig,
)
from ray_tpu_torch.rl.algorithms.dreamer import (  # noqa: F401
    DreamerV3,
    DreamerV3Config,
)
from ray_tpu_torch.rl.algorithms.dt import DT, DTConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.es import ES, ESConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.impala import (  # noqa: F401
    IMPALA,
    IMPALAConfig,
)
from ray_tpu_torch.rl.algorithms.lc0 import (  # noqa: F401
    ConnectFour,
    LeelaChessZero,
    LeelaChessZeroConfig,
)
from ray_tpu_torch.rl.algorithms.maddpg import (  # noqa: F401
    MADDPG,
    MADDPGConfig,
)
from ray_tpu_torch.rl.algorithms.maml import (  # noqa: F401
    MAML,
    MAMLConfig,
    PointGoal,
)
from ray_tpu_torch.rl.algorithms.mbmpo import (  # noqa: F401
    MBMPO,
    MBMPOConfig,
)
from ray_tpu_torch.rl.algorithms.offline import (  # noqa: F401
    BC,
    BCConfig,
    MARWIL,
    MARWILConfig,
)
from ray_tpu_torch.rl.algorithms.pg import PG, PGConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.qmix import QMIX, QMIXConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.r2d2 import (  # noqa: F401
    MaskedCartPole,
    R2D2,
    R2D2Config,
)
from ray_tpu_torch.rl.algorithms.sac import SAC, SACConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.slateq import (  # noqa: F401
    RecSlateEnv,
    SlateQ,
    SlateQConfig,
)
