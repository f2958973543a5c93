"""AlgorithmConfig: the fluent builder (the port's own copy of
``ray_tpu/rl/config.py``).

Reference analog: ``rllib/algorithms/algorithm_config.py`` — chainable
``.environment().env_runners().training().resources()`` producing an
Algorithm. Flat dict overrides (from Tune param spaces) map onto fields via
``update_from_dict``.

The port runs an algorithm in one process: its runners are plain objects
and its learner sits on the algorithm's device. Every field of JAX's config
is kept, so configs written for JAX (the tuned examples) load unchanged;
the fields that only JAX's actor layer reads (``num_cpus_per_runner``,
``runner_runtime_env``, ``num_tpus_per_learner``) are accepted and unused
here, and ``num_learners > 0`` (a ``LearnerGroup`` of actors) is refused
by the algorithms that would build one.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Type

from ray_tpu_torch._device import DeviceLike


@dataclasses.dataclass
class AlgorithmConfig:
    algo_class: Optional[Type] = None
    # environment
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # env runners (sampling fleet)
    num_env_runners: int = 1
    num_envs_per_runner: int = 8
    rollout_fragment_length: int = 64
    num_cpus_per_runner: float = 1     # unused in one process (actors)
    # runtime_env for JAX's EnvRunner actors; unused in one process
    runner_runtime_env: Optional[dict] = None
    # Fleet fault tolerance (reference: FaultTolerantActorManager,
    # rllib/utils/actor_manager.py): a runner whose call raises is rebuilt
    # from its constructor arguments while it has restarts left, and its
    # fragment is dropped for the iteration instead of killing the
    # training loop.
    restart_failed_env_runners: bool = True
    max_env_runner_restarts: int = 2
    # connector pipeline specs, e.g. ["mean_std_filter",
    # {"type": "clip_reward", "limit": 1.0}] (rl/connectors.py)
    connectors: Any = None
    # training
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    train_batch_size: int = 0          # 0 => runners * envs * fragment
    minibatch_size: int = 128
    num_epochs: int = 4
    grad_clip: float = 0.5
    hidden: tuple = (64, 64)
    seed: int = 0
    # PPO
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    kl_target: float = 0.0             # 0 disables adaptive-KL early stop
    # DQN
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_steps: int = 10_000
    target_update_freq: int = 500
    buffer_size: int = 100_000
    learning_starts: int = 1_000
    # replay-trained algos (DQN/SAC/DDPG/TD3): gradient updates per
    # training_step; 0 derives it from sampled-steps/minibatch (reference:
    # DQN's training_intensity ratio)
    updates_per_iter: int = 0
    double_q: bool = True
    prioritized_replay: bool = False
    replay_alpha: float = 0.6
    replay_beta: float = 0.4
    # SAC
    tau: float = 0.005
    initial_alpha: float = 0.2
    autotune_alpha: bool = True
    # IMPALA
    vtrace_clip_rho: float = 1.0
    vtrace_clip_pg_rho: float = 1.0
    # DDPG / TD3
    exploration_noise: float = 0.1
    policy_delay: int = 2              # TD3 delayed policy updates
    target_noise: float = 0.2          # TD3 target policy smoothing
    noise_clip: float = 0.5
    # offline RL (BC / MARWIL)
    offline_data: Any = None           # dict of arrays or ray_tpu.data Dataset
    beta: float = 1.0                  # MARWIL advantage temperature
    # model container: an rl_module.ModuleSpec routes param init through
    # the Catalog (custom encoder/activation); None = the default policy
    module_spec: Any = None
    # multi-agent
    policy_mapping_fn: Any = None      # agent_id -> policy_id (None = identity)
    # resources
    num_tpus_per_learner: float = 0    # unused in one process (actors)
    num_learners: int = 0              # 0 => learner runs in the algo process

    # ---- fluent builders ----

    def environment(self, env: str, env_config: Optional[Dict] = None
                    ) -> "AlgorithmConfig":
        self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def env_runners(self, num_env_runners: Optional[int] = None,
                    num_envs_per_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    num_cpus_per_runner: Optional[float] = None,
                    connectors: Optional[list] = None,
                    runner_runtime_env: Optional[dict] = None
                    ) -> "AlgorithmConfig":
        for k, v in (("num_env_runners", num_env_runners),
                     ("num_envs_per_runner", num_envs_per_runner),
                     ("rollout_fragment_length", rollout_fragment_length),
                     ("num_cpus_per_runner", num_cpus_per_runner),
                     ("connectors", connectors),
                     ("runner_runtime_env", runner_runtime_env)):
            if v is not None:
                setattr(self, k, v)
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        return self.update_from_dict(kwargs)

    def resources(self, num_tpus_per_learner: Optional[float] = None,
                  num_learners: Optional[int] = None) -> "AlgorithmConfig":
        if num_tpus_per_learner is not None:
            self.num_tpus_per_learner = num_tpus_per_learner
        if num_learners is not None:
            self.num_learners = num_learners
        return self

    def debugging(self, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def update_from_dict(self, d: Dict[str, Any]) -> "AlgorithmConfig":
        for k, v in d.items():
            if k == "lambda":
                k = "lambda_"
            if not hasattr(self, k):
                raise ValueError(f"unknown config key {k!r}")
            setattr(self, k, v)
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    @property
    def effective_train_batch_size(self) -> int:
        if self.train_batch_size:
            return self.train_batch_size
        return (max(1, self.num_env_runners) * self.num_envs_per_runner
                * self.rollout_fragment_length)

    def multi_agent(self, *, policy_mapping_fn=None) -> "AlgorithmConfig":
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def build(self, device: DeviceLike = None):
        """The algorithm, its learner and runners on ``device`` (``cuda``
        unless given; raises without a GPU)."""
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use PPOConfig() etc.")
        return self.algo_class({"__algo_config": self.copy()},
                               device=device)
