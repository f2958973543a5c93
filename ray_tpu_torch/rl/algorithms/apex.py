"""Ape-X DQN and Ape-X DDPG: distributed prioritized experience replay
(port of ``ray_tpu/rl/algorithms/apex.py``).

Reference analog: ``rllib/algorithms/apex_dqn/apex_dqn.py`` (Horgan et
al. 2018). The three Ape-X signatures:

1. **Async sampling fleet.** JAX's runners keep producing fragments under
   slightly stale params and the learner consumes them in the order
   ``ray_tpu.wait`` gives, as ``impala.py``'s ``RoundRobinFleet`` does
   on the port's runner actors. In one process that staleness is
   reproduced deterministically by the same fleet: each runner
   in flight holds the params it was submitted with (a snapshot), the
   runners are consumed round robin, each sampled at consume time with
   its snapshot and resubmitted with the current params before the
   learner's updates.
2. **Per-runner exploration ladder.** Runner ``i`` of ``N`` explores with
   ``eps_i = base ** (1 + alpha * i / (N - 1))`` (the paper's schedule);
   Ape-X DDPG uses the same ladder for its Gaussian noise sigma.
3. **Prioritized replay always on.** New fragments enter the buffer at
   max priority; sampled minibatches update priorities from the TD error.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rl.algorithms.ddpg import DDPG
from ray_tpu_torch.rl.algorithms.dqn import DQN
from ray_tpu_torch.rl.algorithms.impala import RoundRobinFleet
from ray_tpu_torch.rl.config import AlgorithmConfig


class ApexDQNConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=ApexDQN, **kwargs)
        self.lr = 1e-3
        self.minibatch_size = 64
        self.num_env_runners = 4
        self.prioritized_replay = True
        self.apex_eps_base = 0.4
        self.apex_eps_alpha = 7.0
        self.updates_per_iter = 16


def ladder(base: float, alpha: float, n: int) -> list:
    """``base ** (1 + alpha * i / (n - 1))`` for runner ``i`` of ``n``."""
    return [base ** (1 + alpha * i / max(1, n - 1)) for i in range(n)]


class _ApexFleet(RoundRobinFleet):
    """The Ape-X actor/learner decoupling shared by the DQN and DDPG
    variants: IMPALA's round-robin runners in flight feeding a
    prioritized buffer. Subclasses provide ``_params_for(runner_i)`` (the
    exploration ladder) and the learner side's ``_replay_updates`` (from
    their base algorithm)."""

    def _store_batch(self, batch) -> None:
        self.buffer.add_batch(
            {k: batch[k] for k in ("obs", "actions", "rewards",
                                   "next_obs", "dones")})

    def _pump_round(self) -> int:
        """One round of fragments into the buffer: the env steps taken."""
        consumed = 0
        for batch in self._consume_round("Ape-X"):
            self._store_batch(batch)
            consumed += len(batch["rewards"])
        return consumed


class ApexDQN(_ApexFleet, DQN):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return ApexDQNConfig()

    def build_learner(self) -> None:
        cfg = self.config
        if not cfg.prioritized_replay:
            raise ValueError("ApexDQN requires prioritized_replay=True "
                             "(it IS the algorithm)")
        super().build_learner()
        self._init_fleet()
        # epsilon ladder: runner i's exploration is fixed, not annealed
        self._runner_eps = ladder(cfg.apex_eps_base, cfg.apex_eps_alpha,
                                  max(1, len(self.runners)))

    def _params_for(self, runner_i: int):
        return self._runner_params(epsilon=self._runner_eps[runner_i])

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        consumed = self._pump_round()
        metrics: Dict[str, Any] = {"buffer_size": len(self.buffer),
                                   "env_steps_this_iter": consumed,
                                   "eps_ladder_min": self._runner_eps[-1],
                                   "eps_ladder_max": self._runner_eps[0]}
        if len(self.buffer) >= cfg.learning_starts:
            metrics["td_abs_mean"] = self._replay_updates(
                cfg.updates_per_iter or 16)
            metrics["num_updates"] = self._updates
        metrics.update(self.collect_episode_stats())
        return metrics


class ApexDDPGConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=ApexDDPG, **kwargs)
        self.env = "Pendulum-v1"
        self.lr = 1e-3
        self.minibatch_size = 256
        self.num_env_runners = 4
        self.prioritized_replay = True
        self.policy_delay = 1
        self.target_noise = 0.0
        self.updates_per_iter = 16
        # per-runner Gaussian noise ladder (the continuous-action analog of
        # the epsilon ladder): sigma_i = base ** (1 + alpha * i / (N - 1))
        self.apex_sigma_base = 0.4
        self.apex_sigma_alpha = 3.0


class ApexDDPG(_ApexFleet, DDPG):
    """Ape-X DDPG: the prioritized-replay harness around the
    deterministic-policy-gradient learner (reference analog:
    ``rllib/algorithms/apex_ddpg/apex_ddpg.py``); exploration diversity
    comes from a per-runner Gaussian-noise ladder instead of epsilon."""

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return ApexDDPGConfig()

    def build_learner(self) -> None:
        cfg = self.config
        if not cfg.prioritized_replay:
            raise ValueError("ApexDDPG requires prioritized_replay=True "
                             "(it IS the algorithm)")
        super().build_learner()
        self._init_fleet()
        self._runner_sigmas = ladder(cfg.apex_sigma_base,
                                     cfg.apex_sigma_alpha,
                                     max(1, len(self.runners)))

    def _params_for(self, runner_i: int):
        return self._runner_params(sigma=self._runner_sigmas[runner_i])

    def _store_batch(self, batch) -> None:
        # replay the EXECUTED (noisy, clipped) action: the critic's TD
        # target must condition on what actually hit the env
        self.buffer.add_batch(
            {"obs": batch["obs"], "actions": batch["actions_executed"],
             "rewards": batch["rewards"], "next_obs": batch["next_obs"],
             "dones": batch["dones"]})

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        consumed = self._pump_round()
        metrics: Dict[str, Any] = {"buffer_size": len(self.buffer),
                                   "env_steps_this_iter": consumed,
                                   "sigma_ladder_min": self._runner_sigmas[-1],
                                   "sigma_ladder_max": self._runner_sigmas[0]}
        if len(self.buffer) >= cfg.learning_starts:
            metrics.update(self._replay_updates(cfg.updates_per_iter or 16))
            metrics["num_updates"] = self._updates
        metrics.update(self.collect_episode_stats())
        return metrics
