"""DQN with double-Q, a target network and optional prioritized replay
(port of ``ray_tpu/rl/algorithms/dqn.py``).

Reference analog: ``rllib/algorithms/dqn/`` (+ ``utils/replay_buffers``).
The Q-net reuses the policy MLP (the "pi" head emits Q-values);
exploration is epsilon-greedy on the EnvRunners with the schedule's
epsilon riding in the runner params. The replay buffer stays numpy on the
host; each update moves its minibatch to the learner's device.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import Learner
from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer


def take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[..., idx]`` per row (``jnp.take_along_axis`` on the last
    axis)."""
    return torch.gather(values, -1, idx.long()[..., None])[..., 0]


def make_dqn_loss(gamma: float, double_q: bool):
    """``loss_fn(params, batch, key) -> (loss, {"td_abs_mean", "q_mean",
    "td"})`` over ``params = {"q", "target"}`` and a batch of obs,
    actions, rewards, next_obs, dones and optional importance
    ``weights``."""
    def loss_fn(params, batch, key=None):
        q = models.policy_logits(params["q"], batch["obs"])
        q_taken = take(q, batch["actions"])
        with torch.no_grad():   # JAX's stop_gradient on the bootstrap
            q_next_t = models.policy_logits(params["target"],
                                            batch["next_obs"])
            if double_q:
                best = torch.argmax(
                    models.policy_logits(params["q"], batch["next_obs"]),
                    dim=-1)
                q_next = take(q_next_t, best)
            else:
                q_next = torch.max(q_next_t, dim=-1).values
        nonterminal = 1.0 - batch["dones"].float()
        target = batch["rewards"] + gamma * nonterminal * q_next
        td = q_taken - target
        weights = batch.get("weights")
        loss = torch.mean((td ** 2) if weights is None
                          else weights * td ** 2)
        return loss, {"td_abs_mean": torch.mean(torch.abs(td)),
                      "q_mean": torch.mean(q_taken), "td": td.detach()}

    return loss_fn


def make_buffer(cfg: AlgorithmConfig):
    """The prioritized buffer where ``prioritized_replay``, else the ring."""
    if cfg.prioritized_replay:
        return PrioritizedReplayBuffer(cfg.buffer_size,
                                       alpha=cfg.replay_alpha,
                                       beta=cfg.replay_beta, seed=cfg.seed)
    return ReplayBuffer(cfg.buffer_size, seed=cfg.seed)


def replay_minibatch(buffer, cfg: AlgorithmConfig):
    """(minibatch, sampled indices or None): prioritized samples carry
    their importance ``weights``."""
    if cfg.prioritized_replay:
        sample, idx, weights = buffer.sample(cfg.minibatch_size)
        return dict(sample, weights=weights), idx
    return buffer.sample(cfg.minibatch_size), None


class DQN(Algorithm):
    explore_mode = "epsilon_greedy"

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        cfg = AlgorithmConfig(algo_class=cls)
        cfg.lr = 1e-3
        cfg.minibatch_size = 64
        return cfg

    def build_learner(self) -> None:
        cfg = self.config
        init_q = self.init_policy_params()
        params = {"q": init_q, "target": models.clone_tree(init_q)}
        self.learner = Learner(params, make_dqn_loss(cfg.gamma, cfg.double_q),
                               cfg.lr, grad_clip=cfg.grad_clip,
                               seed=cfg.seed, device=self.device)
        # the target net takes zero grads, but _replay_updates restores it
        # after every update all the same (as JAX's) and hard-syncs it on
        # the schedule
        self.buffer = make_buffer(cfg)
        self._updates = 0

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps_total / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def _runner_params(self, epsilon: float = None):
        p = self.learner.get_params()
        eps = self._epsilon() if epsilon is None else epsilon
        return {"pi": p["q"]["pi"], "vf": p["q"]["vf"], "epsilon": eps}

    def _eval_params(self):
        """Greedy Q-policy (epsilon off) for Algorithm.evaluate."""
        return {**self._runner_params(), "epsilon": 0.0}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        batch = self.synchronous_sample(self._runner_params())
        self.buffer.add_batch(
            {k: batch[k] for k in
             ("obs", "actions", "rewards", "next_obs", "dones")})
        metrics: Dict[str, Any] = {"epsilon": self._epsilon(),
                                   "buffer_size": len(self.buffer)}
        if len(self.buffer) >= cfg.learning_starts:
            num_updates = (cfg.updates_per_iter or
                           max(1, len(batch["rewards"]) // cfg.minibatch_size))
            metrics["td_abs_mean"] = self._replay_updates(num_updates)
            metrics["num_updates"] = self._updates
        metrics.update(self.collect_episode_stats())
        return metrics

    def _replay_updates(self, num_updates: int) -> float:
        """The DQN-family update loop (also Ape-X): prioritized or uniform
        minibatches, the target restored after each step, priorities
        refreshed from the TD error (one host read of ``td`` an update),
        a hard target sync (a copy, never an alias) every
        ``target_update_freq`` updates. Returns the mean |TD|, read once."""
        cfg = self.config
        td_list = []
        for _ in range(num_updates):
            target_before = self.learner.params["target"]
            sample, idx = replay_minibatch(self.buffer, cfg)
            m = self.learner.update_minibatch(sample)
            # the target net moves only by the periodic hard sync
            self.learner.params = dict(self.learner.params,
                                       target=target_before)
            if idx is not None:
                self.buffer.update_priorities(idx, m["td"].cpu().numpy())
            td_list.append(m["td_abs_mean"])
            self._updates += 1
            if self._updates % cfg.target_update_freq == 0:
                self.learner.params = dict(
                    self.learner.params,
                    target=models.clone_tree(self.learner.params["q"]))
        return float(np.mean(torch.stack(td_list).double().cpu().numpy()))

    def get_extra_state(self):
        return {"updates": self._updates}

    def set_extra_state(self, state) -> None:
        if state:
            self._updates = state.get("updates", 0)


class DQNConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=DQN, **kwargs)
        self.lr = 1e-3
        self.minibatch_size = 64


class SimpleQ(DQN):
    """Reference ``rllib/algorithms/simple_q``: DQN stripped of the
    DQN-paper add-ons (no double-Q, no prioritized replay). A real class,
    not a registry alias to DQN, so checkpoints, ``run_train("SIMPLEQ")``
    output and ``type(algo).__name__`` all report the algorithm that
    actually ran."""


class SimpleQConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=SimpleQ, **kwargs)
        self.lr = 1e-3
        self.minibatch_size = 64
        self.double_q = False
        self.prioritized_replay = False
