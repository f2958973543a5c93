"""A2C: synchronous advantage actor-critic (port of
``ray_tpu/rl/algorithms/a2c.py``): PPO's sampling with the unclipped
surrogate on GAE advantages + value regression + entropy bonus, one pass
over each batch.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm, make_learner
from ray_tpu_torch.rl.algorithms.ppo import logp_and_entropy, normalize
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.env import EnvSpec


class A2CConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=A2C, **kwargs)
        self.num_epochs = 1  # on-policy single pass — the A2C distinction


def make_a2c_loss(spec: EnvSpec, vf_coeff: float, entropy_coeff: float):
    def loss_fn(params, batch, key=None):
        obs = batch["obs"]
        logits = models.policy_logits(params, obs)
        logp, entropy = logp_and_entropy(spec, params, logits,
                                         batch["actions"])
        adv = normalize(batch["advantages"])
        policy_loss = -(logp * adv).mean()
        values = models.value(params, obs)
        vf_loss = torch.mean((values - batch["value_targets"]) ** 2)
        total = policy_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    return loss_fn


class A2C(Algorithm):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return A2CConfig()

    def build_learner(self) -> None:
        cfg = self.config
        self.learner = make_learner(self, make_a2c_loss(
            self.spec, cfg.vf_coeff, cfg.entropy_coeff))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        params = self.learner.get_params()
        batch = self.synchronous_sample(params)
        metrics = self.learner.update(
            batch, num_epochs=1, minibatch_size=cfg.minibatch_size or 0)
        metrics.update(self.collect_episode_stats())
        return metrics
