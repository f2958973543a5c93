"""PG: vanilla policy gradient (REINFORCE) (port of
``ray_tpu/rl/algorithms/pg.py``).

``loss = -mean(logp(a|s) * R)`` with normalised monte-carlo returns, no
clipping, no value baseline, one pass. The config pins ``lambda_ = 1.0``
so the runner's GAE degenerates to monte-carlo returns (the untouched value
head stays near zero, so ``value_targets`` are the discounted returns).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.algorithms.ppo import logp_and_entropy, normalize
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import Learner


class PGConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=PG, **kwargs)
        self.lambda_ = 1.0     # monte-carlo returns, the REINFORCE target
        self.num_epochs = 1    # strictly on-policy: one pass, no reuse
        self.lr = 4e-3


def make_pg_loss(spec, entropy_coeff: float):
    def loss_fn(params, batch, key=None):
        logits = models.policy_logits(params, batch["obs"])
        logp, entropy = logp_and_entropy(spec, params, logits,
                                         batch["actions"])
        ret = normalize(batch["value_targets"])
        pi_loss = -torch.mean(logp * ret)
        total = pi_loss - entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "entropy": entropy}

    return loss_fn


class PG(Algorithm):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return PGConfig()

    def build_learner(self) -> None:
        cfg = self.config
        self.learner = Learner(self.init_policy_params(),
                               make_pg_loss(self.spec, cfg.entropy_coeff),
                               cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed,
                               device=self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        batch = self.synchronous_sample(self.learner.get_params())
        metrics = self.learner.update(
            batch, num_epochs=1, minibatch_size=cfg.minibatch_size or 0,
            seed=cfg.seed + self._iteration)
        result = dict(metrics)
        result.update(self.collect_episode_stats())
        result["env_steps_this_iter"] = len(batch["rewards"])
        return result
