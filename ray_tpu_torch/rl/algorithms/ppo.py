"""PPO: clipped-objective policy gradient (port of
``ray_tpu/rl/algorithms/ppo.py``).

The loss is the clip surrogate + value loss + entropy bonus, advantages
normalised per minibatch with the population std (``jnp.std``); the
update runs epochs x minibatches on the in-process Learner.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm, make_learner
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.env import EnvSpec


def logp_and_entropy(spec: EnvSpec, params, logits: torch.Tensor,
                     actions: torch.Tensor):
    """The actions' log-probability under ``logits`` and the mean entropy:
    categorical for discrete specs, the diagonal Gaussian with
    ``params["log_std"]`` for continuous ones."""
    if spec.discrete:
        return (models.categorical_logp(logits, actions),
                models.categorical_entropy(logits).mean())
    return (models.gaussian_logp(logits, params["log_std"], actions),
            models.gaussian_entropy(params["log_std"]))


def normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / (std + 1e-8) with the population std, as JAX's."""
    return (x - x.mean()) / (x.std(correction=0) + 1e-8)


def make_ppo_loss(spec: EnvSpec, clip_param: float, vf_coeff: float,
                  entropy_coeff: float) -> Callable:
    """``loss_fn(params, batch, key) -> (total, {"policy_loss", "vf_loss",
    "entropy", "kl"})`` over a batch of obs, actions, logp, advantages and
    value_targets. ``key`` is unused, as in JAX."""
    def loss_fn(params, batch, key=None):
        obs = batch["obs"]
        logits = models.policy_logits(params, obs)
        logp, entropy = logp_and_entropy(spec, params, logits,
                                         batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = normalize(batch["advantages"])
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv)
        policy_loss = -surr.mean()
        values = models.value(params, obs)
        vf_loss = torch.mean((values - batch["value_targets"]) ** 2)
        total = policy_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        kl = torch.mean(batch["logp"] - logp)
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "kl": kl}

    return loss_fn


class PPO(Algorithm):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return AlgorithmConfig(algo_class=cls)

    def build_learner(self) -> None:
        cfg = self.config
        self.learner = make_learner(self, make_ppo_loss(
            self.spec, cfg.clip_param, cfg.vf_coeff, cfg.entropy_coeff))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        params = self.learner.get_params()
        batch = self.synchronous_sample(params)
        metrics = self.learner.update(
            batch, num_epochs=cfg.num_epochs,
            minibatch_size=cfg.minibatch_size,
            seed=cfg.seed + self._iteration)
        result = dict(metrics)
        result.update(self.collect_episode_stats())
        result["env_steps_this_iter"] = len(batch["rewards"])
        return result


class PPOConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=PPO, **kwargs)
