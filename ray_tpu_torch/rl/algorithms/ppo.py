"""PPO's clipped-objective loss (``make_ppo_loss`` of
``ray_tpu/rl/algorithms/ppo.py``; the ``PPO`` algorithm class needs the
algorithm and learner modules, not ported yet)."""

from __future__ import annotations

from typing import Callable

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.env import EnvSpec


def make_ppo_loss(spec: EnvSpec, clip_param: float, vf_coeff: float,
                  entropy_coeff: float) -> Callable:
    """``loss_fn(params, batch, key) -> (total, {"policy_loss", "vf_loss",
    "entropy", "kl"})`` over a batch of obs, actions, logp, advantages and
    value_targets; the advantages are normalised over the batch with the
    population std, as ``jnp.std``. Discrete action spaces only: the
    Gaussian head is not ported yet. ``key`` is unused, as in JAX."""
    if not spec.discrete:
        raise NotImplementedError("continuous action spaces (the Gaussian "
                                  "head) are not ported yet")

    def loss_fn(params, batch, key=None):
        obs = batch["obs"]
        logits = models.policy_logits(params, obs)
        logp = models.categorical_logp(logits, batch["actions"])
        entropy = models.categorical_entropy(logits).mean()
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
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
