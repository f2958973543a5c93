"""SAC: soft actor-critic for continuous control (port of
``ray_tpu/rl/algorithms/sac.py``).

Reference analog: ``rllib/algorithms/sac/``. Twin soft-Q networks with
polyak-averaged targets, a tanh-squashed Gaussian policy through the
reparameterization trick, and automatic entropy-temperature tuning, all
one update. The loss draws its noise through ``models.normal`` from the
learner's generator, in JAX's order (the next-state sample, then the
actor's).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.algorithms.ddpg import (detach_tree, init_critic,
                                              polyak, q_value)
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import Learner
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer

LOG_2PI = math.log(2 * math.pi)


def _squashed_sample_logp(mean, log_std, gen, low: float, high: float):
    """tanh-squashed Gaussian rescaled to [low, high], with its exact logp;
    the noise is one ``models.normal`` draw of ``mean``'s shape."""
    std = torch.exp(torch.clamp(log_std, -8.0, 2.0))
    eps = models.normal(gen, mean.shape)
    pre = mean + std * eps
    logp = torch.sum(-0.5 * (eps ** 2 + 2 * torch.log(std) + LOG_2PI),
                     dim=-1)
    tanh = torch.tanh(pre)
    # d tanh correction
    logp = logp - torch.sum(torch.log(1 - tanh ** 2 + 1e-6), dim=-1)
    half_span = (high - low) / 2.0
    mid = (high + low) / 2.0
    action = mid + half_span * tanh
    logp = logp - action.shape[-1] * math.log(half_span)
    return action, logp


def pi_dist(pi_params, obs):
    """The pi-net's output split into (mean, log_std)."""
    out = models.mlp_forward(pi_params, obs)
    return torch.chunk(out, 2, dim=-1)


def init_soft_actor_critic(gen: torch.Generator, spec, cfg: AlgorithmConfig,
                           log_alpha: bool = True) -> Dict:
    """``{pi, q1, q2, q1_target, q2_target[, log_alpha]}``: the pi-net
    emits a mean and a log_std per action dim (SAC, CQL, CRR)."""
    pi = models.init_mlp(
        gen, [spec.obs_dim, *cfg.hidden, 2 * spec.action_dim],
        out_scale=0.01)
    q1 = init_critic(gen, spec, cfg.hidden)
    q2 = init_critic(gen, spec, cfg.hidden)
    params = {"pi": pi, "q1": q1, "q2": q2,
              "q1_target": models.clone_tree(q1),
              "q2_target": models.clone_tree(q2)}
    if log_alpha:
        params["log_alpha"] = torch.tensor(
            float(np.log(cfg.initial_alpha)), dtype=torch.float32,
            device=gen.device)
    return params


def make_sac_loss(spec, cfg: AlgorithmConfig):
    """``loss_fn(params, batch, gen) -> (total, {"q1_loss", "pi_loss",
    "alpha", "entropy"})``."""
    gamma = cfg.gamma
    low, high = float(spec.action_low), float(spec.action_high)
    target_entropy = -float(spec.action_dim)
    autotune = cfg.autotune_alpha

    def loss_fn(params, batch, gen=None):
        obs, nobs = batch["obs"], batch["next_obs"]
        acts = batch["actions"]
        alpha = torch.exp(params["log_alpha"])
        # --- critic target ---
        with torch.no_grad():
            nmean, nlogstd = pi_dist(params["pi"], nobs)
            nact, nlogp = _squashed_sample_logp(nmean, nlogstd, gen, low,
                                                high)
            qt = torch.minimum(q_value(params["q1_target"], nobs, nact),
                               q_value(params["q2_target"], nobs, nact))
            nonterminal = 1.0 - batch["dones"].float()
            target = batch["rewards"] + gamma * nonterminal * (
                qt - alpha * nlogp)
        q1_loss = torch.mean((q_value(params["q1"], obs, acts) - target) ** 2)
        q2_loss = torch.mean((q_value(params["q2"], obs, acts) - target) ** 2)
        # --- actor ---
        mean, log_std = pi_dist(params["pi"], obs)
        act_new, logp = _squashed_sample_logp(mean, log_std, gen, low, high)
        q_min = torch.minimum(
            q_value(detach_tree(params["q1"]), obs, act_new),
            q_value(detach_tree(params["q2"]), obs, act_new))
        pi_loss = torch.mean(alpha.detach() * logp - q_min)
        # --- temperature ---
        if autotune:
            alpha_loss = -torch.mean(
                params["log_alpha"] * (logp + target_entropy).detach())
        else:
            alpha_loss = 0.0
        total = q1_loss + q2_loss + pi_loss + alpha_loss
        return total, {"q1_loss": q1_loss, "pi_loss": pi_loss,
                       "alpha": alpha.detach(), "entropy": -torch.mean(logp)}

    return loss_fn


def squashed_runner_params(algo, log_std: float) -> Dict:
    """The runner protocol for a mean/log_std pi-net: the runner (in
    ``squashed_gaussian`` mode) calls ``policy_logits`` for the mean, so
    the pi-net's last layer is sliced to its mean half; a zero value head
    (obs -> 0) and a fixed exploration ``log_std``."""
    p = algo.learner.get_params()
    adim, obs_dim, dev = algo.spec.action_dim, algo.spec.obs_dim, algo.device
    layers = list(p["pi"]["layers"])
    last = layers[-1]
    layers[-1] = {"w": last["w"][:, :adim], "b": last["b"][:adim]}
    vf = {"layers": [{"w": torch.zeros((obs_dim, 1), device=dev),
                      "b": torch.zeros(1, device=dev)}]}
    return {"pi": {**p["pi"], "layers": layers}, "vf": vf,
            "log_std": torch.full((adim,), log_std, device=dev)}


class SAC(Algorithm):
    # execute the same tanh-squashed policy the learner optimizes (the raw
    # runner protocol would act on pre-squash means — a different policy)
    explore_mode = "squashed_gaussian"

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        cfg = AlgorithmConfig(algo_class=cls)
        cfg.env = "Pendulum-v1"
        cfg.lr = 3e-4
        cfg.minibatch_size = 256
        cfg.learning_starts = 1_000
        return cfg

    def build_learner(self) -> None:
        cfg = self.config
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.learner = Learner(init_soft_actor_critic(gen, self.spec, cfg),
                               make_sac_loss(self.spec, cfg), cfg.lr,
                               grad_clip=cfg.grad_clip, seed=cfg.seed,
                               device=self.device)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)

    def _runner_params(self):
        """The squashed policy with a moderate fixed exploration std
        (per-state log_std can't ride the runner protocol); training
        recomputes exact squashed logps from the buffer."""
        return squashed_runner_params(self, -0.5)

    def _eval_params(self):
        """Mean action (std ~0) for Algorithm.evaluate."""
        return squashed_runner_params(self, -20.0)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        batch = self.synchronous_sample(self._runner_params())
        # train the critic on the action the env executed (clipped), not
        # the raw Gaussian sample
        self.buffer.add_batch(
            {"obs": batch["obs"], "actions": batch["actions_executed"],
             "rewards": batch["rewards"], "next_obs": batch["next_obs"],
             "dones": batch["dones"]})
        metrics: Dict[str, Any] = {"buffer_size": len(self.buffer)}
        if len(self.buffer) >= cfg.learning_starts:
            num_updates = (cfg.updates_per_iter or
                           max(1, len(batch["rewards"]) // cfg.minibatch_size))
            for _ in range(num_updates):
                m = self.learner.update_minibatch(
                    self.buffer.sample(cfg.minibatch_size))
                self.learner.params = polyak(self.learner.params,
                                             ("q1", "q2"), cfg.tau)
            metrics.update({k: float(v) for k, v in m.items()})
        metrics.update(self.collect_episode_stats())
        return metrics


class SACConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=SAC, **kwargs)
        self.env = "Pendulum-v1"
        self.minibatch_size = 256
