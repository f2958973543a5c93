"""CRR: critic-regularized regression for offline RL (port of
``ray_tpu/rl/algorithms/crr.py``).

Reference analog: ``rllib/algorithms/crr/crr.py`` (Wang et al. 2020,
"Critic Regularized Regression"). An offline actor-critic: the critic is
a plain TD(0) ensemble with polyak targets, and the actor is weighted
behavior cloning where the weight is a function of the advantage

    A(s, a) = Q(s, a) - E_{a'~pi}[Q(s, a')]

estimated with ``crr_num_actions`` policy samples. Two weightings from
the paper, selected by ``crr_weight_type``:

- ``"bin"``:  w = 1[A > 0]           (binary filter; "bin_max" in rllib)
- ``"exp"``:  w = clip(exp(A/beta))  (exponential, like AWAC/MARWIL)

One update over offline minibatches, no env interaction (the env is
probed only for spaces, like BC/MARWIL/CQL). The two noise draws go
through ``models.normal`` in JAX's order.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.algorithms.cql import offline_transitions
from ray_tpu_torch.rl.algorithms.ddpg import polyak, q_value
from ray_tpu_torch.rl.algorithms.offline import greedy_returns
from ray_tpu_torch.rl.algorithms.sac import (_squashed_sample_logp,
                                             init_soft_actor_critic, pi_dist)
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import Learner


class CRRConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=CRR, **kwargs)
        self.env = "Pendulum-v1"
        self.minibatch_size = 256
        self.crr_beta = 1.0          # exp-weight temperature
        self.crr_num_actions = 4     # policy samples for E[Q(s, a')]
        self.crr_weight_type = "exp"  # "exp" | "bin"
        self.crr_weight_clip = 20.0
        self.updates_per_iter = 50


def make_crr_loss(spec, cfg: AlgorithmConfig):
    """``loss_fn(params, batch, gen) -> (critic + actor, {"critic_loss",
    "pi_loss", "adv_mean", "weight_mean"})``."""
    gamma = cfg.gamma
    low, high = float(spec.action_low), float(spec.action_high)
    n_samp, beta = cfg.crr_num_actions, cfg.crr_beta
    w_type, w_clip = cfg.crr_weight_type, cfg.crr_weight_clip
    if w_type not in ("exp", "bin"):
        raise ValueError(f"crr_weight_type must be 'exp' or 'bin', "
                         f"got {w_type!r}")

    def loss_fn(params, batch, gen=None):
        obs, nobs = batch["obs"], batch["next_obs"]
        acts = batch["actions"]
        # --- critic: TD(0) toward the min of the target ensemble, the next
        # action drawn from the CURRENT policy (no entropy term) ---
        with torch.no_grad():
            nmean, nlogstd = pi_dist(params["pi"], nobs)
            nact, _ = _squashed_sample_logp(nmean, nlogstd, gen, low, high)
            qt = torch.minimum(q_value(params["q1_target"], nobs, nact),
                               q_value(params["q2_target"], nobs, nact))
            nonterminal = 1.0 - batch["dones"].float()
            target = batch["rewards"] + gamma * nonterminal * qt
        q1_pred = q_value(params["q1"], obs, acts)
        q2_pred = q_value(params["q2"], obs, acts)
        critic_loss = torch.mean((q1_pred - target) ** 2) + \
            torch.mean((q2_pred - target) ** 2)
        # --- advantage estimate: A = Q(s, a_data) - mean_j Q(s, a_j) ---
        mean, log_std = pi_dist(params["pi"], obs)
        with torch.no_grad():
            samp, _ = _squashed_sample_logp(
                mean.expand((n_samp,) + tuple(mean.shape)),
                log_std.expand((n_samp,) + tuple(log_std.shape)),
                gen, low, high)
            rep = obs.expand((n_samp,) + tuple(obs.shape))
            q_samp = torch.minimum(q_value(params["q1"], rep, samp),
                                   q_value(params["q2"], rep, samp))
            q_data = torch.minimum(q1_pred, q2_pred)
            adv = q_data - q_samp.mean(dim=0)
            if w_type == "bin":
                w = (adv > 0).float()
            else:
                w = torch.clamp(torch.exp(adv / beta), max=w_clip)
        # --- actor: advantage-filtered log-likelihood of the data actions
        # (squashed-Gaussian logp of the dataset action) ---
        eps = 1e-6
        span = (high - low) / 2.0
        mid = (high + low) / 2.0
        pre = torch.atanh(torch.clamp((acts - mid) / span, -1 + eps, 1 - eps))
        std = torch.exp(torch.clamp(log_std, -10.0, 2.0))
        base_logp = torch.sum(
            -0.5 * ((pre - mean) / std) ** 2 - torch.log(std)
            - 0.5 * math.log(2 * math.pi), dim=-1)
        # tanh-squash correction
        base_logp = base_logp - torch.sum(
            torch.log(span * (1 - torch.tanh(pre) ** 2) + eps), dim=-1)
        pi_loss = -torch.mean(w * base_logp)
        total = critic_loss + pi_loss
        return total, {"critic_loss": critic_loss, "pi_loss": pi_loss,
                       "adv_mean": adv.mean(), "weight_mean": w.mean()}

    return loss_fn


class CRR(Algorithm):
    need_env_runners = False  # offline: the dataset IS the experience

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return CRRConfig()

    def build_learner(self) -> None:
        cfg, spec = self.config, self.spec
        if spec.discrete:
            raise ValueError("CRR here targets continuous control; use "
                             "BC/MARWIL or DQN-family for discrete")
        self._data = offline_transitions(cfg, "CRR")
        self._n = len(self._data["rewards"])
        self._rng = np.random.default_rng(cfg.seed)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.learner = Learner(
            init_soft_actor_critic(gen, spec, cfg, log_alpha=False),
            make_crr_loss(spec, cfg), cfg.lr, grad_clip=cfg.grad_clip,
            seed=cfg.seed, device=self.device)

    def _minibatch(self, size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._n, size=min(size, self._n))
        return {k: v[idx] for k, v in self._data.items()}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        m: Dict[str, Any] = {}
        for _ in range(cfg.updates_per_iter or 50):
            m = self.learner.update_minibatch(
                self._minibatch(cfg.minibatch_size))
            self.learner.params = polyak(self.learner.params, ("q1", "q2"),
                                         cfg.tau)
        return {k: float(v) for k, v in m.items()}

    def evaluate(self, num_episodes: int = 5) -> Dict[str, float]:
        """Greedy (tanh-mean) rollout in the probe env."""
        params = self.learner.get_params()
        low, high = float(self.spec.action_low), float(self.spec.action_high)

        def act(obs):
            mean, _ = pi_dist(params["pi"], obs)
            return (high + low) / 2.0 + (high - low) / 2.0 * torch.tanh(mean)

        return greedy_returns(self, act, num_episodes)
