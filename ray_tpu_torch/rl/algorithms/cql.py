"""CQL: conservative Q-learning for offline RL (port of
``ray_tpu/rl/algorithms/cql.py``).

Reference analog: ``rllib/algorithms/cql/cql.py`` (CQL(H) on top of SAC:
the soft actor-critic update plus a conservative penalty that pushes Q
down on out-of-distribution actions and up on dataset actions, Kumar et
al. 2020). The SAC loss terms plus

    alpha_cql * ( logsumexp_a Q(s, a~) - Q(s, a_data) )

with a~ drawn from uniform-random and current-policy actions
(importance-corrected), all in one update over offline minibatches; no
env interaction. The four noise draws go through ``models.normal`` and
``models.uniform`` in JAX's order.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.algorithms.ddpg import detach_tree, polyak, q_value
from ray_tpu_torch.rl.algorithms.offline import _to_arrays
from ray_tpu_torch.rl.algorithms.sac import (_squashed_sample_logp,
                                             init_soft_actor_critic, pi_dist)
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import Learner

TRANSITION_COLUMNS = ("obs", "actions", "rewards", "next_obs", "dones")


class CQLConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=CQL, **kwargs)
        self.env = "Pendulum-v1"
        self.minibatch_size = 256
        self.cql_alpha = 5.0
        self.cql_num_actions = 8   # sampled actions for the logsumexp
        self.updates_per_iter = 50


def offline_transitions(cfg: AlgorithmConfig, name: str):
    """``cfg.offline_data`` as arrays, refused without the transition
    columns."""
    if cfg.offline_data is None:
        raise ValueError(f"{name} needs config.offline_data")
    data = _to_arrays(cfg.offline_data)
    for col in TRANSITION_COLUMNS:
        if col not in data:
            raise ValueError(f"offline_data missing {col!r}")
    return data


def _q_on_sampled(q_params, obs, acts):
    """Q over [S, B, A] sampled actions -> [S, B]."""
    rep = obs.expand((acts.shape[0],) + tuple(obs.shape))
    return q_value(q_params, rep, acts)


def make_cql_loss(spec, cfg: AlgorithmConfig):
    """``loss_fn(params, batch, gen) -> (total, {"bellman_loss",
    "cql_penalty", "pi_loss", "alpha"})``."""
    gamma = cfg.gamma
    low, high = float(spec.action_low), float(spec.action_high)
    adim = spec.action_dim
    n_samp, cql_alpha = cfg.cql_num_actions, cfg.cql_alpha

    def loss_fn(params, batch, gen=None):
        obs, nobs = batch["obs"], batch["next_obs"]
        acts = batch["actions"]
        B = obs.shape[0]
        alpha = torch.exp(params["log_alpha"])
        # --- SAC critic target (soft bellman backup) ---
        with torch.no_grad():
            nmean, nlogstd = pi_dist(params["pi"], nobs)
            nact, nlogp = _squashed_sample_logp(nmean, nlogstd, gen,
                                                low, high)
            qt = torch.minimum(q_value(params["q1_target"], nobs, nact),
                               q_value(params["q2_target"], nobs, nact))
            nonterminal = 1.0 - batch["dones"].float()
            target = batch["rewards"] + gamma * nonterminal \
                * (qt - alpha * nlogp)
        q1_pred = q_value(params["q1"], obs, acts)
        q2_pred = q_value(params["q2"], obs, acts)
        bellman = torch.mean((q1_pred - target) ** 2) + \
            torch.mean((q2_pred - target) ** 2)
        # --- conservative penalty (CQL(H)) ---
        rand = models.uniform(gen, (n_samp, B, adim), low, high)
        mean, log_std = pi_dist(params["pi"], obs)
        pol, pol_logp = _squashed_sample_logp(
            mean.expand((n_samp,) + tuple(mean.shape)),
            log_std.expand((n_samp,) + tuple(log_std.shape)),
            gen, low, high)
        rand_logp = -adim * math.log(high - low)  # uniform density
        cql_terms = []
        for qp, pred in (("q1", q1_pred), ("q2", q2_pred)):
            q_rand = _q_on_sampled(params[qp], obs, rand) - rand_logp
            q_pol = _q_on_sampled(params[qp], obs, pol) - pol_logp.detach()
            cat = torch.cat([q_rand, q_pol], dim=0)          # [2S, B]
            lse = torch.logsumexp(cat, dim=0) - math.log(2 * n_samp)
            cql_terms.append(torch.mean(lse - pred))
        cql_penalty = cql_terms[0] + cql_terms[1]
        # --- actor (SAC) ---
        act_new, logp = _squashed_sample_logp(mean, log_std, gen, low, high)
        q_min = torch.minimum(
            q_value(detach_tree(params["q1"]), obs, act_new),
            q_value(detach_tree(params["q2"]), obs, act_new))
        pi_loss = torch.mean(alpha.detach() * logp - q_min)
        alpha_loss = -torch.mean(params["log_alpha"]
                                 * (logp - adim).detach())
        total = bellman + cql_alpha * cql_penalty + pi_loss + alpha_loss
        return total, {"bellman_loss": bellman, "cql_penalty": cql_penalty,
                       "pi_loss": pi_loss, "alpha": alpha.detach()}

    return loss_fn


class CQL(Algorithm):
    need_env_runners = False  # offline: the dataset IS the experience

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return CQLConfig()

    def build_learner(self) -> None:
        cfg = self.config
        self._data = offline_transitions(cfg, "CQL")
        self._n = len(self._data["rewards"])
        self._rng = np.random.default_rng(cfg.seed)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.learner = Learner(init_soft_actor_critic(gen, self.spec, cfg),
                               make_cql_loss(self.spec, cfg), cfg.lr,
                               grad_clip=cfg.grad_clip, seed=cfg.seed,
                               device=self.device)

    @torch.no_grad()
    def q_value(self, obs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        """Q1 estimates: the OOD-vs-dataset probe."""
        dev = self.device
        return q_value(self.learner.get_params()["q1"],
                       torch.as_tensor(obs, dtype=torch.float32, device=dev),
                       torch.as_tensor(actions, dtype=torch.float32,
                                       device=dev)).cpu().numpy()

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
