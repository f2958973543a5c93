"""Contextual bandits: LinUCB and Linear Thompson Sampling (port of
``ray_tpu/rl/algorithms/bandits.py``).

Reference analog: ``rllib/algorithms/bandit/`` (``BanditLinUCB``,
``BanditLinTS`` — disjoint linear models per arm, trained online).
Redesigned vectorized: the per-arm ridge statistics (A = λI + Σ x xᵀ,
b = Σ r x) update in closed form from whole context batches, so one
training_step consumes a [N, d] batch instead of stepping singly.

``LinearBandit-v0`` (registered here) is the synthetic benchmark: contexts
~ N(0, I), true per-arm weights, reward = θ_aᵀx + noise — regret against
the known optimum is the convergence gate.

As in JAX, everything here is numpy on the host: the arm statistics, the
Sherman–Morrison updates and LinTS's ``multivariate_normal`` draws from
``default_rng(seed)``, so with the same seed both packages pull the same
arms and hold the same ``A_inv`` and ``b``, bit for bit. ``build(device=)``
is accepted as for every algorithm (``cuda`` unless given), and nothing
runs there.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.env import EnvSpec, VectorEnv, make_env, register_env


class LinearBanditEnv(VectorEnv):
    """One-step contextual bandit: every step is an episode."""

    def __init__(self, num_envs: int, seed: int = 0, context_dim: int = 8,
                 num_arms: int = 4, noise: float = 0.1):
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self._d, self._k, self._noise = context_dim, num_arms, noise
        # fixed hidden arm weights — the thing the learner must recover
        self.theta = np.random.default_rng(12345).standard_normal(
            (num_arms, context_dim)) / np.sqrt(context_dim)
        self.spec = EnvSpec(obs_dim=context_dim, num_actions=num_arms)
        self._ctx = self._draw()

    def _draw(self) -> np.ndarray:
        return self._rng.standard_normal(
            (self.num_envs, self._d)).astype(np.float32)

    def reset(self) -> np.ndarray:
        self._ctx = self._draw()
        return self._ctx

    def step(self, actions: np.ndarray):
        a = np.asarray(actions).reshape(self.num_envs)
        means = np.einsum("nd,nd->n", self._ctx, self.theta[a])
        rewards = (means + self._noise * self._rng.standard_normal(
            self.num_envs)).astype(np.float32)
        dones = np.ones(self.num_envs, dtype=bool)
        self._ctx = self._draw()
        return self._ctx, rewards, dones

    def best_mean_reward(self, contexts: np.ndarray) -> np.ndarray:
        return (contexts @ self.theta.T).max(axis=1)


register_env("LinearBandit-v0",
             lambda c: LinearBanditEnv(c["num_envs"], seed=c.get("seed", 0),
                                       context_dim=c.get("context_dim", 8),
                                       num_arms=c.get("num_arms", 4),
                                       noise=c.get("noise", 0.1)))


class BanditConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=None, **kwargs)
        self.env = "LinearBandit-v0"
        self.ucb_alpha = 1.0        # exploration width (LinUCB)
        self.ridge_lambda = 1.0
        self.ts_scale = 0.5         # posterior scale (LinTS)
        self.steps_per_iter = 32    # env batches per training_step


class _LinearBandit(Algorithm):
    """Shared machinery: per-arm ridge stats + pluggable arm scoring."""

    need_env_runners = False  # closed-form online updates, env in-process

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        cfg = BanditConfig()
        cfg.algo_class = cls
        return cfg

    def build_learner(self) -> None:
        cfg = self.config
        self._env = make_env(cfg.env, cfg.num_envs_per_runner,
                             cfg.env_config, seed=cfg.seed)
        spec = self._env.spec
        if not spec.discrete or spec.obs_dim <= 0:
            raise ValueError("bandits need discrete arms over flat contexts")
        d, k = spec.obs_dim, spec.num_actions
        lam = cfg.ridge_lambda
        self._A_inv = np.stack([np.eye(d) / lam for _ in range(k)])
        self._b = np.zeros((k, d))
        self._rng = np.random.default_rng(cfg.seed)
        self._obs = self._env.reset()
        self._cum_reward = 0.0
        self._cum_regret = 0.0
        self.learner = self

    # Algorithm checkpoint surface
    def get_params(self):
        return {"A_inv": self._A_inv, "b": self._b}

    def set_params(self, params) -> None:
        self._A_inv = np.asarray(params["A_inv"])
        self._b = np.asarray(params["b"])

    def _select_arms(self, ctx: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _theta_hat(self) -> np.ndarray:
        return np.einsum("kde,ke->kd", self._A_inv, self._b)

    def _update(self, ctx: np.ndarray, arms: np.ndarray,
                rewards: np.ndarray) -> None:
        """Sherman–Morrison per-row A⁻¹ update + b accumulation."""
        for x, a, r in zip(ctx, arms, rewards):
            Ai = self._A_inv[a]
            Ax = Ai @ x
            self._A_inv[a] = Ai - np.outer(Ax, Ax) / (1.0 + x @ Ax)
            self._b[a] += r * x

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Greedy (exploitation-only) pulls with the fitted arm models;
        one 'episode' = one vectorized env batch."""
        theta = self._theta_hat()
        total, n = 0.0, 0
        obs = self._obs
        for _ in range(num_episodes):
            arms = np.argmax(obs @ theta.T, axis=-1)
            obs, r, _ = self._env.step(arms)
            total += float(np.sum(r))
            n += len(r)
        self._obs = obs
        return {"episodes": num_episodes,
                "episode_return_mean": total / max(1, n)}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        regret_known = hasattr(self._env, "best_mean_reward")
        total_r, n = 0.0, 0
        for _ in range(cfg.steps_per_iter):
            ctx = self._obs
            arms = self._select_arms(ctx)
            if regret_known:
                best = self._env.best_mean_reward(ctx)
                chosen = np.einsum("nd,nd->n", ctx, self._env.theta[arms])
                self._cum_regret += float((best - chosen).sum())
            self._obs, rewards, _ = self._env.step(arms)
            self._update(ctx, arms, rewards)
            total_r += float(rewards.sum())
            n += len(rewards)
        self._env_steps_total += n
        self._cum_reward += total_r
        out = {"mean_reward": total_r / n,
               "cumulative_reward": self._cum_reward}
        if regret_known:
            out["cumulative_regret"] = self._cum_regret
            out["regret_per_step"] = self._cum_regret / max(
                1, self._env_steps_total)
        return out


class BanditLinUCB(_LinearBandit):
    """Disjoint LinUCB (Li et al. 2010): arm = argmax θ̂ᵀx + α√(xᵀA⁻¹x)."""

    def _select_arms(self, ctx: np.ndarray) -> np.ndarray:
        theta = self._theta_hat()                      # [k, d]
        means = ctx @ theta.T                          # [n, k]
        # width[n,k] = sqrt(x A_k^-1 x)
        widths = np.sqrt(np.maximum(
            np.einsum("nd,kde,ne->nk", ctx, self._A_inv, ctx), 0.0))
        return np.argmax(means + self.config.ucb_alpha * widths, axis=1)


class BanditLinTS(_LinearBandit):
    """Linear Thompson sampling: θ̃_k ~ N(θ̂_k, v² A_k⁻¹), arm = argmax
    θ̃ᵀx."""

    def _select_arms(self, ctx: np.ndarray) -> np.ndarray:
        theta = self._theta_hat()
        k, d = theta.shape
        sampled = np.empty_like(theta)
        for a in range(k):
            cov = self.config.ts_scale ** 2 * self._A_inv[a]
            sampled[a] = self._rng.multivariate_normal(theta[a], cov)
        return np.argmax(ctx @ sampled.T, axis=1)
