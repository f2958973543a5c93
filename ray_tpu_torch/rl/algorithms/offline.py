"""Offline RL: BC (behavior cloning) and MARWIL (advantage-weighted BC)
(port of ``ray_tpu/rl/algorithms/offline.py``).

Reference analogs: ``rllib/algorithms/bc/`` and ``rllib/algorithms/marwil/``
(BC is MARWIL with beta=0 there too). Training consumes a fixed dataset,
a dict of arrays (obs, actions, and for MARWIL rewards/dones for
monte-carlo returns), with no environment interaction; the env is only
probed for the spec. JAX also takes a ``ray_tpu.data.Dataset`` of such
rows; the port has no Dataset yet (ROADMAP item R3) and refuses one.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import Learner


def _to_arrays(data) -> Dict[str, np.ndarray]:
    """The columns as numpy arrays; float64 ones (lists read from JSON) as
    float32, which is what JAX's device arrays hold with x64 off."""
    if isinstance(data, dict):
        arrays = {k: np.asarray(v) for k, v in data.items()}
        return {k: a.astype(np.float32) if a.dtype == np.float64 else a
                for k, a in arrays.items()}
    raise TypeError(
        f"offline_data must be a dict of arrays, got {type(data)}; JAX's "
        "ray_tpu.data.Dataset input needs the port's Dataset, which is "
        "not ported yet (ROADMAP item R3)")


def _mc_returns(rewards, dones, gamma, env_ids=None) -> np.ndarray:
    """Per-step discounted return to the end of each episode. Rows from a
    VECTORIZED rollout interleave env streams: pass ``env_ids`` (per-row
    env index) so each stream accumulates independently; without it, rows
    are assumed to be one time-ordered episode stream."""
    out = np.zeros_like(rewards, dtype=np.float64)
    if env_ids is None:
        acc = 0.0
        for i in range(len(rewards) - 1, -1, -1):
            if dones[i]:
                acc = 0.0
            acc = rewards[i] + gamma * acc
            out[i] = acc
        return out.astype(np.float32)
    accs: Dict[Any, float] = {}
    for i in range(len(rewards) - 1, -1, -1):
        e = env_ids[i]
        acc = 0.0 if dones[i] else accs.get(e, 0.0)
        acc = rewards[i] + gamma * acc
        accs[e] = acc
        out[i] = acc
    return out.astype(np.float32)


def make_marwil_loss(spec, beta: float, vf_coeff: float):
    """``loss_fn(params, batch, key)`` over a policy tree: exp(beta *
    normalized advantage)-weighted log-likelihood and a value regression
    where ``beta > 0``, plain negative log-likelihood (BC) at 0."""
    def loss_fn(params, batch, key=None):
        logits = models.policy_logits(params, batch["obs"])
        if spec.discrete:
            logp = models.categorical_logp(logits, batch["actions"])
        else:
            logp = models.gaussian_logp(logits, params["log_std"],
                                        batch["actions"])
        if beta > 0:
            values = models.value(params, batch["obs"])
            adv = batch["returns"] - values
            vf_loss = torch.mean(adv ** 2)
            a = adv.detach()
            w = torch.exp(beta * (a / (a.std(correction=0) + 1e-8)))
            w = torch.clamp(w, max=20.0)  # exp weight clamp (reference c)
            pi_loss = -torch.mean(w * logp)
            total = pi_loss + vf_coeff * vf_loss
            return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                           "weight_mean": w.mean()}
        pi_loss = -torch.mean(logp)
        return pi_loss, {"pi_loss": pi_loss}

    return loss_fn


def greedy_returns(algo, act, num_episodes: int) -> Dict[str, float]:
    """Episode returns of ``act(obs tensor) -> action tensor`` in one copy
    of the probe env (the offline algorithms' ``evaluate``)."""
    env = make_env(algo.config.env, 1, algo.config.env_config)
    returns = []
    obs = env.reset()
    ep_ret, done_count, steps = 0.0, 0, 0
    with torch.no_grad():
        while done_count < num_episodes and steps < 100_000:
            action = act(torch.as_tensor(obs, dtype=torch.float32,
                                         device=algo.device)).cpu().numpy()
            obs, reward, done = env.step(action)
            ep_ret += float(reward[0])
            steps += 1
            if done[0]:
                returns.append(ep_ret)
                ep_ret = 0.0
                done_count += 1
    return {"episode_return_mean": float(np.mean(returns or [0.0]))}


class MARWIL(Algorithm):
    """beta > 0: exp(beta * normalized advantage) weighted cloning with a
    learned value baseline; beta == 0 degenerates to plain BC."""

    need_env_runners = False
    beta_override = None  # BC subclass pins 0.0

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        cfg = AlgorithmConfig(algo_class=cls)
        cfg.num_epochs = 1
        return cfg

    def build_learner(self) -> None:
        cfg, spec = self.config, self.spec
        beta = self.beta_override if self.beta_override is not None \
            else cfg.beta
        if cfg.offline_data is None:
            raise ValueError(f"{type(self).__name__} needs config.offline_data")
        self._data = _to_arrays(cfg.offline_data)
        if beta > 0 and "returns" not in self._data:
            self._data["returns"] = _mc_returns(
                self._data["rewards"], self._data["dones"], cfg.gamma,
                env_ids=self._data.get("env_ids"))
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        params = models.init_policy(gen, spec, cfg.hidden)
        self.learner = Learner(params,
                               make_marwil_loss(spec, beta, cfg.vf_coeff),
                               cfg.lr, grad_clip=cfg.grad_clip,
                               seed=cfg.seed, device=self.device)
        self._rng = np.random.default_rng(cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = len(self._data["obs"])
        idx = self._rng.permutation(n)
        metrics: Dict[str, Any] = {}
        for _ in range(max(1, cfg.num_epochs)):
            for lo in range(0, n, cfg.minibatch_size):
                rows = idx[lo:lo + cfg.minibatch_size]
                mb = {k: v[rows] for k, v in self._data.items()}
                metrics = self.learner.update_minibatch(mb)
        self._env_steps_total += n
        out = {k: float(v) for k, v in metrics.items()}
        out["samples_this_iter"] = n
        return out

    def evaluate(self, num_episodes: int = 5) -> Dict[str, float]:
        """Greedy rollout of the cloned policy in the (probe) env."""
        params = self.learner.get_params()
        spec = self.spec

        def act(obs):
            logits = models.policy_logits(params, obs)
            if spec.discrete:
                return torch.argmax(logits, dim=-1)
            return torch.clamp(logits, spec.action_low, spec.action_high)

        return greedy_returns(self, act, num_episodes)


class BC(MARWIL):
    """Plain behavior cloning (MARWIL with beta = 0)."""

    beta_override = 0.0


class MARWILConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=MARWIL, **kwargs)
        self.num_epochs = 1


class BCConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=BC, **kwargs)
        self.num_epochs = 1
