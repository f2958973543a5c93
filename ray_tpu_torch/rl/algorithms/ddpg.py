"""DDPG and TD3: deterministic policy gradients for continuous control
(port of ``ray_tpu/rl/algorithms/ddpg.py``).

Reference analogs: ``rllib/algorithms/ddpg/`` and ``rllib/algorithms/td3/``.
One implementation: TD3 = DDPG + twin critics + delayed policy updates +
target-policy smoothing; DDPG is the ``twin_q=False, policy_delay=1,
target_noise=0`` corner. The critic and actor losses are one update, the
actor's term gated by the batch's ``do_actor``; the polyak step makes new
target tensors under ``no_grad``, never aliasing the online nets.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.algorithms.dqn import make_buffer, replay_minibatch
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import Learner


def detach_tree(tree):
    """JAX's ``stop_gradient`` over a params tree."""
    return models.tree_map(torch.Tensor.detach, tree)


def q_value(q_params, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """A critic's Q(s, a): the MLP over [obs, action], its one output."""
    return models.mlp_forward(q_params, torch.cat([obs, act], dim=-1))[..., 0]


@torch.no_grad()
def polyak(params: Dict, names, tau: float) -> Dict:
    """``params`` with each ``<name>_target`` moved to ``(1 - tau) *
    target + tau * online`` as new tensors (JAX's jitted polyak)."""
    new = dict(params)
    for name in names:
        new[f"{name}_target"] = models.tree_map(
            lambda t, s: (1 - tau) * t + tau * s,
            params[f"{name}_target"], params[name])
    return new


def init_critic(gen: torch.Generator, spec, hidden) -> Dict:
    return models.init_mlp(
        gen, [spec.obs_dim + spec.action_dim, *hidden, 1], out_scale=1.0)


def make_ddpg_loss(spec, cfg: AlgorithmConfig, twin: bool):
    """``loss_fn(params, batch, gen) -> (critic + do_actor * actor,
    {"q_loss", "td", "pi_loss"})`` over ``{pi, q1[, q2], *_target}``; TD3's
    smoothing noise (``target_noise > 0``) is one ``models.normal`` draw
    of the next actions' shape."""
    gamma = cfg.gamma
    low, high = float(spec.action_low), float(spec.action_high)
    target_noise, noise_clip = cfg.target_noise, cfg.noise_clip

    def act(pi_params, obs):
        mid = (high + low) / 2.0
        half = (high - low) / 2.0
        return mid + half * torch.tanh(models.mlp_forward(pi_params, obs))

    def critic_loss_fn(params, batch, gen):
        obs, nobs, acts = batch["obs"], batch["next_obs"], batch["actions"]
        with torch.no_grad():   # the bootstrap target: JAX's stop_gradient
            na = act(params["pi_target"], nobs)
            if target_noise > 0:  # TD3 target policy smoothing
                noise = torch.clamp(
                    target_noise * models.normal(gen, na.shape),
                    -noise_clip, noise_clip) * (high - low) / 2.0
                na = torch.clamp(na + noise, low, high)
            qt = q_value(params["q1_target"], nobs, na)
            if twin:
                qt = torch.minimum(qt, q_value(params["q2_target"], nobs, na))
            nonterm = 1.0 - batch["dones"].float()
            target = batch["rewards"] + gamma * nonterm * qt
        td = q_value(params["q1"], obs, acts) - target
        weights = batch.get("weights")
        w = torch.ones_like(td) if weights is None else weights
        loss = torch.mean(w * td ** 2)
        if twin:
            loss = loss + torch.mean(
                w * (q_value(params["q2"], obs, acts) - target) ** 2)
        return loss, {"q_loss": loss, "td": td.detach()}

    def actor_loss_fn(params, batch):
        obs = batch["obs"]
        a = act(params["pi"], obs)
        loss = -torch.mean(q_value(detach_tree(params["q1"]), obs, a))
        return loss, {"pi_loss": loss}

    def loss_fn(params, batch, gen=None):
        cl, cm = critic_loss_fn(params, batch, gen)
        al, am = actor_loss_fn(params, batch)
        total = cl + batch["do_actor"][0] * al
        return total, {**cm, **am}

    return loss_fn


class DDPG(Algorithm):
    twin_q = False

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        cfg = AlgorithmConfig(algo_class=cls)
        cfg.env = "Pendulum-v1"
        cfg.lr = 1e-3
        cfg.minibatch_size = 256
        cfg.learning_starts = 1_000
        if cls is DDPG:
            cfg.policy_delay = 1
            cfg.target_noise = 0.0
        return cfg

    def build_learner(self) -> None:
        cfg, spec = self.config, self.spec
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        params = {
            "pi": models.init_mlp(
                gen, [spec.obs_dim, *cfg.hidden, spec.action_dim],
                out_scale=0.01),
            "q1": init_critic(gen, spec, cfg.hidden),
        }
        if self.twin_q:
            params["q2"] = init_critic(gen, spec, cfg.hidden)
        self._online = tuple(params)
        for name in self._online:
            params[f"{name}_target"] = models.clone_tree(params[name])
        self.learner = Learner(params, make_ddpg_loss(spec, cfg, self.twin_q),
                               cfg.lr, grad_clip=cfg.grad_clip,
                               seed=cfg.seed, device=self.device)
        self.buffer = make_buffer(cfg)   # prioritized: the Ape-X DDPG path
        self._updates = 0

    def _runner_params(self, sigma: float = None):
        """Runner protocol adapter: the pi-net's raw output as the mean and
        Gaussian exploration noise through ``log_std``. ``sigma``
        overrides the config's exploration noise (Ape-X DDPG's per-runner
        noise ladder)."""
        p = self.learner.get_params()
        obs_dim, adim = self.spec.obs_dim, self.spec.action_dim
        dev = self.device
        vf = {"layers": [{"w": torch.zeros((obs_dim, 1), device=dev),
                          "b": torch.zeros(1, device=dev)}]}
        if sigma is None:
            sigma = self.config.exploration_noise
        sigma = max(sigma, 1e-3)
        return {"pi": p["pi"], "vf": vf,
                "log_std": torch.full((adim,), float(np.log(sigma)),
                                      device=dev)}

    def _eval_params(self):
        """Deterministic actor (exploration noise ~0) for evaluate."""
        return {**self._runner_params(),
                "log_std": torch.full((self.spec.action_dim,), -20.0,
                                      device=self.device)}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        batch = self.synchronous_sample(self._runner_params())
        self.buffer.add_batch(
            {"obs": batch["obs"], "actions": batch["actions_executed"],
             "rewards": batch["rewards"], "next_obs": batch["next_obs"],
             "dones": batch["dones"]})
        metrics: Dict[str, Any] = {"buffer_size": len(self.buffer)}
        if len(self.buffer) >= cfg.learning_starts:
            num_updates = (cfg.updates_per_iter or
                           max(1, len(batch["rewards"]) // cfg.minibatch_size))
            metrics.update(self._replay_updates(num_updates))
        metrics.update(self.collect_episode_stats())
        return metrics

    def _replay_updates(self, num_updates: int) -> Dict[str, float]:
        """The DDPG-family update loop (also Ape-X DDPG): uniform or
        prioritized minibatches, the actor's term and the polyak step on
        every ``policy_delay``-th update, priorities refreshed from the
        critic's TD error. Returns the last update's scalar metrics."""
        cfg = self.config
        m: Dict[str, Any] = {}
        for _ in range(num_updates):
            mb, idx = replay_minibatch(self.buffer, cfg)
            self._updates += 1
            do_actor = float(self._updates % max(1, cfg.policy_delay) == 0)
            mb["do_actor"] = np.full(1, do_actor, dtype=np.float32)
            m = self.learner.update_minibatch(mb)
            if idx is not None:
                self.buffer.update_priorities(idx, m["td"].cpu().numpy())
            if do_actor:
                self.learner.params = polyak(self.learner.params,
                                             self._online, cfg.tau)
        return {k: float(v) for k, v in m.items() if v.dim() == 0}


class TD3(DDPG):
    """Twin critics + delayed policy updates + target smoothing."""

    twin_q = True


class DDPGConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=DDPG, **kwargs)
        self.env = "Pendulum-v1"
        self.minibatch_size = 256
        self.policy_delay = 1
        self.target_noise = 0.0


class TD3Config(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=TD3, **kwargs)
        self.env = "Pendulum-v1"
        self.minibatch_size = 256
