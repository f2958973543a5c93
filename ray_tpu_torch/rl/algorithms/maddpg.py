"""MADDPG: multi-agent DDPG with centralized critics (port of
``ray_tpu/rl/algorithms/maddpg.py``).

Reference analog: ``rllib/algorithms/maddpg/maddpg.py`` (Lowe et al.
2017). Decentralized actors ``mu_i(o_i)`` act from local observations;
per-agent CENTRALIZED critics ``Q_i(o_1..o_n, a_1..a_n)`` see every
agent's observation and action during training (centralized training,
decentralized execution). Off-policy on a shared transition replay with
polyak target networks; exploration is decaying gaussian action noise
drawn on the host.

Runs in-process on the ``MultiAgentEnv`` protocol (rl/multi_agent.py) —
its home setting is the continuous particle env ``"spread"``. All
per-agent losses sum into ONE update: each term only touches its own
agent's parameters. In an actor term the critic's parameters are
detached copies (JAX's ``stop_gradient`` of the critic's leaves), so the
actor's gradient flows through the action input alone — the MADDPG
policy gradient. The polyak step makes new target tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import DeviceTrainable
from ray_tpu_torch.rl.algorithms.ddpg import detach_tree
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.evaluation import ReturnWindow, run_episodes
from ray_tpu_torch.rl.learner import Learner, mean_metrics
from ray_tpu_torch.rl.multi_agent import MultiAgentEnv, make_multi_agent_env
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer


class MADDPGConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=MADDPG, **kwargs)
        self.env = "spread"
        self.lr = 1e-3
        self.minibatch_size = 256
        self.buffer_size = 100_000
        self.learning_starts = 1_000
        self.updates_per_iter = 32
        self.exploration_noise = 0.3
        self.noise_final = 0.05
        self.noise_decay_steps = 20_000
        self.hidden = (64, 64)


def make_maddpg_fns(n: int, low: float, high: float, gamma: float):
    """(act_of, loss_fn): ``act_of(actor, obs)`` squashes an actor's
    output into [low, high]; ``loss_fn(params, batch, gen)`` sums every
    agent's critic and actor terms over ``{actors, critics, actors_t,
    critics_t}``."""
    mid, span = (high + low) / 2.0, (high - low) / 2.0

    def act_of(actor_p, obs):
        return mid + span * torch.tanh(models.mlp_forward(actor_p, obs))

    def q_of(critic_p, obs_flat, acts_flat):
        x = torch.cat([obs_flat, acts_flat], dim=-1)
        return models.mlp_forward(critic_p, x)[..., 0]

    def loss_fn(p, batch, gen=None):
        obs = batch["obs"]              # [B, n, do]
        acts = batch["actions"]         # [B, n, da]
        nobs = batch["next_obs"]
        B = obs.shape[0]
        obs_flat = obs.reshape(B, -1)
        acts_flat = acts.reshape(B, -1)
        nobs_flat = nobs.reshape(B, -1)
        nonterm = 1.0 - batch["dones"].float()
        with torch.no_grad():   # target joint action from TARGET actors
            nacts_flat = torch.cat(
                [act_of(p["actors_t"][j], nobs[:, j]) for j in range(n)],
                dim=-1)
        total = 0.0
        metrics: Dict[str, Any] = {}
        q_means = []
        for i in range(n):
            with torch.no_grad():   # JAX's stop_gradient of the target
                qt = q_of(p["critics_t"][i], nobs_flat, nacts_flat)
                y = batch["rewards"][:, i] + gamma * nonterm * qt
            q_pred = q_of(p["critics"][i], obs_flat, acts_flat)
            critic_loss = torch.mean((q_pred - y) ** 2)
            # actor i: replace column i with mu_i(o_i); the critic's
            # leaves are detached so only the action path carries grads
            a_i = act_of(p["actors"][i], obs[:, i])
            joint = torch.cat(
                [a_i if j == i else acts[:, j] for j in range(n)], dim=-1)
            actor_loss = -torch.mean(q_of(detach_tree(p["critics"][i]),
                                          obs_flat, joint))
            total = total + critic_loss + actor_loss
            metrics[f"critic_loss_{i}"] = critic_loss
            metrics[f"actor_loss_{i}"] = actor_loss
            q_means.append(q_pred.mean())
        metrics["q_mean"] = torch.mean(torch.stack(q_means))
        return total, metrics

    return act_of, loss_fn


@torch.no_grad()
def polyak(p: Dict, tau: float) -> Dict:
    """``p`` with ``actors_t``/``critics_t`` moved to ``(1 - tau) * target
    + tau * online`` as new tensors (JAX's jitted polyak)."""
    new = dict(p)
    for src, dst in (("actors", "actors_t"), ("critics", "critics_t")):
        new[dst] = models.tree_map(lambda t, s: (1 - tau) * t + tau * s,
                                   p[dst], p[src])
    return new


class MADDPG(DeviceTrainable):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return MADDPGConfig()

    def setup(self, config: Dict[str, Any]) -> None:
        self.config = self.config_from(config)
        cfg = self.config
        self.env: MultiAgentEnv = make_multi_agent_env(cfg)
        self.agents = list(self.env.agents)
        n = len(self.agents)
        specs = [self.env.spec[a] for a in self.agents]
        if any(s.discrete for s in specs):
            raise ValueError("MADDPG requires continuous actions (use "
                             "QMIX/IPPO for discrete cooperative games)")
        if len({(s.obs_dim, s.action_dim) for s in specs}) != 1:
            raise ValueError("MADDPG here assumes homogeneous per-agent "
                             "obs/action dims")
        spec = specs[0]
        do, da = spec.obs_dim, spec.action_dim
        low, high = spec.action_low, spec.action_high
        qin = n * (do + da)
        gen = self.generator(cfg.seed)
        actors = [models.init_mlp(gen, (do, *cfg.hidden, da), out_scale=0.01)
                  for _ in range(n)]
        critics = [models.init_mlp(gen, (qin, *cfg.hidden, 1), out_scale=1.0)
                   for _ in range(n)]
        params = {"actors": actors, "critics": critics,
                  "actors_t": models.clone_tree(actors),
                  "critics_t": models.clone_tree(critics)}
        self._act_of, loss_fn = make_maddpg_fns(n, low, high, cfg.gamma)
        self.learner = Learner(params, loss_fn, cfg.lr,
                               grad_clip=cfg.grad_clip, seed=cfg.seed,
                               device=self.device)
        self._n, self._do, self._da = n, do, da
        self._low, self._high = low, high
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._rng = np.random.default_rng(cfg.seed)
        self._obs = self.env.reset()
        self._env_steps_total = 0
        self._returns = ReturnWindow(self.env.num_envs)

    # -- rollout ----------------------------------------------------------

    def _stack_obs(self, obs: Dict[str, np.ndarray]) -> np.ndarray:
        return np.stack([obs[a] for a in self.agents],
                        axis=1).astype(np.float32)

    @torch.no_grad()
    def _act_all(self, actors, stacked: np.ndarray) -> np.ndarray:
        """Every agent's deterministic action [N, n, da], one read."""
        obs = torch.as_tensor(stacked, device=self.device)
        return torch.stack([self._act_of(actors[j], obs[:, j])
                            for j in range(self._n)], dim=1).cpu().numpy()

    @property
    def _noise(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps_total
                   / max(1, cfg.noise_decay_steps))
        return cfg.exploration_noise \
            + frac * (cfg.noise_final - cfg.exploration_noise)

    def _collect(self, steps: int) -> float:
        n_envs = self.env.num_envs
        reward_sum = 0.0
        for _ in range(steps):
            stacked = self._stack_obs(self._obs)
            acts = self._act_all(self.learner.get_params()["actors"],
                                 stacked)
            acts = np.clip(
                acts + self._noise
                * self._rng.standard_normal(acts.shape).astype(np.float32),
                self._low, self._high)
            act_dict = {a: acts[:, i] for i, a in enumerate(self.agents)}
            next_obs, rewards, dones = self.env.step(act_dict)
            rew = np.stack([rewards[a] for a in self.agents],
                           axis=1).astype(np.float32)   # [N, n]
            self.buffer.add_batch(
                {"obs": stacked, "actions": acts.astype(np.float32),
                 "rewards": rew, "dones": dones.astype(np.float32),
                 "next_obs": self._stack_obs(next_obs)})
            self._env_steps_total += n_envs
            team_r = rew.mean(axis=1)
            reward_sum += float(team_r.sum())
            self._returns.add(team_r, dones)
            self._obs = next_obs
        return reward_sum / max(1, steps * n_envs)

    def _update_targets(self) -> None:
        self.learner.params = polyak(self.learner.params, self.config.tau)

    # -- Trainable API ----------------------------------------------------

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        mean_step_r = self._collect(cfg.rollout_fragment_length)
        metrics: Dict[str, Any] = {"reward_mean_per_step": mean_step_r,
                                   "noise": self._noise}
        if len(self.buffer) >= cfg.learning_starts:
            mlist = []
            for _ in range(cfg.updates_per_iter or 1):
                mb = self.buffer.sample(cfg.minibatch_size)
                mlist.append(self.learner.update_minibatch(mb))
                self._update_targets()
            metrics.update(mean_metrics(mlist))
        metrics["env_steps_total"] = self._env_steps_total
        mean_ret = self._returns.mean()
        if mean_ret is not None:
            metrics["episode_return_mean"] = mean_ret
        return metrics

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Noise-free episodes on a fresh env instance."""
        env = make_multi_agent_env(self.config)
        state = {"obs": env.reset()}
        actors = self.learner.get_params()["actors"]

        def step():
            acts = self._act_all(actors, self._stack_obs(state["obs"]))
            act_dict = {a: acts[:, i] for i, a in enumerate(self.agents)}
            state["obs"], rewards, dones = env.step(act_dict)
            return np.mean([rewards[a] for a in self.agents], axis=0), dones

        return run_episodes(step, num_episodes, env.num_envs)

    def get_params(self):
        return self.learner.get_params()

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        return {"params": params_to_numpy(self.learner.get_params()),
                "env_steps_total": self._env_steps_total}

    def load_checkpoint(self, checkpoint: Dict) -> None:
        self.learner.set_params(checkpoint["params"])
        self._env_steps_total = checkpoint.get("env_steps_total", 0)
