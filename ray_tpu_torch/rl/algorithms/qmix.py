"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing
(port of ``ray_tpu/rl/algorithms/qmix.py``).

Reference analog: ``rllib/algorithms/qmix/`` (Rashid et al. 2018). Each
agent has a utility network Q_a(obs_a, ·) (one weight-shared MLP with an
agent-id one-hot appended to the observation — the standard parameter
sharing); a mixing network combines the chosen utilities into Q_tot under
a monotonicity constraint: the mixer's weights are produced by
hypernetworks of the global state and passed through ``abs``, so
dQ_tot/dQ_a >= 0 and the per-agent argmax equals the joint argmax.

Runs in-process on the ``MultiAgentEnv`` protocol (rl/multi_agent.py),
with transition replay, epsilon-greedy exploration on the host, and
periodically synced target networks. The target nets live in the
learner's params tree; the loss builds their bootstrap under ``no_grad``,
so their gradients are zero and Adam leaves them unchanged until a sync
copies the online nets into new tensors. Heterogeneous action spaces pad
every agent to the largest: invalid slots get -inf, which the TD target's
max and the greedy argmax never pick and no backward multiplies.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import DeviceTrainable
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.evaluation import ReturnWindow, run_episodes
from ray_tpu_torch.rl.learner import Learner, mean_metrics
from ray_tpu_torch.rl.multi_agent import MultiAgentEnv, make_multi_agent_env


class QMIXConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=QMIX, **kwargs)
        self.env = "coordination"
        self.lr = 5e-4
        self.minibatch_size = 64
        self.buffer_size = 50_000
        self.learning_starts = 500
        self.target_update_freq = 200    # in gradient updates
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 5_000
        self.mixing_embed_dim = 32
        self.updates_per_iter = 32


def _init_mixer(gen: torch.Generator, n_agents: int, state_dim: int,
                embed: int) -> Dict:
    """Hypernetworks state -> mixer weights (abs applied in the forward
    pass, not here): w1 [state,n*embed], b1 [state,embed], w2 [state,embed],
    and a 2-layer value head for the final bias."""
    return {
        "hw1": models.init_mlp(gen, (state_dim, n_agents * embed),
                               out_scale=0.1),
        "hb1": models.init_mlp(gen, (state_dim, embed), out_scale=0.1),
        "hw2": models.init_mlp(gen, (state_dim, embed), out_scale=0.1),
        "hb2": models.init_mlp(gen, (state_dim, embed, 1), out_scale=0.1),
    }


def _mix(mixer: Dict, qs: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """qs [B, n_agents], state [B, state_dim] -> Q_tot [B]."""
    b, n = qs.shape
    w1 = torch.abs(models.mlp_forward(mixer["hw1"], state))   # [B, n*e]
    e = w1.shape[-1] // n
    w1 = w1.reshape(b, n, e)
    b1 = models.mlp_forward(mixer["hb1"], state)              # [B, e]
    hidden = F.elu(torch.einsum("bn,bne->be", qs, w1) + b1)
    w2 = torch.abs(models.mlp_forward(mixer["hw2"], state))   # [B, e]
    b2 = models.mlp_forward(mixer["hb2"], state)[..., 0]      # [B]
    return torch.sum(hidden * w2, dim=-1) + b2


def make_agent_qs(n: int, action_mask: np.ndarray, device):
    """``agent_qs(net, obs [B, n, max_obs]) -> [B, n, A]``: the shared
    agent net over obs ++ agent one-hot, invalid slots -inf. The constants
    live on ``device`` and follow ``obs`` to another one."""
    eye = torch.eye(n, dtype=torch.float32, device=device)
    mask = torch.as_tensor(action_mask, device=device)

    def agent_qs(net, obs):
        ids = eye.to(obs.device).expand(obs.shape[0], n, n)
        x = torch.cat([obs, ids], dim=-1)
        return models.mlp_forward(net, x) + mask.to(obs.device)

    return agent_qs


def make_qmix_loss(agent_qs, gamma: float):
    """``loss_fn(params, batch, gen) -> (mean TD^2, {"td_abs_mean",
    "q_tot_mean"})`` over ``{agent, mixer, target_agent,
    target_mixer}``."""
    def loss_fn(p, batch, gen=None):
        q = agent_qs(p["agent"], batch["obs"])               # [B, n, A]
        q_taken = torch.gather(
            q, -1, batch["actions"].long()[..., None])[..., 0]  # [B, n]
        q_tot = _mix(p["mixer"], q_taken, batch["state"])
        with torch.no_grad():   # the bootstrap: JAX's stop_gradient
            q_next = agent_qs(p["target_agent"], batch["next_obs"])
            q_next_max = torch.max(q_next, dim=-1).values     # [B, n]
            q_tot_next = _mix(p["target_mixer"], q_next_max,
                              batch["next_state"])
            nonterminal = 1.0 - batch["dones"].float()
            target = batch["rewards"] + gamma * nonterminal * q_tot_next
        td = q_tot - target
        loss = torch.mean(td ** 2)
        return loss, {"td_abs_mean": torch.mean(torch.abs(td)),
                      "q_tot_mean": torch.mean(q_tot)}

    return loss_fn


class QMIX(DeviceTrainable):
    """Centralized-training / decentralized-execution cooperative MARL."""

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return QMIXConfig()

    def setup(self, config: Dict[str, Any]) -> None:
        self.config = self.config_from(config)
        cfg = self.config
        self.env: MultiAgentEnv = make_multi_agent_env(cfg)
        self.agents = list(self.env.agents)
        n = len(self.agents)
        specs = [self.env.spec[a] for a in self.agents]
        if any(not s.discrete for s in specs):
            raise ValueError("QMIX requires discrete actions")
        # shared agent net over (obs ++ agent one-hot); pad obs to the max
        # dim so heterogeneous agents share one tower
        self._obs_dims = [s.obs_dim for s in specs]
        self._max_obs = max(self._obs_dims)
        self._agent_actions = [s.num_actions for s in specs]
        self._num_actions = max(self._agent_actions)
        mask = np.zeros((n, self._num_actions), dtype=np.float32)
        for i, a_n in enumerate(self._agent_actions):
            mask[i, a_n:] = -np.inf
        self._action_mask = mask
        self._state_dim = sum(self._obs_dims)
        in_dim = self._max_obs + n
        gen = self.generator(cfg.seed)
        agent_net = models.init_mlp(
            gen, (in_dim,) + tuple(cfg.hidden) + (self._num_actions,))
        mixer = _init_mixer(gen, n, self._state_dim, cfg.mixing_embed_dim)
        params = {"agent": agent_net, "mixer": mixer,
                  "target_agent": models.clone_tree(agent_net),
                  "target_mixer": models.clone_tree(mixer)}
        self._agent_qs = make_agent_qs(n, mask, self.device)
        self.learner = Learner(params, make_qmix_loss(self._agent_qs,
                                                      cfg.gamma),
                               cfg.lr, grad_clip=cfg.grad_clip,
                               seed=cfg.seed, device=self.device)
        # replay storage (flat transitions across the vector envs)
        self._buf: Dict[str, List[np.ndarray]] = \
            {k: [] for k in ("obs", "actions", "rewards", "dones",
                             "state", "next_obs", "next_state")}
        self._buf_len = 0
        self._rng = np.random.default_rng(cfg.seed)
        self._obs = self.env.reset()
        self._env_steps_total = 0
        self._grad_updates = 0
        self._returns = ReturnWindow(self.env.num_envs)

    # -- rollout ----------------------------------------------------------

    def _stack_obs(self, obs: Dict[str, np.ndarray]) -> np.ndarray:
        """dict -> [N, n_agents, max_obs] (zero-padded)."""
        n_envs = self.env.num_envs
        out = np.zeros((n_envs, len(self.agents), self._max_obs),
                       dtype=np.float32)
        for i, a in enumerate(self.agents):
            out[:, i, :self._obs_dims[i]] = obs[a]
        return out

    def _state_of(self, obs: Dict[str, np.ndarray]) -> np.ndarray:
        return np.concatenate([obs[a] for a in self.agents],
                              axis=-1).astype(np.float32)

    @torch.no_grad()
    def _greedy(self, net, stacked: np.ndarray) -> np.ndarray:
        """Per-agent argmax [N, n] of the agent net, one read."""
        q = self._agent_qs(net, torch.as_tensor(stacked, device=self.device))
        return torch.argmax(q, dim=-1).cpu().numpy()

    @property
    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps_total
                   / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial \
            + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    def _collect(self, steps: int) -> float:
        cfg = self.config
        n_envs = self.env.num_envs
        reward_sum = 0.0
        for _ in range(steps):
            stacked = self._stack_obs(self._obs)
            greedy = self._greedy(self.learner.get_params()["agent"],
                                  stacked)                  # [N, n]
            eps_mask = self._rng.random(greedy.shape) < self._epsilon
            rand = np.stack([self._rng.integers(0, a_n, n_envs)
                             for a_n in self._agent_actions], axis=1)
            chosen = np.where(eps_mask, rand, greedy)
            acts = {a: chosen[:, i].astype(np.int64)
                    for i, a in enumerate(self.agents)}
            next_obs, rewards, dones = self.env.step(acts)
            team_r = np.mean([rewards[a] for a in self.agents],
                             axis=0).astype(np.float32)
            self._buf["obs"].append(stacked)
            self._buf["actions"].append(chosen.astype(np.int64))
            self._buf["rewards"].append(team_r)
            self._buf["dones"].append(dones.astype(np.float32))
            self._buf["state"].append(self._state_of(self._obs))
            self._buf["next_obs"].append(self._stack_obs(next_obs))
            self._buf["next_state"].append(self._state_of(next_obs))
            self._buf_len += n_envs
            self._env_steps_total += n_envs
            reward_sum += float(team_r.sum())
            self._returns.add(team_r, dones)
            self._obs = next_obs
            # bound the buffer
            max_rows = max(1, cfg.buffer_size // n_envs)
            for key in self._buf:
                if len(self._buf[key]) > max_rows:
                    del self._buf[key][:len(self._buf[key]) - max_rows]
            self._buf_len = min(self._buf_len, max_rows * n_envs)
        return reward_sum / max(1, steps * n_envs)

    def _sample_batch(self, arrays: Dict[str, np.ndarray],
                      size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, len(arrays["rewards"]), size)
        return {k: v[idx] for k, v in arrays.items()}

    def _sync_targets(self) -> None:
        """Copy the online nets into new target tensors."""
        p = dict(self.learner.get_params())
        p["target_agent"] = models.clone_tree(p["agent"])
        p["target_mixer"] = models.clone_tree(p["mixer"])
        self.learner.set_params(p)

    # -- Trainable API ----------------------------------------------------

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        mean_step_r = self._collect(cfg.rollout_fragment_length)
        metrics: Dict[str, Any] = {"reward_mean_per_step": mean_step_r,
                                   "epsilon": self._epsilon}
        if self._buf_len >= cfg.learning_starts:
            mlist = []
            # one concatenation per step(), not per minibatch draw
            arrays = {k: np.concatenate(v) for k, v in self._buf.items()}
            for _ in range(cfg.updates_per_iter or 1):
                mb = self._sample_batch(arrays, cfg.minibatch_size)
                mlist.append(self.learner.update_minibatch(mb))
                self._grad_updates += 1
                if self._grad_updates % cfg.target_update_freq == 0:
                    self._sync_targets()
            metrics.update(mean_metrics(mlist))
        metrics["env_steps_total"] = self._env_steps_total
        mean_ret = self._returns.mean()
        if mean_ret is not None:
            metrics["episode_return_mean"] = mean_ret
        return metrics

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Greedy (epsilon=0) episodes on a fresh env instance."""
        env = make_multi_agent_env(self.config)
        state = {"obs": env.reset()}
        net = self.learner.get_params()["agent"]

        def step():
            chosen = self._greedy(net, self._stack_obs(state["obs"]))
            acts = {a: chosen[:, i].astype(np.int64)
                    for i, a in enumerate(self.agents)}
            state["obs"], rewards, dones = env.step(acts)
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
