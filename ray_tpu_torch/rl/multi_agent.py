"""Multi-agent RL: MultiAgentEnv protocol, policy mapping, multi-policy PPO
(port of ``ray_tpu/rl/multi_agent.py``).

Reference analogs: ``rllib/env/multi_agent_env.py`` (``MultiAgentEnv``),
``rllib/core/rl_module/marl_module.py`` (``MultiAgentRLModule`` — here a
dict of per-policy param trees), and the ``policy_mapping_fn`` config
(``algorithm_config.py`` ``multi_agent()``). Scope: simultaneous-move envs
(every agent acts every step, shared episode termination) — the common
cooperative/competitive matrix and particle settings; turn-based envs are
out of scope.

The envs are JAX's numpy envs, unchanged: the same seed and actions give
the same observations and rewards bit for bit. Per policy: an independent
PPO ``Learner`` on the trainable's device. Rollouts are vectorized
in-process; each agent's action, log-prob and value come back from the
device in one read a step, each agent's trajectory is routed to its
policy's batch by ``policy_mapping_fn``, GAE computed per agent stream.
The actions are drawn from the trainable's ``torch.Generator`` (not JAX's
key chain).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import DeviceTrainable
from ray_tpu_torch.rl.algorithms.ppo import make_ppo_loss
from ray_tpu_torch.rl.env import EnvSpec
from ray_tpu_torch.rl.env_runner import compute_gae
from ray_tpu_torch.rl.learner import Learner


class MultiAgentEnv:
    """N vectorized copies of a simultaneous-move multi-agent episode.

    - ``agents``: fixed agent-id list
    - ``reset() -> {agent: obs [N, obs_dim]}``
    - ``step({agent: actions [N]}) -> (obs, rewards, dones)`` where obs and
      rewards are per-agent dicts and ``dones`` is [N] (shared termination;
      done envs auto-reset).
    """

    agents: List[str]
    spec: Dict[str, EnvSpec]
    num_envs: int

    def reset(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, np.ndarray]):
        raise NotImplementedError


class CoordinationGame(MultiAgentEnv):
    """Repeated 2-agent coordination: both pick one of K arms; reward 1 when
    they MATCH on the current round's 'good' arm pair, 0 otherwise. The good
    arm is observable, so coordinated policies reach reward ~1/step; random
    play earns ~1/K^2. Episodes last ``horizon`` rounds."""

    def __init__(self, num_envs: int = 8, k: int = 3, horizon: int = 16,
                 seed: int = 0):
        self.agents = ["a0", "a1"]
        self.num_envs = num_envs
        self.k = k
        self.horizon = horizon
        self._rng = np.random.default_rng(seed)
        obs_dim = k + 1  # one-hot good arm + normalized round index
        spec = EnvSpec(obs_dim=obs_dim, num_actions=k)
        self.spec = {a: spec for a in self.agents}
        self._t = np.zeros(num_envs, dtype=np.int64)
        self._good = self._rng.integers(0, k, num_envs)

    def _obs(self) -> Dict[str, np.ndarray]:
        onehot = np.eye(self.k, dtype=np.float32)[self._good]
        frac = (self._t / self.horizon).astype(np.float32)[:, None]
        obs = np.concatenate([onehot, frac], axis=1)
        return {a: obs.copy() for a in self.agents}

    def reset(self) -> Dict[str, np.ndarray]:
        self._t[:] = 0
        self._good = self._rng.integers(0, self.k, self.num_envs)
        return self._obs()

    def step(self, actions: Dict[str, np.ndarray]):
        a0, a1 = actions["a0"], actions["a1"]
        hit = (a0 == self._good) & (a1 == self._good)
        reward = hit.astype(np.float32)
        self._t += 1
        dones = self._t >= self.horizon
        # next round's good arm; reset finished envs
        self._good = self._rng.integers(0, self.k, self.num_envs)
        self._t[dones] = 0
        rewards = {a: reward.copy() for a in self.agents}
        return self._obs(), rewards, dones


class SpreadGame(MultiAgentEnv):
    """Continuous cooperative coverage (an MPE ``simple_spread``-style
    particle setting, the reference MADDPG's home env): 2 agents move on
    the [-1,1]^2 plane toward 2 landmarks; the SHARED dense reward is
    ``-sum_l min_a dist(a, l)``, maximized when each landmark has an agent
    on it. Actions are velocities in [-1,1]^2; fixed horizon, auto-reset."""

    def __init__(self, num_envs: int = 8, horizon: int = 25,
                 dt: float = 0.15, seed: int = 0):
        self.agents = ["a0", "a1"]
        self.num_envs = num_envs
        self.horizon = horizon
        self.dt = dt
        self._rng = np.random.default_rng(seed)
        # obs: own pos (2) + other pos (2) + both landmarks (4)
        spec = EnvSpec(obs_dim=8, action_dim=2,
                       action_low=-1.0, action_high=1.0)
        self.spec = {a: spec for a in self.agents}
        self._t = np.zeros(num_envs, dtype=np.int64)
        self._pos = np.zeros((num_envs, 2, 2), dtype=np.float32)
        self._land = np.zeros((num_envs, 2, 2), dtype=np.float32)
        self._reset_envs(np.ones(num_envs, dtype=bool))

    def _reset_envs(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if not n:
            return
        self._pos[mask] = self._rng.uniform(-1, 1, (n, 2, 2))
        self._land[mask] = self._rng.uniform(-1, 1, (n, 2, 2))
        self._t[mask] = 0

    def _obs(self) -> Dict[str, np.ndarray]:
        land = self._land.reshape(self.num_envs, 4)
        out = {}
        for i, a in enumerate(self.agents):
            own = self._pos[:, i]
            other = self._pos[:, 1 - i]
            out[a] = np.concatenate([own, other, land],
                                    axis=1).astype(np.float32)
        return out

    def reset(self) -> Dict[str, np.ndarray]:
        self._reset_envs(np.ones(self.num_envs, dtype=bool))
        return self._obs()

    def _coverage_reward(self) -> np.ndarray:
        # dist[e, l, a] = || land[e,l] - pos[e,a] ||
        d = np.linalg.norm(self._land[:, :, None] - self._pos[:, None],
                           axis=-1)
        return -d.min(axis=2).sum(axis=1).astype(np.float32)

    def step(self, actions: Dict[str, np.ndarray]):
        for i, a in enumerate(self.agents):
            vel = np.clip(np.asarray(actions[a], dtype=np.float32), -1, 1)
            self._pos[:, i] = np.clip(self._pos[:, i] + self.dt * vel,
                                      -1, 1)
        reward = self._coverage_reward()
        self._t += 1
        dones = self._t >= self.horizon
        self._reset_envs(dones)
        rewards = {a: reward.copy() for a in self.agents}
        return self._obs(), rewards, dones


_MA_ENVS: Dict[str, Callable[..., MultiAgentEnv]] = {
    "coordination": CoordinationGame,
    "spread": SpreadGame,
}


def register_multi_agent_env(name: str, ctor: Callable[..., MultiAgentEnv]):
    _MA_ENVS[name] = ctor


def make_multi_agent_env(cfg) -> MultiAgentEnv:
    """``cfg.env`` (a registered name or a constructor) with
    ``num_envs_per_runner`` copies and ``env_config``."""
    ctor = _MA_ENVS[cfg.env] if isinstance(cfg.env, str) else cfg.env
    return ctor(num_envs=cfg.num_envs_per_runner, **(cfg.env_config or {}))


class MultiAgentPPO(DeviceTrainable):
    """Independent-PPO over a policy map (reference: multi-agent PPO with
    ``policy_mapping_fn``; 'independent' = no centralized critic — the
    standard IPPO baseline)."""

    def setup(self, config: Dict[str, Any]) -> None:
        self.config = self.config_from(config)
        cfg = self.config
        self.env = make_multi_agent_env(cfg)
        self.policy_mapping_fn = (cfg.policy_mapping_fn
                                  or (lambda agent_id: agent_id))
        self.policies = sorted({self.policy_mapping_fn(a)
                                for a in self.env.agents})
        self.learners: Dict[str, Learner] = {}
        for i, pid in enumerate(self.policies):
            spec = self.env.spec[next(
                a for a in self.env.agents
                if self.policy_mapping_fn(a) == pid)]
            loss = make_ppo_loss(spec, cfg.clip_param, cfg.vf_coeff,
                                 cfg.entropy_coeff)
            params = models.init_policy(self.generator(cfg.seed + i), spec,
                                        cfg.hidden)
            self.learners[pid] = Learner(params, loss, cfg.lr,
                                         grad_clip=cfg.grad_clip,
                                         seed=cfg.seed + i,
                                         device=self.device)
        self._gen = self.generator(cfg.seed + 777)
        self._obs = self.env.reset()

    @torch.no_grad()
    def _act(self, pid: str, obs: np.ndarray):
        """(action, logp, value) for one agent's [N] rows, read back from
        the device in one copy."""
        params = self.learners[pid].get_params()
        obs = torch.as_tensor(obs, device=self.device)
        logits = models.policy_logits(params, obs)
        action = models.categorical_sample(self._gen, logits)
        logp = models.categorical_logp(logits, action)
        value = models.value(params, obs)
        out = torch.stack([action.to(logp.dtype), logp, value]).cpu().numpy()
        return out[0].astype(np.int64), out[1], out[2]

    def _rollout(self) -> Dict[str, Dict[str, np.ndarray]]:
        """``rollout_fragment_length`` vector steps: each agent's columns
        stacked [T, N, ...]."""
        T = self.config.rollout_fragment_length
        agents = self.env.agents
        buf = {a: {k: [] for k in
                   ("obs", "actions", "logp", "values", "rewards", "dones")}
               for a in agents}
        for _ in range(T):
            acts, steps = {}, {}
            for a in agents:
                pid = self.policy_mapping_fn(a)
                action, logp, value = self._act(pid, self._obs[a])
                steps[a] = (self._obs[a], action, logp, value)
                acts[a] = action
            next_obs, rewards, dones = self.env.step(acts)
            for a in agents:
                o, act, lp, val = steps[a]
                b = buf[a]
                b["obs"].append(o)
                b["actions"].append(act)
                b["logp"].append(lp)
                b["values"].append(val)
                b["rewards"].append(rewards[a])
                b["dones"].append(dones)
            self._obs = next_obs
        return {a: {k: np.stack(v) for k, v in buf[a].items()}
                for a in agents}

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        T, N = cfg.rollout_fragment_length, self.env.num_envs
        rollout = self._rollout()
        metrics: Dict[str, Any] = {}
        mean_rewards = []
        per_policy: Dict[str, List[Dict[str, np.ndarray]]] = \
            {pid: [] for pid in self.policies}
        for a in self.env.agents:
            pid = self.policy_mapping_fn(a)
            b = rollout[a]                                   # [T, N, ...]
            with torch.no_grad():
                last_value = models.value(
                    self.learners[pid].get_params(),
                    torch.as_tensor(self._obs[a], device=self.device)
                ).cpu().numpy()
            gae = compute_gae(
                b["rewards"], b["values"], b["dones"], last_value,
                cfg.gamma, cfg.lambda_)
            adv, targets = gae["advantages"], gae["value_targets"]
            flat = lambda x: x.reshape((T * N,) + x.shape[2:])  # noqa: E731
            per_policy[pid].append({
                "obs": flat(b["obs"]), "actions": flat(b["actions"]),
                "logp": flat(b["logp"]), "advantages": flat(adv),
                "value_targets": flat(targets)})
            mean_rewards.append(float(b["rewards"].mean()))
        for pid in self.policies:
            batch = {k: np.concatenate([d[k] for d in per_policy[pid]])
                     for k in per_policy[pid][0]}
            m = self.learners[pid].update(
                batch, num_epochs=cfg.num_epochs,
                minibatch_size=cfg.minibatch_size,
                seed=cfg.seed + self._iteration)
            metrics.update({f"{pid}/{k}": v for k, v in m.items()})
        metrics["reward_mean_per_step"] = float(np.mean(mean_rewards))
        return metrics

    def get_params(self) -> Dict[str, Any]:
        return {pid: ln.get_params() for pid, ln in self.learners.items()}

    # -- checkpointing --------------------------------------------------------
    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        return {pid: params_to_numpy(ln.get_params())
                for pid, ln in self.learners.items()}

    def load_checkpoint(self, checkpoint: Dict) -> None:
        for pid, params in checkpoint.items():
            self.learners[pid].set_params(params)
