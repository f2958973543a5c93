"""EnvRunner: the sampling worker (port of ``ray_tpu/rl/env_runner.py``).

JAX runs each EnvRunner as an actor (``@ray_tpu.remote``); here it is a
plain object that an ``Algorithm`` holds in a list, and a remote call is a
method call. The architecture is JAX's: a numpy vector env on the host,
and per env step one policy forward on the runner's device whose actions
are read back to the host for the env (``rl/anakin.py``'s
``bench_fused_vs_host`` measures what that costs). The step's logp and
values stay on the device and are read once, after the fragment.
``sample`` returns a columnar batch flattened t-major ([T, N] ->
[T*N]) with GAE advantages and value targets.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.connectors import build_connectors
from ray_tpu_torch.rl.env import make_env


def compute_gae(rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
                last_values: np.ndarray, gamma: float,
                lam: float) -> Dict[str, np.ndarray]:
    """Vectorized GAE over a [T, N] fragment (numpy scan, on the host)."""
    T, N = rewards.shape
    adv = np.zeros((T, N), dtype=np.float32)
    last_gae = np.zeros(N, dtype=np.float32)
    next_values = last_values
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * next_values * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_values = values[t]
    returns = adv + values
    return {"advantages": adv, "value_targets": returns}


class EnvRunner:
    """One sampler: a vectorized env and the policy forward on ``device``
    (``cuda`` unless given). Actions are drawn from a ``torch.Generator``
    seeded with ``seed`` (the env's resets from numpy's, as in JAX).

    ``explore``: "stochastic" (categorical or Gaussian samples),
    "epsilon_greedy" (logits are Q-values; epsilon read from
    ``params["epsilon"]``), or "squashed_gaussian" (the executed action is
    the tanh-squashed rescaled sample)."""

    def __init__(self, env_name: str, num_envs: int, rollout_len: int,
                 gamma: float = 0.99, lam: float = 0.95, seed: int = 0,
                 env_config: Optional[Dict] = None,
                 explore: str = "stochastic",
                 connectors: Optional[list] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._env = make_env(env_name, num_envs, env_config, seed=seed)
        self.spec = self._env.spec
        self._rollout_len = rollout_len
        self._gamma, self._lam = gamma, lam
        self._explore = explore
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._obs = self._env.reset()          # RAW env obs
        self._episode_returns = np.zeros(num_envs, dtype=np.float64)
        self._completed: list = []
        # The FILTERED view is what the policy sees and what the batch
        # stores, so actor and learner share one normalized space. Filters
        # run per last axis: features for flat obs, channels for pixels.
        self._connectors = build_connectors(connectors,
                                            self.spec.obs_dims[-1])

    def _act(self, params, obs: torch.Tensor):
        """(actions, logp, values) for one step's [N, ...] obs, on the
        device."""
        spec, gen = self.spec, self._gen
        logits = models.policy_logits(params, obs)
        if self._explore == "epsilon_greedy":
            # logits are Q-values; the Q-net has no value head
            vals = torch.max(logits, dim=-1).values
            greedy = torch.argmax(logits, dim=-1)
            rand = torch.randint(0, spec.num_actions, greedy.shape,
                                 generator=gen, device=obs.device)
            pick = torch.rand(greedy.shape, generator=gen,
                              device=obs.device) < params["epsilon"]
            actions = torch.where(pick, rand, greedy)
            return actions, torch.zeros(actions.shape,
                                        device=obs.device), vals
        vals = models.value(params, obs)
        if spec.discrete:
            actions = models.categorical_sample(gen, logits)
            logp = models.categorical_logp(logits, actions)
        elif self._explore == "squashed_gaussian":
            # the EXECUTED action is the tanh-squashed rescaled sample,
            # the policy a replay-based learner optimizes (logp unused)
            std = torch.exp(params["log_std"])
            pre = logits + std * torch.randn(logits.shape, generator=gen,
                                             device=obs.device)
            half = (spec.action_high - spec.action_low) / 2.0
            mid = (spec.action_high + spec.action_low) / 2.0
            actions = mid + half * torch.tanh(pre)
            logp = torch.zeros(actions.shape[:-1], device=obs.device)
        else:
            actions = models.gaussian_sample(gen, logits, params["log_std"])
            logp = models.gaussian_logp(logits, params["log_std"], actions)
        return actions, logp, vals

    def _value(self, params, obs: torch.Tensor) -> torch.Tensor:
        if self._explore == "epsilon_greedy":
            return torch.max(models.policy_logits(params, obs), dim=-1).values
        return models.value(params, obs)

    def get_pid(self) -> int:
        """The process id (one process: the algorithm's own)."""
        return os.getpid()

    def get_spec(self):
        return self.spec

    def _device_obs(self, obs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(obs, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def sample(self, params) -> Dict[str, np.ndarray]:
        """Collect one [T, N] fragment with the given policy params (a tree
        of tensors or numpy arrays; moved to the runner's device)."""
        params = models.params_to_device(params, self.device)
        spec = self.spec
        T, N = self._rollout_len, self._env.num_envs
        obs_buf = np.zeros((T, N, *spec.obs_dims), dtype=np.float32)
        act_shape = (T, N) if spec.discrete else (T, N, spec.action_dim)
        act_buf = np.zeros(
            act_shape, dtype=np.int32 if spec.discrete else np.float32)
        logp_dev = torch.zeros((T, N), device=self.device)
        val_dev = torch.zeros((T, N), device=self.device)
        rew_buf = np.zeros((T, N), dtype=np.float32)
        done_buf = np.zeros((T, N), dtype=bool)
        next_obs_buf = np.zeros((T, N, *spec.obs_dims), dtype=np.float32)

        exec_buf = act_buf if spec.discrete else np.zeros_like(act_buf)
        conn = self._connectors
        for t in range(T):
            obs_in = (conn.on_obs(self._obs) if conn is not None
                      else self._obs)
            actions, logp, vals = self._act(params,
                                            self._device_obs(obs_in))
            actions = actions.cpu().numpy()    # the step's one host read
            obs_buf[t] = obs_in
            # "actions" stores the raw policy sample (PPO's ratio needs the
            # logp-consistent action); "actions_executed" stores what the
            # env actually ran (what replay-based critics must train on)
            act_buf[t] = actions
            logp_dev[t] = logp
            val_dev[t] = vals
            if not spec.discrete:
                actions = np.clip(actions, spec.action_low, spec.action_high)
                exec_buf[t] = actions
            self._obs, rewards, dones = self._env.step(actions)
            # training signal may be clipped; episode stats stay RAW
            rew_buf[t] = (conn.on_reward(rewards) if conn is not None
                          else rewards)
            done_buf[t] = dones
            # post-reset obs on done rows is fine: (1-done) masks bootstrap.
            # update=False: this same obs is re-filtered (with update) as
            # obs_in at t+1, so the stats count it once.
            next_obs_buf[t] = (conn.on_obs(self._obs, update=False)
                               if conn is not None else self._obs)
            self._episode_returns += rewards
            if dones.any():
                for r in self._episode_returns[dones]:
                    self._completed.append(float(r))
                self._episode_returns[dones] = 0.0

        last_obs = (conn.on_obs(self._obs, update=False) if conn is not None
                    else self._obs)
        last_values = self._value(params, self._device_obs(last_obs))
        logp_buf = logp_dev.cpu().numpy()
        val_buf = val_dev.cpu().numpy()
        last_values = last_values.cpu().numpy().astype(np.float32)
        gae = compute_gae(rew_buf, val_buf, done_buf, last_values,
                          self._gamma, self._lam)
        flat = lambda a: a.reshape((T * N,) + a.shape[2:])  # noqa: E731
        return {
            "obs": flat(obs_buf), "actions": flat(act_buf),
            "actions_executed": flat(exec_buf),
            "logp": flat(logp_buf), "values": flat(val_buf),
            "rewards": flat(rew_buf), "dones": flat(done_buf),
            "next_obs": flat(next_obs_buf),
            "advantages": flat(gae["advantages"]),
            "value_targets": flat(gae["value_targets"]),
            # [N] bootstrap for off-policy corrections (IMPALA V-trace)
            "last_values": last_values,
        }

    # ---- connector state sync (reference: filter delta flush) ----------
    def pop_connector_deltas(self):
        return (self._connectors.pop_deltas()
                if self._connectors is not None else None)

    def set_connector_globals(self, states) -> None:
        if self._connectors is not None:
            self._connectors.set_globals(states)

    def episode_stats(self) -> Dict[str, float]:
        completed, self._completed = self._completed, []
        if not completed:
            return {"episodes": 0, "mean_return": float("nan")}
        return {"episodes": len(completed),
                "mean_return": float(np.mean(completed))}
