"""Environments: the vectorized interface and the builtin numpy envs (the
port's own copy of ``ray_tpu/rl/env.py``).

The builtin envs are numpy-vectorized classic control dynamics (CartPole,
Pendulum), stepped on the host as in JAX: with the same seed and actions
both packages step bit for bit alike. External envs plug in through
``register_env``. The fused iteration runs the device envs of
``rl/device_env.py`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

_ENV_REGISTRY: Dict[str, Callable] = {}


def register_env(name: str, creator: Callable[[Dict], "VectorEnv"]) -> None:
    _ENV_REGISTRY[name] = creator


def make_env(name: str, num_envs: int, config: Optional[Dict] = None,
             seed: int = 0) -> "VectorEnv":
    if name in _ENV_REGISTRY:
        return _ENV_REGISTRY[name]({"num_envs": num_envs,
                                    "seed": seed, **(config or {})})
    if name == "CartPole-v1":
        return CartPole(num_envs, seed=seed)
    if name == "Pendulum-v1":
        return Pendulum(num_envs, seed=seed)
    raise KeyError(
        f"unknown env {name!r}; register it with rl.register_env")


@dataclasses.dataclass
class EnvSpec:
    obs_dim: int = 0
    num_actions: int = 0        # discrete action count (0 => continuous)
    action_dim: int = 0         # continuous action dim
    action_low: float = -1.0
    action_high: float = 1.0
    # Image observations: (H, W, C). When set, obs_dim is ignored and
    # policies get a conv encoder (models.py).
    obs_shape: Tuple[int, ...] = ()

    @property
    def discrete(self) -> bool:
        return self.num_actions > 0

    @property
    def obs_dims(self) -> Tuple[int, ...]:
        """Per-observation shape: (obs_dim,) for flat envs, (H, W, C) for
        pixel envs."""
        return tuple(self.obs_shape) if self.obs_shape else (self.obs_dim,)

    @property
    def is_pixel(self) -> bool:
        return len(self.obs_shape) == 3


class VectorEnv:
    """N independent env copies stepped in lockstep; auto-resets on done."""

    spec: EnvSpec
    num_envs: int

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """returns (obs, rewards, dones); done envs are already reset."""
        raise NotImplementedError


class CartPole(VectorEnv):
    """Numpy-vectorized CartPole-v1 dynamics (500-step limit, +1/step)."""

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self.spec = EnvSpec(obs_dim=4, num_actions=2)
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), dtype=np.float64)
        self._t = np.zeros(num_envs, dtype=np.int64)
        self._gravity, self._mc, self._mp = 9.8, 1.0, 0.1
        self._l, self._fmag, self._dt = 0.5, 10.0, 0.02
        self._theta_lim = 12 * 2 * np.pi / 360
        self._x_lim = 2.4
        self._max_t = 500

    def _reset_envs(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if n:
            self._state[mask] = self._rng.uniform(-0.05, 0.05, size=(n, 4))
            self._t[mask] = 0

    def reset(self) -> np.ndarray:
        self._reset_envs(np.ones(self.num_envs, dtype=bool))
        return self._state.astype(np.float32)

    def step(self, actions: np.ndarray):
        x, x_dot, th, th_dot = self._state.T
        force = np.where(actions == 1, self._fmag, -self._fmag)
        cos, sin = np.cos(th), np.sin(th)
        total_m = self._mc + self._mp
        pm_l = self._mp * self._l
        temp = (force + pm_l * th_dot ** 2 * sin) / total_m
        th_acc = (self._gravity * sin - cos * temp) / (
            self._l * (4.0 / 3.0 - self._mp * cos ** 2 / total_m))
        x_acc = temp - pm_l * th_acc * cos / total_m
        x = x + self._dt * x_dot
        x_dot = x_dot + self._dt * x_acc
        th = th + self._dt * th_dot
        th_dot = th_dot + self._dt * th_acc
        self._state = np.stack([x, x_dot, th, th_dot], axis=1)
        self._t += 1
        dones = ((np.abs(x) > self._x_lim)
                 | (np.abs(th) > self._theta_lim)
                 | (self._t >= self._max_t))
        rewards = np.ones(self.num_envs, dtype=np.float32)
        self._reset_envs(dones)
        return self._state.astype(np.float32), rewards, dones


class Pendulum(VectorEnv):
    """Numpy-vectorized Pendulum-v1 (continuous torque, 200-step episodes)."""

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self.spec = EnvSpec(obs_dim=3, action_dim=1,
                            action_low=-2.0, action_high=2.0)
        self._rng = np.random.default_rng(seed)
        self._th = np.zeros(num_envs)
        self._thdot = np.zeros(num_envs)
        self._t = np.zeros(num_envs, dtype=np.int64)
        self._max_t = 200
        self._g, self._m, self._l, self._dt = 10.0, 1.0, 1.0, 0.05

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self._th), np.sin(self._th),
                         self._thdot], axis=1).astype(np.float32)

    def _reset_envs(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if n:
            self._th[mask] = self._rng.uniform(-np.pi, np.pi, size=n)
            self._thdot[mask] = self._rng.uniform(-1.0, 1.0, size=n)
            self._t[mask] = 0

    def reset(self) -> np.ndarray:
        self._reset_envs(np.ones(self.num_envs, dtype=bool))
        return self._obs()

    def step(self, actions: np.ndarray):
        u = np.clip(np.asarray(actions).reshape(self.num_envs), -2.0, 2.0)
        th_norm = ((self._th + np.pi) % (2 * np.pi)) - np.pi
        costs = th_norm ** 2 + 0.1 * self._thdot ** 2 + 0.001 * u ** 2
        thdot = self._thdot + (
            3 * self._g / (2 * self._l) * np.sin(self._th)
            + 3.0 / (self._m * self._l ** 2) * u) * self._dt
        thdot = np.clip(thdot, -8.0, 8.0)
        self._th = self._th + thdot * self._dt
        self._thdot = thdot
        self._t += 1
        dones = self._t >= self._max_t
        rewards = (-costs).astype(np.float32)
        self._reset_envs(dones)
        return self._obs(), rewards, dones
