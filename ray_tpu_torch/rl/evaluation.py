"""Shared in-process episode-rollout evaluation loop (the port's own
copy of ``ray_tpu/rl/evaluation.py``: numpy only).

Reference analog: the evaluate path of ``rllib/algorithms/algorithm.py``
(fresh workers, n episodes, mean return). Trainables whose envs live
in-process (QMIX, MADDPG, DreamerV3) share this loop instead of
each carrying its own copy of the cap/bookkeeping.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np


def run_episodes(step: Callable[[], tuple], num_episodes: int,
                 num_envs: int, max_steps: int = 4096) -> Dict[str, Any]:
    """Drive ``step() -> (rewards [N], dones [N])`` until ``num_episodes``
    episodes finish (or ``max_steps`` vector steps elapse) and report the
    mean episode return. The caller owns action selection and env state;
    this loop owns the return/termination bookkeeping."""
    done_returns = []
    ep_ret = np.zeros(num_envs, dtype=np.float64)
    for _ in range(max_steps):
        rewards, dones = step()
        ep_ret += rewards
        for i in np.nonzero(dones)[0]:
            done_returns.append(float(ep_ret[i]))
            ep_ret[i] = 0.0
        if len(done_returns) >= num_episodes:
            break
    return {"episodes": len(done_returns),
            "episode_return_mean": float(np.mean(done_returns))
            if done_returns else float("nan")}


class ReturnWindow:
    """Rolling window of finished-episode returns for training metrics
    (the ``episode_return_mean`` every in-process Trainable reports)."""

    def __init__(self, num_envs: int, size: int = 100):
        self._window: list = []
        self._ep = np.zeros(num_envs, dtype=np.float64)
        self._size = size

    def add(self, rewards: np.ndarray, dones: np.ndarray) -> None:
        self._ep += rewards
        for i in np.nonzero(dones)[0]:
            self._window.append(float(self._ep[i]))
            self._ep[i] = 0.0
        if len(self._window) > self._size:
            del self._window[:len(self._window) - self._size]

    def mean(self) -> Optional[float]:
        if not self._window:
            return None
        return float(np.mean(self._window))
