"""Connector pipeline: composable observation/reward transforms on the
sampling path (the port's own copy of ``ray_tpu/rl/connectors.py``; numpy
on the host, as in JAX).

Reference analog: ``rllib/connectors/connector.py:83`` (``Connector``,
``ConnectorPipeline``) and the classic impls — ``MeanStdFilter``
(obs normalization; reference ``rllib/utils/filter.py``), ``ClipReward``.
Redesign notes: the reference threads connectors through per-agent
view-requirement machinery; here a pipeline is a plain object owned by each
EnvRunner, applied at act time, with the *filtered* obs and reward stored in
the sample batch (so the learner trains in the same normalized space the
policy acts in).

Cross-runner stat sync follows the reference's delta-flush scheme: each
runner accumulates a local DELTA on top of the last broadcast global state;
the algorithm pops deltas every iteration, merges them (Chan's parallel
variance update), and broadcasts the new global — no runner ever
double-counts another's data.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np


class _RunningStats:
    """Welford/Chan running (count, mean, M2) with exact parallel merge."""

    __slots__ = ("count", "mean", "m2")

    def __init__(self, dim: int):
        self.count = 0.0
        self.mean = np.zeros(dim, dtype=np.float64)
        self.m2 = np.zeros(dim, dtype=np.float64)

    def push_batch(self, x: np.ndarray) -> None:
        x = x.reshape(-1, x.shape[-1]).astype(np.float64)
        n = x.shape[0]
        if n == 0:
            return
        b_mean = x.mean(axis=0)
        b_m2 = ((x - b_mean) ** 2).sum(axis=0)
        self._merge(n, b_mean, b_m2)

    def _merge(self, n: float, mean: np.ndarray, m2: np.ndarray) -> None:
        if n == 0:
            return
        tot = self.count + n
        delta = mean - self.mean
        self.mean = self.mean + delta * (n / tot)
        self.m2 = self.m2 + m2 + delta ** 2 * (self.count * n / tot)
        self.count = tot

    def merge_stats(self, other: "_RunningStats") -> None:
        self._merge(other.count, other.mean, other.m2)

    @property
    def std(self) -> np.ndarray:
        var = self.m2 / max(self.count, 1.0)
        return np.sqrt(np.maximum(var, 1e-8))

    def to_state(self) -> Dict[str, Any]:
        return {"count": self.count, "mean": self.mean.copy(),
                "m2": self.m2.copy()}

    @classmethod
    def from_state(cls, state: Dict[str, Any], dim: int) -> "_RunningStats":
        rs = cls(dim)
        if state:
            rs.count = float(state["count"])
            rs.mean = np.asarray(state["mean"], dtype=np.float64).copy()
            rs.m2 = np.asarray(state["m2"], dtype=np.float64).copy()
        return rs


class Connector:
    """One composable transform stage (obs and/or reward)."""

    def on_obs(self, obs: np.ndarray, update: bool = True) -> np.ndarray:
        return obs

    def on_reward(self, rewards: np.ndarray) -> np.ndarray:
        return rewards

    # delta-sync protocol (no-ops for stateless connectors)
    def pop_delta(self) -> Any:
        return None

    def merge_delta(self, global_state: Any, delta: Any) -> Any:
        return global_state

    def set_global(self, state: Any) -> None:
        pass

    def get_global(self) -> Any:
        return None


class MeanStdFilter(Connector):
    """Normalize observations by running mean/std (reference:
    ``rllib/utils/filter.py`` MeanStdFilter via the MeanStdObservationFilter
    connector). Essential for continuous control: Pendulum/SAC/DDPG targets
    diverge on raw obs scales."""

    def __init__(self, obs_dim: int, clip: float = 10.0):
        self.obs_dim = obs_dim
        self.clip = clip
        self._global = _RunningStats(obs_dim)
        self._delta = _RunningStats(obs_dim)

    def _effective(self) -> _RunningStats:
        eff = _RunningStats.from_state(self._global.to_state(), self.obs_dim)
        eff.merge_stats(self._delta)
        return eff

    def on_obs(self, obs: np.ndarray, update: bool = True) -> np.ndarray:
        if update:
            self._delta.push_batch(obs)
        eff = self._effective()
        if eff.count < 2:
            return obs.astype(np.float32)
        out = (obs - eff.mean) / eff.std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def pop_delta(self):
        d, self._delta = self._delta, _RunningStats(self.obs_dim)
        return d.to_state()

    def merge_delta(self, global_state, delta):
        g = _RunningStats.from_state(global_state or {}, self.obs_dim)
        if delta:
            g.merge_stats(_RunningStats.from_state(delta, self.obs_dim))
        return g.to_state()

    def set_global(self, state) -> None:
        self._global = _RunningStats.from_state(state or {}, self.obs_dim)

    def get_global(self):
        return self._global.to_state()


class ClipReward(Connector):
    """Clip (or sign-compress) rewards before they reach returns/GAE —
    reference: ``rllib/connectors/agent/clip_reward.py`` (the Atari
    convention)."""

    def __init__(self, limit: float = 1.0, sign: bool = False):
        self.limit = limit
        self.sign = sign

    def on_reward(self, rewards: np.ndarray) -> np.ndarray:
        if self.sign:
            return np.sign(rewards).astype(np.float32)
        return np.clip(rewards, -self.limit, self.limit).astype(np.float32)


class ClipObs(Connector):
    def __init__(self, limit: float = 10.0):
        self.limit = limit

    def on_obs(self, obs: np.ndarray, update: bool = True) -> np.ndarray:
        return np.clip(obs, -self.limit, self.limit).astype(np.float32)


class ConnectorPipeline:
    """Ordered connector stages; the unit EnvRunner owns and syncs."""

    def __init__(self, stages: List[Connector]):
        self.stages = list(stages)

    def on_obs(self, obs: np.ndarray, update: bool = True) -> np.ndarray:
        for s in self.stages:
            obs = s.on_obs(obs, update=update)
        return obs

    def on_reward(self, rewards: np.ndarray) -> np.ndarray:
        for s in self.stages:
            rewards = s.on_reward(rewards)
        return rewards

    def pop_deltas(self) -> List[Any]:
        return [s.pop_delta() for s in self.stages]

    def merge_deltas(self, global_states: Optional[List[Any]],
                     runner_deltas: List[List[Any]]) -> List[Any]:
        states = list(global_states or [None] * len(self.stages))
        for deltas in runner_deltas:
            states = [s.merge_delta(g, d)
                      for s, g, d in zip(self.stages, states, deltas)]
        return states

    def set_globals(self, states: Optional[List[Any]]) -> None:
        for s, st in zip(self.stages, states or [None] * len(self.stages)):
            s.set_global(st)

    def get_globals(self) -> List[Any]:
        return [s.get_global() for s in self.stages]


ConnectorSpec = Union[str, Dict[str, Any]]


def build_connectors(specs: Optional[Sequence[ConnectorSpec]],
                     obs_dim: int) -> Optional[ConnectorPipeline]:
    """Specs are strings or {"type": ..., **kwargs} dicts, e.g.
    ``["mean_std_filter", {"type": "clip_reward", "limit": 1.0}]``."""
    if not specs:
        return None
    stages: List[Connector] = []
    for spec in specs:
        if isinstance(spec, str):
            kind, kwargs = spec, {}
        else:
            spec = dict(spec)
            kind, kwargs = spec.pop("type"), spec
        if kind == "mean_std_filter":
            stages.append(MeanStdFilter(obs_dim, **kwargs))
        elif kind == "clip_reward":
            stages.append(ClipReward(**kwargs))
        elif kind == "clip_obs":
            stages.append(ClipObs(**kwargs))
        else:
            raise ValueError(f"unknown connector {kind!r}")
    return ConnectorPipeline(stages)
