"""Environment specs (the port's own copy of ``EnvSpec`` from
``ray_tpu/rl/env.py``; the numpy envs and their registry are not ported:
the fused iteration runs the device envs of ``rl/device_env.py``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class EnvSpec:
    obs_dim: int = 0
    num_actions: int = 0        # discrete action count (0 => continuous)
    action_dim: int = 0         # continuous action dim
    action_low: float = -1.0
    action_high: float = 1.0
    # Image observations: (H, W, C). When set, obs_dim is ignored.
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
