"""Replay buffers: uniform ring and proportional-prioritized (the port's
own copy of ``ray_tpu/rl/replay_buffer.py``).

Reference analog: ``rllib/utils/replay_buffers/`` (``segment_tree.py``,
``prioritized_replay_buffer.py``); the priority tree is a flat numpy
sum-tree (vectorized sampling, no per-leaf Python objects). The buffers
stay numpy on the host and draw from ``np.random.default_rng(seed)``, so
with the same batches and priorities they sample the same rows and
importance weights as JAX's, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class ReplayBuffer:
    """Uniform FIFO ring buffer over columnar transition batches."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._storage: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if self._storage is None:
            self._storage = {
                k: np.zeros((self.capacity,) + v.shape[1:], dtype=v.dtype)
                for k, v in batch.items()}
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._storage[k][idx] = v
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        self._on_added(idx)

    def _on_added(self, idx: np.ndarray) -> None:
        pass

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._storage.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization with a numpy sum-tree."""

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed)
        self._alpha = alpha
        self.beta = beta
        depth = int(np.ceil(np.log2(max(2, capacity))))
        self._leaf_base = 2 ** depth
        self._tree = np.zeros(2 * self._leaf_base, dtype=np.float64)
        self._max_priority = 1.0

    def _set_priorities(self, idx: np.ndarray, priorities: np.ndarray) -> None:
        pos = idx + self._leaf_base
        self._tree[pos] = priorities ** self._alpha
        pos = np.unique(pos // 2)
        while pos[0] >= 1:
            self._tree[pos] = self._tree[2 * pos] + self._tree[2 * pos + 1]
            pos = np.unique(pos // 2)

    def _on_added(self, idx: np.ndarray) -> None:
        self._set_priorities(idx, np.full(len(idx), self._max_priority))

    def sample(self, batch_size: int
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        total = self._tree[1]
        targets = self._rng.uniform(0, total, size=batch_size)
        pos = np.ones(batch_size, dtype=np.int64)
        while pos[0] < self._leaf_base:
            left = self._tree[2 * pos]
            go_right = targets > left
            targets = np.where(go_right, targets - left, targets)
            pos = 2 * pos + go_right
        idx = np.minimum(pos - self._leaf_base, self._size - 1)
        probs = self._tree[idx + self._leaf_base] / max(total, 1e-12)
        weights = (self._size * probs + 1e-12) ** (-self.beta)
        weights = weights / weights.max()
        batch = {k: v[idx] for k, v in self._storage.items()}
        return batch, idx, weights.astype(np.float32)

    def update_priorities(self, idx: np.ndarray,
                          td_errors: np.ndarray) -> None:
        priorities = np.abs(td_errors) + 1e-6
        self._max_priority = max(self._max_priority, float(priorities.max()))
        self._set_priorities(idx, priorities)
