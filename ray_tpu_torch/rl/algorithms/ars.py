"""ARS: Augmented Random Search (Mania et al. 2018; port of
``ray_tpu/rl/algorithms/ars.py``).

Reference analog: ``rllib/algorithms/ars/ars.py`` — ES's antithetic
whole-episode evaluation fleet (shared here by subclassing :class:`ES`;
noise travels as integer seeds, the SharedNoiseTable trick) with the
three ARS augmentations: (V2) observations are normalized by a running
mean/std filter shared across the fleet (the ``normalize_obs`` flag on
the shared ``_ESWorker``), (b) only the top-b directions by
max(r+, r-) contribute to the update, and the step is scaled by the
standard deviation of the selected returns.

The workers are ES's (actors where the port's runtime is initialized,
else objects in process): the filter is merged from each worker's
``[count, sum, sumsq]`` delta in worker order and set back on every
worker, as JAX does through its actors.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rl.algorithms.es import ES, ESConfig, _noise
from ray_tpu_torch.rl.config import AlgorithmConfig


class ARSConfig(ESConfig):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.algo_class = ARS
        self.episodes_per_perturbation = 1
        self.top_directions = 8       # b: directions kept for the update
        self.normalize_obs = True


class ARS(ES):
    """ES fleet + top-direction selection + fleet-synced obs filter."""

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return ARSConfig()

    def build_learner(self) -> None:
        super().build_learner()
        d = self.spec.obs_dim
        self._f_count = 1e-4
        self._f_sum = np.zeros(d, dtype=np.float64)
        self._f_sumsq = np.ones(d, dtype=np.float64) * 1e-4

    # -- obs-filter state (checkpointed; reference: ARS's shared
    # MeanStdFilter snapshot) --------------------------------------------

    def get_extra_state(self):
        return {"count": self._f_count, "sum": self._f_sum,
                "sumsq": self._f_sumsq}

    def set_extra_state(self, state) -> None:
        if state:
            self._f_count = state["count"]
            self._f_sum = np.asarray(state["sum"])
            self._f_sumsq = np.asarray(state["sumsq"])
            self._broadcast_filter()

    def _broadcast_filter(self) -> None:
        mean = self._f_sum / self._f_count
        var = np.maximum(self._f_sumsq / self._f_count - mean ** 2, 1e-8)
        self.worker_fleet.gather("set_filter",
                                 [(mean, var)] * len(self.worker_fleet))

    def _merge_filter_deltas(self) -> None:
        for dlt in self.worker_fleet.gather(
                "pop_filter_delta", [()] * len(self.worker_fleet)):
            self._f_count += float(dlt[0][0])
            self._f_sum += dlt[1]
            self._f_sumsq += dlt[2]
        self._broadcast_filter()

    # -- the ARS update ---------------------------------------------------

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        seeds = self._draw_seeds()
        results = self._evaluate_pairs(seeds)
        pos = np.array([r[0] for r in results])
        neg = np.array([r[1] for r in results])
        # top-b directions by max(r+, r-)
        b = min(cfg.top_directions, len(seeds))
        order = np.argsort(-np.maximum(pos, neg))[:b]
        sel = np.concatenate([pos[order], neg[order]])
        sigma_r = float(np.std(sel)) or 1.0
        grad = np.zeros_like(self._center)
        for i in order:
            grad += (pos[i] - neg[i]) * _noise(seeds[i],
                                               len(self._center),
                                               cfg.noise_std)
        # noise above is std-scaled; divide it out so the step is in
        # unit-direction space as in the paper
        self._center = self._center \
            + cfg.lr / (b * sigma_r * cfg.noise_std) * grad
        if cfg.normalize_obs:
            self._merge_filter_deltas()
        self._env_steps_total += int(sum(r[2] for r in results))
        all_r = np.concatenate([pos, neg])
        return {
            "mean_return": float(np.mean(all_r)),
            "best_return": float(np.max(all_r)),
            "selected_return_std": sigma_r,
        }
