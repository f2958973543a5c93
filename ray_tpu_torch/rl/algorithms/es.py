"""ES: OpenAI-style evolution strategies (port of
``ray_tpu/rl/algorithms/es.py``).

Reference analog: ``rllib/algorithms/es/es.py`` (Salimans et al. 2017 —
a fleet of workers evaluates antithetic parameter perturbations for whole
episodes; the algorithm combines centered-rank-weighted noise into a gradient
estimate). Noise is reconstructed from integer seeds on both sides (the
reference's SharedNoiseTable trick), and each worker evaluates its
perturbation over its own env.

JAX's workers are actors; here they are plain objects in one process,
called round robin in submission order, which is the order in which JAX's
``ray_tpu.get`` returns their results, so an iteration equals JAX's. A
worker acts with one device forward and one host read per env step.

The center is a float64 numpy vector laid out as JAX's
``jax.tree_util.tree_flatten`` lays out the policy tree: dict keys sorted
(``log_std`` < ``pi`` < ``vf``, ``b`` < ``w``), list items in order. The
policy is cast to float32 on the device only to act.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import _tree_from_paths
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.env import make_env


class ESConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=ES, **kwargs)
        self.episodes_per_perturbation = 2
        self.noise_std = 0.05
        self.num_perturbations = 16   # antithetic pairs per iteration
        self.lr = 0.02
        self.max_episode_len = 500


def _sorted_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in ``jax.tree_util.tree_flatten``'s order: dict keys
    sorted, list items in order."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, child in items:
        out.extend(_sorted_leaves(child, f"{prefix}/{k}" if prefix
                                  else str(k)))
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(params) -> Tuple[np.ndarray, List]:
    """The tree as one float64 vector in JAX's leaf order, and the
    (path, shape) list that ``_unflatten`` rebuilds it from."""
    leaves = [(path, _host(leaf)) for path, leaf in _sorted_leaves(params)]
    meta = [(path, leaf.shape) for path, leaf in leaves]
    flat = np.concatenate([leaf.ravel() for _, leaf in leaves])
    return flat.astype(np.float64), meta


def _unflatten(flat: np.ndarray, meta, device) -> Dict:
    """The tree of float32 tensors on ``device`` from a flat vector: one
    copy to the device, each leaf a view of it."""
    vec = torch.as_tensor(np.asarray(flat, dtype=np.float32), device=device)
    leaves, off = {}, 0
    for path, shape in meta:
        n = int(np.prod(shape)) if shape else 1
        leaves[path] = vec[off:off + n].reshape(shape)
        off += n
    return _tree_from_paths(leaves)


def _noise(seed: int, dim: int, std: float) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(dim) * std


def _centered_ranks(x: np.ndarray) -> np.ndarray:
    """Fitness shaping: returns -> centered ranks in [-0.5, 0.5]
    (the reference's compute_centered_ranks)."""
    ranks = np.empty(len(x), dtype=np.float64)
    ranks[x.argsort()] = np.arange(len(x))
    return ranks / (len(x) - 1) - 0.5 if len(x) > 1 else np.zeros(1)


class _ESWorker:
    """Evaluates policies for whole episodes, optionally normalizing
    observations with a fleet-shared running filter (the ARS-V2
    augmentation; ES runs with ``normalize_obs=False``). Filter deltas
    are popped by the algorithm, merged, and the global mean/var pushed
    back so every worker normalizes with fleet-wide statistics."""

    def __init__(self, env_name: str, env_config: Dict, seed: int,
                 hidden, noise_std: float, max_len: int,
                 normalize_obs: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._env = make_env(env_name, 1, env_config, seed=seed)
        self.spec = self._env.spec
        self._std = noise_std
        self._max_len = max_len
        self._normalize = normalize_obs
        # the tree's layout only: a CPU init, as JAX's worker draws one
        base = models.init_policy(torch.Generator().manual_seed(0),
                                  self.spec, hidden)
        _, self._meta = _flatten(base)
        d = self.spec.obs_dim
        # global filter (mean/var used to normalize) + local delta
        self._mean = np.zeros(d, dtype=np.float64)
        self._var = np.ones(d, dtype=np.float64)
        self._delta = np.zeros((3, d), dtype=np.float64)  # count,sum,sumsq

    @torch.no_grad()
    def _act(self, params, obs: np.ndarray) -> np.ndarray:
        logits = models.policy_logits(
            params, torch.as_tensor(obs, device=self.device))
        if self.spec.discrete:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        return logits.cpu().numpy()  # deterministic mean action

    def set_filter(self, mean: np.ndarray, var: np.ndarray) -> None:
        self._mean = np.asarray(mean, dtype=np.float64)
        self._var = np.asarray(var, dtype=np.float64)

    def pop_filter_delta(self) -> np.ndarray:
        out, self._delta = self._delta, np.zeros_like(self._delta)
        return out

    def _norm(self, obs: np.ndarray) -> np.ndarray:
        if not self._normalize:
            return obs
        self._delta[0] += 1.0
        self._delta[1] += obs[0]
        self._delta[2] += obs[0] ** 2
        return ((obs - self._mean)
                / np.sqrt(self._var + 1e-8)).astype(np.float32)

    def episode_return(self, flat: np.ndarray) -> Tuple[float, int]:
        params = _unflatten(np.asarray(flat), self._meta, self.device)
        obs = self._env.reset()
        total, steps = 0.0, 0
        for _ in range(self._max_len):
            a = self._act(params, self._norm(obs))
            if not self.spec.discrete:
                a = np.clip(a, self.spec.action_low, self.spec.action_high)
            obs, r, d = self._env.step(a)
            total += float(r[0])
            steps += 1
            if d[0]:
                break
        return total, steps

    def evaluate(self, flat_center: np.ndarray, noise_seed: int,
                 episodes: int) -> Tuple[float, float, int]:
        """Antithetic pair: (mean return at center+eps, at center-eps,
        actual env steps consumed)."""
        center = np.asarray(flat_center)
        eps = _noise(noise_seed, len(center), self._std)
        steps = 0
        pos_r, neg_r = [], []
        for _ in range(episodes):
            r, n = self.episode_return(center + eps)
            pos_r.append(r)
            steps += n
            r, n = self.episode_return(center - eps)
            neg_r.append(r)
            steps += n
        return float(np.mean(pos_r)), float(np.mean(neg_r)), steps


class ES(Algorithm):
    need_env_runners = False  # whole-episode eval fleet instead

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return ESConfig()

    def build_learner(self) -> None:
        cfg = self.config
        params = models.init_policy(self.generator(cfg.seed), self.spec,
                                    cfg.hidden)
        self._center, self._meta = _flatten(params)
        n_workers = max(1, cfg.num_env_runners)
        self._workers = [
            _ESWorker(cfg.env, cfg.env_config, cfg.seed + 7919 * i,
                      cfg.hidden, cfg.noise_std, cfg.max_episode_len,
                      getattr(cfg, "normalize_obs", False),
                      device=self.device)
            for i in range(n_workers)
        ]
        self._rng = np.random.default_rng(cfg.seed)
        self.learner = self  # Algorithm.save/restore reach params via us

    def get_params(self):
        return _unflatten(self._center, self._meta, self.device)

    def set_params(self, params) -> None:
        self._center, self._meta = _flatten(params)

    def _evaluate_pairs(self, seeds: List[int]) -> List:
        """``evaluate`` of each seed's pair on the workers round robin, in
        submission order (JAX's order of results)."""
        cfg = self.config
        return [self._workers[i % len(self._workers)].evaluate(
            self._center, seeds[i], cfg.episodes_per_perturbation)
            for i in range(len(seeds))]

    def _draw_seeds(self) -> List[int]:
        return [int(s) for s in self._rng.integers(
            0, 2 ** 31 - 1, size=self.config.num_perturbations)]

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Whole episodes at the unperturbed center parameters. Discards
        the workers' obs-filter deltas afterward so evaluation episodes
        never shift ARS's fleet normalization statistics."""
        rets = [self._workers[i % len(self._workers)]
                .episode_return(self._center)[0]
                for i in range(num_episodes)]
        for w in self._workers:
            w.pop_filter_delta()
        return {"episodes": num_episodes,
                "episode_return_mean": float(np.mean(rets))}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        seeds = self._draw_seeds()
        results = self._evaluate_pairs(seeds)
        pos = np.array([r[0] for r in results])
        neg = np.array([r[1] for r in results])
        ranks = _centered_ranks(np.concatenate([pos, neg]))
        pos_r, neg_r = ranks[:len(pos)], ranks[len(pos):]
        grad = np.zeros_like(self._center)
        for seed, w in zip(seeds, pos_r - neg_r):
            grad += w * _noise(seed, len(self._center), cfg.noise_std)
        grad /= (len(seeds) * cfg.noise_std)
        self._center = self._center + cfg.lr * grad
        self._env_steps_total += int(sum(r[2] for r in results))
        return {
            "mean_return": float(np.mean(np.concatenate([pos, neg]))),
            "best_return": float(np.max(np.concatenate([pos, neg]))),
            "grad_norm": float(np.linalg.norm(grad)),
        }
