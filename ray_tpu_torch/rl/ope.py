"""Off-policy evaluation estimators: IS / WIS / DM / DR (the port's own
copy of ``ray_tpu/rl/ope.py``).

Reference analog: ``rllib/offline/estimators/`` —
``importance_sampling.py``, ``weighted_importance_sampling.py``,
``direct_method.py``, ``doubly_robust.py`` (step-wise DR per Jiang & Li
2016, the reference's cited formulation). Redesigned functional: estimators
are pure numpy over an episode list plus policy callables, with no coupling
to the sampling stack — offline batches from ``data`` readers or the replay
buffer both fit.

Episode format: dict with ``rewards`` [T], ``behavior_logp`` [T], and for
the target policy a per-episode ``target_logp`` [T] (precomputed by the
caller via its policy; the module is numpy only). DM/DR additionally
take ``q_values`` [T, A] and ``target_probs`` [T, A].
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _cum_weights(ep: Dict, clip: float) -> np.ndarray:
    """ρ_{0:t}: cumulative importance weights, optionally clipped."""
    w = np.exp(np.asarray(ep["target_logp"], np.float64)
               - np.asarray(ep["behavior_logp"], np.float64))
    if clip:
        w = np.minimum(w, clip)
    return np.cumprod(w)


def _discounts(t: int, gamma: float) -> np.ndarray:
    return gamma ** np.arange(t)


def importance_sampling(episodes: Sequence[Dict], gamma: float = 1.0,
                        weight_clip: float = 0.0) -> Dict[str, float]:
    """Ordinary per-decision IS: V = E_i[ Σ_t γ^t ρ_{0:t} r_t ]."""
    v_b, v_t = [], []
    for ep in episodes:
        r = np.asarray(ep["rewards"], np.float64)
        g = _discounts(len(r), gamma)
        rho = _cum_weights(ep, weight_clip)
        v_b.append(float((g * r).sum()))
        v_t.append(float((g * rho * r).sum()))
    return {"v_behavior": float(np.mean(v_b)),
            "v_target": float(np.mean(v_t)),
            "v_gain": float(np.mean(v_t) / (np.mean(v_b) or 1.0))}


def weighted_importance_sampling(episodes: Sequence[Dict],
                                 gamma: float = 1.0,
                                 weight_clip: float = 0.0
                                 ) -> Dict[str, float]:
    """WIS: per-timestep self-normalized weights — biased, far lower
    variance (the reference's default go-to estimator)."""
    t_max = max(len(ep["rewards"]) for ep in episodes)
    n = len(episodes)
    rho = np.zeros((n, t_max), np.float64)
    rew = np.zeros((n, t_max), np.float64)
    alive = np.zeros((n, t_max), np.float64)
    for i, ep in enumerate(episodes):
        t = len(ep["rewards"])
        rho[i, :t] = _cum_weights(ep, weight_clip)
        rew[i, :t] = ep["rewards"]
        alive[i, :t] = 1.0
    # normalizer: mean cumulative weight among episodes still alive at t
    denom = (rho * alive).sum(0) / np.maximum(alive.sum(0), 1.0)
    denom = np.where(denom <= 0, 1.0, denom)
    g = _discounts(t_max, gamma)
    v_t = (g * (rho / denom) * rew).sum(1).mean()
    v_b = (g * rew).sum(1).mean()
    return {"v_behavior": float(v_b), "v_target": float(v_t),
            "v_gain": float(v_t / (v_b or 1.0))}


def direct_method(episodes: Sequence[Dict], gamma: float = 1.0
                  ) -> Dict[str, float]:
    """DM: V = E_i[ Σ_a π(a|s_0) Q(s_0, a) ] — all model, no correction."""
    v_t, v_b = [], []
    for ep in episodes:
        q0 = np.asarray(ep["q_values"], np.float64)[0]
        p0 = np.asarray(ep["target_probs"], np.float64)[0]
        v_t.append(float((p0 * q0).sum()))
        r = np.asarray(ep["rewards"], np.float64)
        v_b.append(float((_discounts(len(r), gamma) * r).sum()))
    return {"v_behavior": float(np.mean(v_b)),
            "v_target": float(np.mean(v_t)),
            "v_gain": float(np.mean(v_t) / (np.mean(v_b) or 1.0))}


def doubly_robust(episodes: Sequence[Dict], gamma: float = 1.0,
                  weight_clip: float = 0.0) -> Dict[str, float]:
    """Step-wise DR (Jiang & Li 2016):
    v_t = V̂(s_t) + ρ_t (r_t + γ v_{t+1} - Q̂(s_t, a_t)),  backwards in t.

    Unbiased if EITHER the Q-model or the importance weights are right —
    the property the test suite checks with a deliberately wrong model.
    """
    v_t, v_b = [], []
    for ep in episodes:
        r = np.asarray(ep["rewards"], np.float64)
        q = np.asarray(ep["q_values"], np.float64)        # [T, A]
        probs = np.asarray(ep["target_probs"], np.float64)  # [T, A]
        acts = np.asarray(ep["actions"], np.int64)
        w = np.exp(np.asarray(ep["target_logp"], np.float64)
                   - np.asarray(ep["behavior_logp"], np.float64))
        if weight_clip:
            w = np.minimum(w, weight_clip)
        v_hat = (probs * q).sum(1)                         # V̂(s_t)
        q_taken = q[np.arange(len(r)), acts]               # Q̂(s_t, a_t)
        v = 0.0
        for t in range(len(r) - 1, -1, -1):
            v = v_hat[t] + w[t] * (r[t] + gamma * v - q_taken[t])
        v_t.append(float(v))
        v_b.append(float((_discounts(len(r), gamma) * r).sum()))
    return {"v_behavior": float(np.mean(v_b)),
            "v_target": float(np.mean(v_t)),
            "v_gain": float(np.mean(v_t) / (np.mean(v_b) or 1.0))}


ESTIMATORS = {
    "is": importance_sampling,
    "wis": weighted_importance_sampling,
    "dm": direct_method,
    "dr": doubly_robust,
}


def estimate(method: str, episodes: Sequence[Dict], **kwargs
             ) -> Dict[str, float]:
    if method not in ESTIMATORS:
        raise ValueError(f"unknown estimator {method!r}; "
                         f"have {sorted(ESTIMATORS)}")
    return ESTIMATORS[method](episodes, **kwargs)


def episodes_from_batch(batch: Dict[str, np.ndarray],
                        num_envs: int = 1) -> List[Dict]:
    """Split a flat columnar batch (with ``dones``) into episode dicts —
    the bridge from offline datasets / sample batches to the estimators.

    ``EnvRunner.sample`` flattens its ``[T, N]`` buffers time-major
    (row ``t*N + n`` is env ``n`` at step ``t``), so batches collected with
    ``num_envs_per_runner > 1`` interleave environments; pass that count as
    ``num_envs`` so rows are first de-interleaved per env — splitting the
    raw interleaved rows on ``dones`` would stitch timesteps of unrelated
    trajectories into one "episode" and silently corrupt the estimates.
    """
    dones = np.asarray(batch["dones"]).astype(bool)
    if dones.size == 0:
        return []
    if num_envs > 1:
        if len(dones) % num_envs:
            raise ValueError(
                f"batch length {len(dones)} not divisible by "
                f"num_envs={num_envs}")
        episodes = []
        for n in range(num_envs):
            episodes.extend(episodes_from_batch(
                {k: np.asarray(v)[n::num_envs] for k, v in batch.items()}))
        return episodes
    bounds = np.flatnonzero(dones) + 1
    episodes = []
    start = 0
    for end in list(bounds) + ([len(dones)] if not dones[-1] else []):
        if end <= start:
            continue
        episodes.append({k: np.asarray(v)[start:end]
                         for k, v in batch.items()})
        start = end
    return episodes
