"""SlateQ: Q-learning for slate recommendation (port of
``ray_tpu/rl/algorithms/slateq.py``).

Reference analog: ``rllib/algorithms/slateq/slateq.py`` (Ie et al. 2019,
on RecSim). The action is a SLATE of k documents from an m-document
candidate set; SlateQ makes the combinatorial action space tractable by
decomposing the slate value under a conditional user-choice model:

    Q(s, A) = sum_{i in A} P(click = i | s, A) * Q(s, i)

with per-ITEM Q-values. With multinomial-logit choice (score-proportional
clicks), the greedy slate is the top-k items by choice-weighted Q, so
both action selection and the TD target stay O(m log m).

``RecSlateEnv`` is the bundled RecSim analog: users carry an interest
vector that nudges toward clicked documents; the click model is a
softmax over ``interest . doc`` scores with a no-click option; reward is
the clicked document's engagement. Observations expose the user interest
and every candidate's features (the same flattened layout RecSim's
wrappers produce). It is a numpy copy of JAX's: with the same seed and
slates both step bit for bit alike.

The per-item Q net and its target live in one params tree ``{q,
target}`` on the trainable's device. The TD loss takes its gradient
through the clicked item's Q only: the greedy next slate (``torch.topk``,
sorted, since the slate position decides the click) and the target's
slate value are built under ``no_grad``, JAX's ``stop_gradient``. After
every update the target leaves are put back as they were, and every
``target_update_freq`` updates they become a copy of ``q`` that shares no
storage with it. Exploration slates come from numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import DeviceTrainable
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.evaluation import ReturnWindow, run_episodes
from ray_tpu_torch.rl.learner import Learner, mean_metrics
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer


class RecSlateEnv:
    """Vectorized slate-recommendation episodes."""

    def __init__(self, num_envs: int = 8, num_docs: int = 10,
                 slate_size: int = 3, feat_dim: int = 4,
                 horizon: int = 20, no_click_bias: float = 1.0,
                 interest_lr: float = 0.2, seed: int = 0):
        self.num_envs = num_envs
        self.num_docs = num_docs
        self.slate_size = slate_size
        self.feat_dim = feat_dim
        self.horizon = horizon
        self.no_click_bias = no_click_bias
        self.interest_lr = interest_lr
        self._rng = np.random.default_rng(seed)
        self._t = np.zeros(num_envs, dtype=np.int64)
        self._user = np.zeros((num_envs, feat_dim), dtype=np.float32)
        self._docs = np.zeros((num_envs, num_docs, feat_dim),
                              dtype=np.float32)
        self._quality = np.zeros((num_envs, num_docs), dtype=np.float32)
        self._reset_envs(np.ones(num_envs, dtype=bool))

    def _reset_envs(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if not n:
            return

        def unit(x):
            return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-8)

        self._user[mask] = unit(self._rng.standard_normal(
            (n, self.feat_dim)).astype(np.float32))
        self._docs[mask] = unit(self._rng.standard_normal(
            (n, self.num_docs, self.feat_dim)).astype(np.float32))
        self._quality[mask] = self._rng.uniform(
            0.2, 1.0, (n, self.num_docs)).astype(np.float32)
        self._t[mask] = 0

    def obs(self) -> np.ndarray:
        """[N, feat + docs*(feat+1)]: user interest ++ per-doc features
        and quality (the candidate set IS part of the observation)."""
        docs = np.concatenate(
            [self._docs, self._quality[..., None]], axis=-1)
        return np.concatenate(
            [self._user, docs.reshape(self.num_envs, -1)],
            axis=-1).astype(np.float32)

    @property
    def obs_dim(self) -> int:
        return self.feat_dim + self.num_docs * (self.feat_dim + 1)

    def reset(self) -> np.ndarray:
        self._reset_envs(np.ones(self.num_envs, dtype=bool))
        return self.obs()

    def choice_probs(self, slates: np.ndarray) -> np.ndarray:
        """Multinomial-logit user choice over a [N, k] slate; returns
        [N, k+1] probs, last column = no-click."""
        scores = np.take_along_axis(
            np.einsum("nf,ndf->nd", self._user, self._docs),
            slates, axis=1)                                  # [N, k]
        logits = np.concatenate(
            [scores, np.full((self.num_envs, 1), self.no_click_bias,
                             dtype=np.float32)], axis=1)
        z = np.exp(logits - logits.max(axis=1, keepdims=True))
        return z / z.sum(axis=1, keepdims=True)

    def step(self, slates: np.ndarray):
        """slates [N, k] int doc indices -> (obs, reward, done, clicked)
        where clicked is the chosen slate POSITION or -1 for no-click."""
        probs = self.choice_probs(slates)
        u = self._rng.random((self.num_envs, 1))
        choice = (probs.cumsum(axis=1) < u).sum(axis=1)      # [N] in 0..k
        clicked_pos = np.where(choice < self.slate_size, choice, -1)
        reward = np.zeros(self.num_envs, dtype=np.float32)
        hit = clicked_pos >= 0
        if hit.any():
            doc_idx = np.take_along_axis(
                slates[hit], clicked_pos[hit][:, None], axis=1)[:, 0]
            reward[hit] = self._quality[hit, doc_idx]
            # interest drifts toward consumed content
            d = self._docs[hit, doc_idx]
            self._user[hit] = (1 - self.interest_lr) * self._user[hit] \
                + self.interest_lr * d
            self._user[hit] /= (np.linalg.norm(
                self._user[hit], axis=-1, keepdims=True) + 1e-8)
        self._t += 1
        dones = self._t >= self.horizon
        self._reset_envs(dones)
        return self.obs(), reward, dones, clicked_pos


class SlateQConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=SlateQ, **kwargs)
        self.lr = 1e-3
        self.minibatch_size = 128
        self.buffer_size = 50_000
        self.learning_starts = 500
        self.target_update_freq = 200
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 10_000
        self.updates_per_iter = 32
        self.num_docs = 10
        self.slate_size = 3
        self.feat_dim = 4
        self.recsim_horizon = 20


class SlateFns:
    """SlateQ's functions of one candidate layout: ``m`` docs, slates of
    ``k``, ``f`` user features (each doc carries ``f`` features and a
    quality), the env's no-click logit."""

    def __init__(self, m: int, k: int, f: int, no_click: float):
        self.m, self.k, self.f, self.no_click = m, k, f, no_click

    def split_obs(self, obs):
        user = obs[:, :self.f]                                # [B, f]
        docs = obs[:, self.f:].reshape(-1, self.m, self.f + 1)
        return user, docs

    def item_qs(self, net, obs):
        """[B, m] per-item Q over the full candidate set."""
        user, docs = self.split_obs(obs)
        rep = user[:, None].expand(user.shape[0], self.m, self.f)
        x = torch.cat([rep, docs], dim=-1)
        return models.mlp_forward(net, x)[..., 0]

    def _scores(self, obs):
        user, docs = self.split_obs(obs)
        return torch.einsum("bf,bmf->bm", user, docs[..., :self.f])

    def choice_weights(self, obs, slate_idx):
        """softmax(interest . doc) over slate + no-click -> [B, k] click
        probs for each slate position."""
        s = torch.gather(self._scores(obs), 1, slate_idx)     # [B, k]
        logits = torch.cat([s, torch.full((s.shape[0], 1), self.no_click,
                                          dtype=s.dtype, device=s.device)],
                           dim=1)
        return torch.softmax(logits, dim=1)[:, :self.k]

    def greedy_slate(self, net, obs):
        """Top-k by choice-weighted Q — the reference's top-k heuristic,
        in descending order (``lax.top_k``'s).

        Maximizes the unnormalized sum(w_i * Q_i), not the true MNL slate
        value sum(w_i*Q_i)/(w_noclick + sum(w_i)); exact when Q >= 0 and
        the no-click weight dominates, otherwise a heuristic bound."""
        q = self.item_qs(net, obs)                            # [B, m]
        w = torch.exp(self._scores(obs))  # choice propensity
        return torch.topk(w * q, self.k, dim=1, sorted=True).indices

    def slate_value(self, net, obs, slate_idx):
        """Q(s, A) under the decomposition."""
        qs = torch.gather(self.item_qs(net, obs), 1, slate_idx)  # [B, k]
        return torch.sum(self.choice_weights(obs, slate_idx) * qs, dim=1)


def make_slateq_loss(fns: SlateFns, gamma: float):
    """``loss_fn(params, batch, gen)`` over ``{q, target}``: TD on the
    CLICKED item's Q (no-click transitions carry no item gradient,
    matching the SlateQ decomposition) to a bootstrap from the target's
    value of ``q``'s greedy next slate, outside the gradient."""
    def loss_fn(p, batch, gen=None):
        q_all = fns.item_qs(p["q"], batch["obs"])             # [B, m]
        clicked_doc = batch["clicked_doc"].long()             # [B] (or -1)
        hit = (clicked_doc >= 0).float()
        safe_idx = torch.clamp(clicked_doc, min=0)
        q_clicked = torch.gather(q_all, 1, safe_idx[:, None])[:, 0]
        with torch.no_grad():   # JAX's stop_gradient
            next_slate = fns.greedy_slate(p["q"], batch["next_obs"])
            v_next = fns.slate_value(p["target"], batch["next_obs"],
                                     next_slate)
            nonterm = 1.0 - batch["dones"].float()
            target = batch["rewards"] + gamma * nonterm * v_next
        td = (q_clicked - target) * hit
        n_hit = torch.clamp(hit.sum(), min=1.0)
        loss = torch.sum(td ** 2) / n_hit
        return loss, {"td_abs_mean": torch.sum(torch.abs(td)) / n_hit,
                      "click_rate": hit.mean(),
                      "q_clicked_mean": torch.sum(q_clicked * hit) / n_hit}

    return loss_fn


class SlateQ(DeviceTrainable):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return SlateQConfig()

    def setup(self, config: Dict[str, Any]) -> None:
        self.config: AlgorithmConfig = self.config_from(config)
        cfg = self.config
        self.env = self._make_env(cfg.seed)
        m, k, f = cfg.num_docs, cfg.slate_size, cfg.feat_dim
        self.fns = SlateFns(m, k, f, self.env.no_click_bias)
        # per-item Q net: (user interest ++ doc features) -> scalar
        qnet = models.init_mlp(self.generator(cfg.seed),
                               (f + f + 1, *cfg.hidden, 1), out_scale=1.0)
        params = {"q": qnet, "target": models.clone_tree(qnet)}
        self.learner = Learner(params, make_slateq_loss(self.fns, cfg.gamma),
                               cfg.lr, grad_clip=cfg.grad_clip,
                               seed=cfg.seed, device=self.device)
        self._updates = 0
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._rng = np.random.default_rng(cfg.seed)
        self._obs = self.env.reset()
        self._env_steps_total = 0
        self._returns = ReturnWindow(self.env.num_envs)

    def _make_env(self, seed: int) -> RecSlateEnv:
        cfg = self.config
        return RecSlateEnv(
            num_envs=cfg.num_envs_per_runner, num_docs=cfg.num_docs,
            slate_size=cfg.slate_size, feat_dim=cfg.feat_dim,
            horizon=cfg.recsim_horizon, seed=seed,
            **(cfg.env_config or {}))

    @torch.no_grad()
    def _greedy_slate(self, net, obs: np.ndarray) -> np.ndarray:
        """The greedy slates [N, k]: one forward and one host read."""
        return self.fns.greedy_slate(
            net, torch.as_tensor(obs, device=self.device)).cpu().numpy()

    @property
    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps_total
                   / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial \
            + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    def _pick_slates(self, obs: np.ndarray, epsilon: float) -> np.ndarray:
        cfg = self.config
        n = self.env.num_envs
        slates = self._greedy_slate(self.learner.get_params()["q"], obs)
        explore = self._rng.random(n) < epsilon
        for i in np.nonzero(explore)[0]:
            slates[i] = self._rng.choice(cfg.num_docs, cfg.slate_size,
                                         replace=False)
        return slates

    def _collect(self, steps: int) -> None:
        n_envs = self.env.num_envs
        for _ in range(steps):
            obs = self._obs
            slates = self._pick_slates(obs, self._epsilon)
            next_obs, rewards, dones, clicked_pos = self.env.step(slates)
            clicked_doc = np.where(
                clicked_pos >= 0,
                np.take_along_axis(
                    slates, np.maximum(clicked_pos, 0)[:, None],
                    axis=1)[:, 0],
                -1)
            self.buffer.add_batch(
                {"obs": obs, "clicked_doc": clicked_doc.astype(np.int32),
                 "rewards": rewards, "dones": dones.astype(np.float32),
                 "next_obs": next_obs})
            self._env_steps_total += n_envs
            self._returns.add(rewards, dones)
            self._obs = next_obs

    def _sync_target(self) -> None:
        """``target`` becomes a copy of ``q`` that shares no storage."""
        p = self.learner.params
        self.learner.params = dict(p, target=models.clone_tree(p["q"]))

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        self._collect(cfg.rollout_fragment_length)
        metrics: Dict[str, Any] = {"epsilon": self._epsilon,
                                   "buffer_size": len(self.buffer)}
        if len(self.buffer) >= cfg.learning_starts:
            mlist = []
            for _ in range(cfg.updates_per_iter or 1):
                mb = self.buffer.sample(cfg.minibatch_size)
                target_before = self.learner.params["target"]
                mlist.append(self.learner.update_minibatch(mb))
                self.learner.params = dict(self.learner.params,
                                           target=target_before)
                self._updates += 1
                if self._updates % cfg.target_update_freq == 0:
                    self._sync_target()
            metrics.update(mean_metrics(mlist))
        metrics["env_steps_total"] = self._env_steps_total
        mean_ret = self._returns.mean()
        if mean_ret is not None:
            metrics["episode_return_mean"] = mean_ret
        return metrics

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Greedy slates on a fresh env."""
        env = self._make_env(self.config.seed + 777)
        state = {"obs": env.reset()}
        qnet = self.learner.get_params()["q"]

        def step():
            slates = self._greedy_slate(qnet, state["obs"])
            state["obs"], rewards, dones, _ = env.step(slates)
            return rewards, dones

        return run_episodes(step, num_episodes, env.num_envs)

    def get_params(self):
        return self.learner.get_params()

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        return {"params": params_to_numpy(self.learner.get_params()),
                "env_steps_total": self._env_steps_total,
                "updates": self._updates}

    def load_checkpoint(self, checkpoint: Dict) -> None:
        self.learner.set_params(checkpoint["params"])
        self._env_steps_total = checkpoint.get("env_steps_total", 0)
        self._updates = checkpoint.get("updates", 0)
