"""MAML: model-agnostic meta-learning for RL (port of
``ray_tpu/rl/algorithms/maml.py``).

Reference analog: ``rllib/algorithms/maml/maml.py`` (Finn et al. 2017).
Meta-train a policy initialization such that one (or a few) vanilla
policy-gradient steps on a new task's rollouts produce a good policy for
that task. The inner adaptation step is ``train_step.grad`` with
``create_graph`` inside the outer loss, so the meta-gradient that
``value_and_grad`` takes through it is the full second-order MAML
gradient (JAX: ``jax.grad`` inside ``jax.value_and_grad``).

Task distribution: ``PointGoal`` — a 2D point mass starting at the
origin must reach a per-task goal on a circle; the goal is NOT in the
observation, so the only way to locate it is to adapt on task rollouts
(the classic MAML-RL navigation benchmark). Tasks are episodic with a
dense ``-dist`` reward; the env is JAX's numpy env, unchanged.

The outer objective is the post-adaptation REINFORCE surrogate on fresh
rollouts collected under the ADAPTED parameters (the standard MAML-RL
estimator; the sampling distribution's own dependence on theta is
ignored, as in the reference). The action noise is drawn through
``models.normal`` from the trainable's generator (not JAX's key chain).
``pg_loss`` and ``adapt`` are MBMPO's estimator too.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.parallel.train_step import (_leaves, _unflatten_like,
                                               grad, value_and_grad)
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import DeviceTrainable
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import adam_init, adam_update


class PointGoal:
    """Vectorized 2D navigation to a hidden per-task goal."""

    def __init__(self, goal: Tuple[float, float], num_envs: int = 8,
                 horizon: int = 20, dt: float = 0.25, seed: int = 0):
        self.goal = np.asarray(goal, dtype=np.float32)
        self.num_envs = num_envs
        self.horizon = horizon
        self.dt = dt
        self._rng = np.random.default_rng(seed)
        self._pos = np.zeros((num_envs, 2), dtype=np.float32)
        self._t = np.zeros(num_envs, dtype=np.int64)

    def reset(self) -> np.ndarray:
        self._pos[:] = 0.02 * self._rng.standard_normal(
            self._pos.shape).astype(np.float32)
        self._t[:] = 0
        return self._pos.copy()

    def step(self, actions: np.ndarray):
        self._pos += self.dt * np.clip(actions, -1, 1)
        reward = -np.linalg.norm(self._pos - self.goal,
                                 axis=-1).astype(np.float32)
        self._t += 1
        dones = self._t >= self.horizon
        reset = dones
        if reset.any():
            self._pos[reset] = 0.02 * self._rng.standard_normal(
                (int(reset.sum()), 2)).astype(np.float32)
            self._t[reset] = 0
        return self._pos.copy(), reward, dones


class MAMLConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=MAML, **kwargs)
        # two moderate inner steps beat one large one here: a single
        # aggressive step lets the outer optimizer drift the base policy
        # outward (post-adaptation reward degrades while the "gain"
        # grows); 2 x 0.5 keeps both improving (swept)
        self.inner_lr = 0.5
        self.inner_steps = 2
        self.meta_batch_size = 8       # tasks per meta-update
        self.num_envs_per_runner = 16  # vector envs per task rollout
        self.horizon = 16
        self.lr = 1e-3                 # outer (meta) learning rate
        self.hidden = (64, 64)
        self.goal_radius = 1.0


def pg_loss(p: Dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The REINFORCE surrogate of a gaussian policy ``{pi, log_std}`` on
    ``{obs, acts, returns}``, returns normalised by their population std
    (``jnp.std``)."""
    mean = models.mlp_forward(p["pi"], batch["obs"])
    logp = models.gaussian_logp(mean, p["log_std"], batch["acts"])
    ret = batch["returns"]
    ret = (ret - ret.mean()) / (ret.std(correction=0) + 1e-8)
    return -torch.mean(logp * ret)


def adapt(p: Dict, batch: Dict[str, torch.Tensor], inner_lr: float,
          inner_steps: int, create_graph: bool = False) -> Dict:
    """``inner_steps`` of plain SGD on the task's REINFORCE loss. With
    ``create_graph`` the step is differentiable, so a meta-gradient taken
    through it is second-order."""
    for _ in range(inner_steps):
        g = grad(lambda q: pg_loss(q, batch), p, create_graph=create_graph)
        p = _unflatten_like(p, {k: w - inner_lr * g[k]
                                for k, w in _leaves(p).items()})
    return p


def meta_loss(p: Dict, pre_batches: List[Dict], post_batches: List[Dict],
              inner_lr: float, inner_steps: int) -> torch.Tensor:
    """The mean over tasks of the post-adaptation loss, differentiable
    through each task's inner steps."""
    total = 0.0
    for pre, post in zip(pre_batches, post_batches):
        total = total + pg_loss(adapt(p, pre, inner_lr, inner_steps,
                                      create_graph=True), post)
    return total / len(pre_batches)


class MAML(DeviceTrainable):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return MAMLConfig()

    def setup(self, config: Dict[str, Any]) -> None:
        self.config = self.config_from(config)
        cfg = self.config
        self._rng = np.random.default_rng(cfg.seed)
        self._gen = self.generator(cfg.seed + 1)
        # gaussian policy: mean MLP + global log_std
        self.params = {
            "pi": models.init_mlp(self.generator(cfg.seed),
                                  (2, *cfg.hidden, 2), out_scale=0.01),
            "log_std": torch.full((2,), -0.5, device=self.device),
        }
        self._opt_state = adam_init(self.params)
        self._env_steps_total = 0

    # -- the estimator ----------------------------------------------------

    def _adapt(self, params: Dict, batch: Dict) -> Dict:
        cfg = self.config
        return models.tree_map(torch.Tensor.detach, adapt(
            params, batch, cfg.inner_lr, cfg.inner_steps))

    def _meta_grad(self, params: Dict, pre_batches, post_batches):
        """(meta-loss, gradient by leaf name): second-order through every
        task's inner steps."""
        cfg = self.config
        return value_and_grad(
            lambda p: meta_loss(p, pre_batches, post_batches, cfg.inner_lr,
                                cfg.inner_steps), params)

    def _meta_update(self, pre_batches, post_batches) -> torch.Tensor:
        loss, flat = self._meta_grad(self.params, pre_batches, post_batches)
        self.params, self._opt_state = adam_update(
            self.params, _unflatten_like(self.params, flat), self._opt_state,
            self.config.lr)
        return loss

    @torch.no_grad()
    def _act(self, params: Dict, obs: np.ndarray) -> np.ndarray:
        mean = models.mlp_forward(params["pi"],
                                  torch.as_tensor(obs, device=self.device))
        return (mean + torch.exp(params["log_std"])
                * models.normal(self._gen, mean.shape)).cpu().numpy()

    # -- rollouts ---------------------------------------------------------

    def _sample_task(self) -> Tuple[float, float]:
        theta = self._rng.uniform(0, 2 * np.pi)
        r = self.config.goal_radius
        return (r * np.cos(theta), r * np.sin(theta))

    def _rollout(self, env: PointGoal, params) -> Tuple[Dict, float]:
        """One horizon of vectorized steps -> flat REINFORCE batch with
        per-timestep discounted return-to-go, on the device."""
        cfg = self.config
        obs_l, act_l, rew_l = [], [], []
        obs = env.reset()
        for _ in range(env.horizon):
            acts = self._act(params, obs)
            nobs, rew, _ = env.step(acts)
            obs_l.append(obs)
            act_l.append(acts)
            rew_l.append(rew)
            obs = nobs
        rews = np.stack(rew_l)                       # [T, N]
        rets = np.zeros_like(rews)
        acc = np.zeros(rews.shape[1], dtype=rews.dtype)
        for t in range(len(rews) - 1, -1, -1):
            acc = rews[t] + cfg.gamma * acc
            rets[t] = acc
        self._env_steps_total += rews.size
        batch = {"obs": np.concatenate(obs_l), "acts": np.concatenate(act_l),
                 "returns": rets.reshape(-1)}
        return ({k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}, float(rews.mean()))

    def _task_rollouts(self, env: PointGoal):
        """(pre batch, post batch, pre reward, post reward) of one task:
        a rollout of the current params, one of the adapted ones."""
        pre, pre_mr = self._rollout(env, self.params)
        post, post_mr = self._rollout(env, self._adapt(self.params, pre))
        return pre, post, pre_mr, post_mr

    # -- Trainable API ----------------------------------------------------

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        pre_batches, post_batches = [], []
        pre_r, post_r = [], []
        for _ in range(cfg.meta_batch_size):
            goal = self._sample_task()
            env = PointGoal(goal, cfg.num_envs_per_runner, cfg.horizon,
                            seed=int(self._rng.integers(1 << 31)))
            pre, post, pre_mr, post_mr = self._task_rollouts(env)
            pre_r.append(pre_mr)
            post_r.append(post_mr)
            pre_batches.append(pre)
            post_batches.append(post)
        loss = self._meta_update(pre_batches, post_batches)
        return {"meta_loss": float(loss),
                "pre_adapt_reward": float(np.mean(pre_r)),
                "post_adapt_reward": float(np.mean(post_r)),
                "adaptation_gain": float(np.mean(post_r) - np.mean(pre_r)),
                # the CLI's display/stop metric: post-adaptation reward is
                # the quantity MAML optimizes
                "mean_return": float(np.mean(post_r)),
                "env_steps_total": self._env_steps_total}

    def evaluate(self, num_tasks: int = 8) -> Dict[str, float]:
        """Adaptation gain on FRESH tasks: reward before vs after the
        inner-loop update (the quantity MAML optimizes). Training state
        (task rng, action generator, step counters) is restored afterwards
        so mid-training evaluation never shifts the training trajectory."""
        cfg = self.config
        rng_state = self._rng.bit_generator.state
        gen_state = self._gen.get_state()
        steps_before = self._env_steps_total
        try:
            pre_r, post_r = [], []
            for _ in range(num_tasks):
                env = PointGoal(self._sample_task(),
                                cfg.num_envs_per_runner, cfg.horizon,
                                seed=int(self._rng.integers(1 << 31)))
                _, _, pre_mr, post_mr = self._task_rollouts(env)
                pre_r.append(pre_mr)
                post_r.append(post_mr)
        finally:
            self._rng.bit_generator.state = rng_state
            self._gen.set_state(gen_state)
            self._env_steps_total = steps_before
        return {"pre_adapt_reward": float(np.mean(pre_r)),
                "post_adapt_reward": float(np.mean(post_r)),
                "adaptation_gain": float(np.mean(post_r)
                                         - np.mean(pre_r))}

    def get_params(self):
        return self.params

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        return {"params": params_to_numpy(self.params),
                "env_steps_total": self._env_steps_total}

    def load_checkpoint(self, checkpoint: Dict) -> None:
        self.params = models.params_to_device(checkpoint["params"],
                                              self.device)
        self._env_steps_total = checkpoint.get("env_steps_total", 0)
