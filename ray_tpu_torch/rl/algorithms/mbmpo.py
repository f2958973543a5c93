"""MBMPO: model-based meta-policy optimization (Clavera et al. 2018), port
of ``ray_tpu/rl/algorithms/mbmpo.py``.

Reference analog: ``rllib/algorithms/mbmpo/`` (``mbmpo.py``,
``model_ensemble.py``): learn an ensemble of K transition-dynamics models
from real rollouts, then treat each model as a MAML "task" — meta-learn a
policy that adapts to any member in one inner PG step, making it robust to
model error.

- the K models are ONE weight-stacked MLP (every leaf [K, ...]); an
  update runs all members as batched matmuls on the stacked leaves (JAX's
  ``vmap`` over members), each member's gradient that of its own mean
  loss on its own bootstrap minibatch.
- each model predicts (normalized delta-obs, reward), so envs need no
  hand-coded ``reward()``.
- the meta-gradient is MAML's second-order estimator (``maml.adapt``
  with ``create_graph``, sampling dependence ignored, imagined batches
  computed without gradient), taken over the members in a loop (JAX
  ``vmap``s it); each member's two imagined rollouts are H-step Python
  loops that draw the policy's noise through ``models.normal`` from the
  trainable's generator (not JAX's key chain).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.parallel.train_step import _unflatten_like, value_and_grad
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import DeviceTrainable
from ray_tpu_torch.rl.algorithms.maml import adapt, pg_loss
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import adam_init, adam_update


class MBMPOConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=MBMPO, **kwargs)
        self.env = "Pendulum-v1"
        self.num_envs_per_runner = 16   # real-env vector width
        self.real_steps_per_iter = 400  # real transitions collected / iter
        self.buffer_size = 100_000
        # dynamics ensemble
        self.ensemble_size = 5
        self.model_hidden = (256, 256)
        self.model_lr = 1e-3
        self.model_epochs = 5
        self.model_batch = 256
        self.val_frac = 0.1
        # imagination + MAML
        self.imag_horizon = 16
        self.imag_envs = 32
        self.inner_lr = 0.1
        self.inner_steps = 1
        self.meta_steps_per_iter = 8    # MAML outer steps per fitted
        # ensemble (reference: maml_optimizer_steps)
        self.lr = 3e-4                  # meta (outer) learning rate
        self.hidden = (64, 64)
        self.exploration_noise = 0.5    # std of the gaussian policy at init


def ensemble_forward(mp: Dict, x: torch.Tensor) -> torch.Tensor:
    """The [K]-stacked tanh MLP on ``x`` [K, B, in] (a minibatch per
    member) or [B, in] (shared by all) -> [K, B, out]."""
    h = x
    n = len(mp["layers"])
    for i, layer in enumerate(mp["layers"]):
        h = h @ layer["w"] + layer["b"][:, None, :]
        if i < n - 1:
            h = torch.tanh(h)
    return h


def member_losses(mp: Dict, x: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    """Each member's mean squared error [K]."""
    return torch.mean((ensemble_forward(mp, x) - y) ** 2, dim=(1, 2))


def model_update(mp: Dict, mopt: Dict, xs: torch.Tensor, ys: torch.Tensor,
                 lr: float):
    """One Adam step for ALL K members at once on per-member minibatches
    ``xs``/``ys`` [K, B, ...]: the members' params are disjoint, so the
    gradient of the summed losses is each member's own. Returns (params,
    state, mean loss)."""
    total, flat = value_and_grad(lambda m: member_losses(m, xs, ys).sum(),
                                 mp)
    mp, mopt = adam_update(mp, _unflatten_like(mp, flat), mopt, lr)
    return mp, mopt, total / xs.shape[0]


def member(mp: Dict, k: int) -> Dict:
    """Member ``k``'s MLP out of the stacked ensemble."""
    return models.tree_map(lambda t: t[k], mp)


@torch.no_grad()
def imagine(p: Dict, mp_k: Dict, norm: Dict[str, torch.Tensor],
            start_obs: torch.Tensor, gen: torch.Generator, horizon: int,
            gamma: float, low: float, high: float
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """An H-step rollout of policy ``p`` inside one member's model from
    real start states, without gradient (JAX stop-gradients the policy
    and the batch): the flat REINFORCE batch with discounted
    returns-to-go, and the mean imagined reward."""
    obs = start_obs
    obs_t, act_t, rew_t = [], [], []
    for _ in range(horizon):
        mean = models.mlp_forward(p["pi"], obs)
        a = torch.clamp(mean + torch.exp(p["log_std"])
                        * models.normal(gen, mean.shape), low, high)
        x = (torch.cat([obs, a], -1) - norm["x_mean"]) / norm["x_std"]
        y = models.mlp_forward(mp_k, x) * norm["y_std"] + norm["y_mean"]
        obs_t.append(obs)
        act_t.append(a)
        rew_t.append(y[..., -1])
        obs = obs + y[..., :-1]
    acc = torch.zeros_like(rew_t[0])
    rets = [None] * horizon
    for t in range(horizon - 1, -1, -1):
        acc = rew_t[t] + gamma * acc
        rets[t] = acc
    n = start_obs.shape[0]
    batch = {"obs": torch.stack(obs_t).reshape(horizon * n, -1),
             "acts": torch.stack(act_t).reshape(horizon * n, -1),
             "returns": torch.stack(rets).reshape(horizon * n)}
    return batch, torch.stack(rew_t).mean()


class MBMPO(DeviceTrainable):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return MBMPOConfig()

    def setup(self, config: Dict[str, Any]) -> None:
        self.config = self.config_from(config)
        cfg = self.config
        self.env = make_env(cfg.env, cfg.num_envs_per_runner,
                            cfg.env_config, seed=cfg.seed)
        spec = self.env.spec
        if spec.action_dim == 0:
            raise ValueError("MBMPO needs a continuous-action env "
                             f"({cfg.env!r} is discrete)")
        D, A, K = spec.obs_dim, spec.action_dim, cfg.ensemble_size
        self._D, self._A = D, A
        self._low = float(spec.action_low)
        self._high = float(spec.action_high)
        self._rng = np.random.default_rng(cfg.seed)
        self._gen = self.generator(cfg.seed + 1)
        self._env_steps_total = 0

        # -- policy (gaussian MLP, as maml.py) ----------------------------
        self.params = {
            "pi": models.init_mlp(self.generator(cfg.seed),
                                  (D, *cfg.hidden, A), out_scale=0.01),
            "log_std": torch.full((A,), float(np.log(cfg.exploration_noise)),
                                  device=self.device),
        }
        self._opt_state = adam_init(self.params)

        # -- dynamics ensemble: weight-stacked [K, ...] MLPs --------------
        mgen = self.generator(cfg.seed + 7)
        members = [models.init_mlp(mgen, (D + A, *cfg.model_hidden, D + 1),
                                   out_scale=0.1) for _ in range(K)]
        self.model_params = models.tree_map(lambda *ls: torch.stack(ls),
                                            *members)
        self._model_opt_state = adam_init(self.model_params)

        # identity normalizers until real data arrives
        self._norm = {
            "x_mean": np.zeros(D + A, np.float32),
            "x_std": np.ones(D + A, np.float32),
            "y_mean": np.zeros(D + 1, np.float32),
            "y_std": np.ones(D + 1, np.float32),
        }
        self._buf: Dict[str, list] = {k: [] for k in
                                      ("obs", "act", "delta", "rew")}

    # -- the estimator ----------------------------------------------------

    def _imagine(self, p, mp_k, norm, start_obs):
        cfg = self.config
        return imagine(p, mp_k, norm, start_obs, self._gen, cfg.imag_horizon,
                       cfg.gamma, self._low, self._high)

    def task_loss(self, p: Dict, mp_k: Dict, norm: Dict,
                  start_obs: torch.Tensor):
        """One member as a MAML task: imagine, adapt (differentiably),
        imagine with the adapted policy, its loss. Returns (loss, pre
        reward, post reward)."""
        cfg = self.config
        pre, pre_rew = self._imagine(p, mp_k, norm, start_obs)
        p_ad = adapt(p, pre, cfg.inner_lr, cfg.inner_steps,
                     create_graph=True)
        post, post_rew = self._imagine(p_ad, mp_k, norm, start_obs)
        return pg_loss(p_ad, post), pre_rew, post_rew

    def meta_loss(self, p: Dict, mp: Dict, norm: Dict,
                  start_obs: torch.Tensor):
        """The mean over the members of their task losses, and the mean
        pre- and post-adaptation imagined rewards (a loop over the members
        in order)."""
        losses, pre, post = [], [], []
        for k in range(self.config.ensemble_size):
            loss, pre_rew, post_rew = self.task_loss(p, member(mp, k), norm,
                                                     start_obs)
            losses.append(loss)
            pre.append(pre_rew)
            post.append(post_rew)
        return torch.stack(losses).mean(), {"pre": torch.stack(pre).mean(),
                                            "post": torch.stack(post).mean()}

    def _meta_step(self, norm: Dict, start_obs: torch.Tensor):
        (loss, aux), flat = value_and_grad(
            lambda p: self.meta_loss(p, self.model_params, norm, start_obs),
            self.params, has_aux=True)
        self.params, self._opt_state = adam_update(
            self.params, _unflatten_like(self.params, flat),
            self._opt_state, self.config.lr)
        return loss, aux

    @torch.no_grad()
    def _act(self, params: Dict, obs: np.ndarray) -> np.ndarray:
        mean = models.mlp_forward(params["pi"],
                                  torch.as_tensor(obs, device=self.device))
        a = mean + torch.exp(params["log_std"]) * models.normal(self._gen,
                                                                mean.shape)
        return torch.clamp(a, self._low, self._high).cpu().numpy()

    # -- real-env interaction ---------------------------------------------

    def _collect_real(self, n_steps: int) -> float:
        cfg = self.config
        obs = self.env.reset() if not self._buf["obs"] else self._last_obs
        rew_sum, count = 0.0, 0
        steps = max(1, n_steps // self.env.num_envs)
        for _ in range(steps):
            acts = self._act(self.params, obs)
            nobs, rew, dones = self.env.step(acts)
            # a done row's next_obs is the RESET obs — its delta is not a
            # dynamics transition; drop those rows from the model dataset
            keep = ~dones
            self._buf["obs"].append(obs[keep])
            self._buf["act"].append(
                acts[keep].reshape(int(keep.sum()), self._A))
            self._buf["delta"].append((nobs - obs)[keep])
            self._buf["rew"].append(rew[keep])
            rew_sum += float(rew.sum())
            count += rew.size
            obs = nobs
        self._last_obs = obs
        self._env_steps_total += count
        # trim ring
        total = sum(len(a) for a in self._buf["obs"])
        while total > cfg.buffer_size and len(self._buf["obs"]) > 1:
            total -= len(self._buf["obs"][0])
            for k in self._buf:
                self._buf[k].pop(0)
        return rew_sum / max(1, count)

    def _dataset(self) -> Tuple[np.ndarray, np.ndarray]:
        obs = np.concatenate(self._buf["obs"])
        act = np.concatenate(self._buf["act"])
        delta = np.concatenate(self._buf["delta"])
        rew = np.concatenate(self._buf["rew"])[:, None]
        x = np.concatenate([obs, act], -1).astype(np.float32)
        y = np.concatenate([delta, rew], -1).astype(np.float32)
        return x, y

    def _fit_ensemble(self) -> Dict[str, float]:
        cfg = self.config
        x, y = self._dataset()
        self._norm = {
            "x_mean": x.mean(0), "x_std": x.std(0) + 1e-6,
            "y_mean": y.mean(0), "y_std": y.std(0) + 1e-6,
        }
        xn = (x - self._norm["x_mean"]) / self._norm["x_std"]
        yn = (y - self._norm["y_mean"]) / self._norm["y_std"]
        n = len(xn)
        n_val = max(1, int(n * cfg.val_frac))
        perm = self._rng.permutation(n)
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        B = min(cfg.model_batch, len(train_idx))
        K = cfg.ensemble_size
        steps = max(1, len(train_idx) // B) * cfg.model_epochs
        dev = self.device
        loss = torch.zeros((), device=dev)
        for _ in range(steps):
            # per-member bootstrap minibatches decorrelate the ensemble
            idx = self._rng.choice(train_idx, size=(K, B))
            self.model_params, self._model_opt_state, loss = model_update(
                self.model_params, self._model_opt_state,
                torch.as_tensor(xn[idx], device=dev),
                torch.as_tensor(yn[idx], device=dev), cfg.model_lr)
        with torch.no_grad():
            val = member_losses(self.model_params,
                                torch.as_tensor(xn[val_idx], device=dev),
                                torch.as_tensor(yn[val_idx], device=dev))
        out = torch.stack([loss, val.mean(), val.max()]).tolist()
        return {"model_train_loss": out[0], "model_val_loss": out[1],
                "model_val_worst": out[2], "dataset_size": n}

    # -- Trainable API ----------------------------------------------------

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        mean_rew = self._collect_real(cfg.real_steps_per_iter)
        model_metrics = self._fit_ensemble()
        # meta-updates from real start states (several MAML outer steps
        # per fitted ensemble, reference: maml_optimizer_steps)
        obs_pool = np.concatenate(self._buf["obs"])[-4096:]
        norm = {k: torch.as_tensor(v, device=self.device)
                for k, v in self._norm.items()}
        for _ in range(max(1, cfg.meta_steps_per_iter)):
            start = obs_pool[self._rng.integers(0, len(obs_pool),
                                                size=cfg.imag_envs)]
            loss, aux = self._meta_step(
                norm, torch.as_tensor(start, device=self.device))
        loss, pre, post = torch.stack([loss, aux["pre"],
                                       aux["post"]]).tolist()
        ep_len = getattr(self.env, "_max_t", 200)
        return {"meta_loss": loss,
                "imag_pre_adapt_reward": pre,
                "imag_post_adapt_reward": post,
                "imag_adaptation_gain": post - pre,
                "real_reward_per_step": mean_rew,
                "mean_return": mean_rew * ep_len,
                "env_steps_total": self._env_steps_total,
                **model_metrics}

    def evaluate(self, num_episodes: int = 4) -> Dict[str, float]:
        """Real-env return of the CURRENT meta-policy (fresh env and
        generator, training stream untouched)."""
        cfg = self.config
        env = make_env(cfg.env, cfg.num_envs_per_runner, cfg.env_config,
                       seed=cfg.seed + 999)
        horizon = getattr(env, "_max_t", 200)
        gen_state = self._gen.get_state()
        self._gen.manual_seed(cfg.seed + 31337)
        try:
            obs = env.reset()
            total = 0.0
            for _ in range(horizon):
                obs, rew, _ = env.step(self._act(self.params, obs))
                total += float(rew.mean())
        finally:
            self._gen.set_state(gen_state)
        return {"episode_return_mean": total, "episodes": env.num_envs}

    def get_params(self):
        return {"policy": self.params, "model": self.model_params}

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        return {"params": params_to_numpy(self.params),
                "model_params": params_to_numpy(self.model_params),
                "norm": self._norm,
                "env_steps_total": self._env_steps_total}

    def load_checkpoint(self, checkpoint: Dict) -> None:
        self.params = models.params_to_device(checkpoint["params"],
                                              self.device)
        self.model_params = models.params_to_device(
            checkpoint["model_params"], self.device)
        self._norm = checkpoint["norm"]
        self._env_steps_total = checkpoint.get("env_steps_total", 0)
