"""R2D2: recurrent-replay DQN (Kapturowski et al. 2019; port of
``ray_tpu/rl/algorithms/r2d2.py``).

Reference analog: ``rllib/algorithms/r2d2/``. A GRU Q-network is trained
on replayed SEQUENCES instead of transitions: each stored sequence
carries the recurrent state at its start (the paper's "stored state"
strategy), the first ``burn_in`` steps warm the state without
contributing loss, and the remaining steps take double-Q TD updates.
Sequences are chopped at episode boundaries and padded with a validity
mask. JAX unrolls the GRU with ``lax.scan``; here the unroll is a Python
loop over the sequence, differentiated by autograd.

Runs in-process (the feedforward EnvRunner protocol can't carry hidden
state): the env steps on the host, one GRU step a step on the device,
whose new state and Q-values are read back for the epsilon-greedy choice
(drawn from numpy, as JAX's). The bundled partially-observable env,
CartPole with velocities masked out (``CartPoleNoVel-v0``), is
unsolvable by a memoryless policy beyond the random baseline.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithms.dqn import take
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.env import (CartPole, EnvSpec, VectorEnv, make_env,
                                  register_env)
from ray_tpu_torch.rl.learner import Learner, mean_metrics
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer
from ray_tpu_torch.tune.trainable import Trainable


class MaskedCartPole(VectorEnv):
    """CartPole with only the position components observable (cart x,
    pole angle): velocity must be inferred from memory."""

    _KEEP = np.array([0, 2])  # x, theta

    def __init__(self, num_envs: int, seed: int = 0):
        self._inner = CartPole(num_envs, seed=seed)
        self.num_envs = num_envs
        self.spec = EnvSpec(obs_dim=2, num_actions=2)

    def reset(self) -> np.ndarray:
        return self._inner.reset()[:, self._KEEP]

    def step(self, actions):
        obs, r, d = self._inner.step(actions)
        return obs[:, self._KEEP], r, d


register_env("CartPoleNoVel-v0",
             lambda c: MaskedCartPole(c["num_envs"], seed=c.get("seed", 0)))


# ---------------------------------------------------------------- GRU ----

def init_gru(gen: torch.Generator, in_dim: int, hidden: int) -> Dict:
    """JAX's recipe (uniform in +-1/sqrt(fan) for ``wx`` and ``wh``, zero
    ``b``), drawn from ``gen`` on its device."""
    def uniform(shape, scale):
        return models.uniform(gen, shape, -scale, scale)

    return {"wx": uniform((in_dim, 3 * hidden), 1.0 / math.sqrt(in_dim)),
            "wh": uniform((hidden, 3 * hidden), 1.0 / math.sqrt(hidden)),
            "b": torch.zeros(3 * hidden, device=gen.device)}


def gru_step(p: Dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One GRU step: h [B, H], x [B, E] -> h' [B, H]."""
    gx = x @ p["wx"] + p["b"]
    gh = h @ p["wh"]
    xr, xz, xn = torch.chunk(gx, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def unroll(net: Dict, obs_seq: torch.Tensor, h0: torch.Tensor
           ) -> torch.Tensor:
    """obs [B, L, D], h0 [B, H] -> q [B, L, A]: the encoder over every
    step at once, the GRU one step at a time, the head over every step."""
    emb = torch.tanh(models.mlp_forward(net["enc"], obs_seq))
    h, hs = h0, []
    for t in range(emb.shape[1]):
        h = gru_step(net["gru"], h, emb[:, t])
        hs.append(h)
    return models.mlp_forward(net["head"], torch.stack(hs, dim=1))


def act_q(net: Dict, h: torch.Tensor, obs: torch.Tensor):
    """One acting step: (h', q) for [N, H] states and [N, D] obs."""
    emb = torch.tanh(models.mlp_forward(net["enc"], obs))
    h2 = gru_step(net["gru"], h, emb)
    return h2, models.mlp_forward(net["head"], h2)


def make_r2d2_loss(gamma: float, burn_in: int):
    """``loss_fn(params, batch, key) -> (loss, {"td_abs_mean", "q_mean"})``
    over ``{"q", "target"}`` and a batch of [B, L] sequences (obs,
    actions, rewards, dones, valid) with their stored ``h0``."""
    def loss_fn(p, batch, key=None):
        q = unroll(p["q"], batch["obs"], batch["h0"])            # [B,L,A]
        q_taken = take(q, batch["actions"])                      # [B,L]
        with torch.no_grad():
            q_tgt = unroll(p["target"], batch["obs"], batch["h0"])
            # double-Q: next-step argmax from the online net, value from
            # the target net; shifted left to align t -> t+1 (zero pad)
            q_next = take(q_tgt, torch.argmax(q, dim=-1))
            q_next = torch.cat([q_next[:, 1:],
                                torch.zeros_like(q_next[:, :1])], dim=1)
        nonterminal = 1.0 - batch["dones"]
        target = batch["rewards"] + gamma * nonterminal * q_next
        td = q_taken - target
        # loss only on trainable steps: valid, past the burn-in, and either
        # terminal (no bootstrap needed) or followed by a valid step
        valid = batch["valid"]
        next_valid = torch.cat([valid[:, 1:], torch.zeros_like(valid[:, :1])],
                               dim=1)
        L = valid.shape[1]
        past_burn = (torch.arange(L, device=valid.device)[None, :]
                     >= burn_in)
        mask = valid * torch.maximum(batch["dones"], next_valid) * past_burn
        denom = torch.clamp(torch.sum(mask), min=1.0)
        loss = torch.sum(mask * td ** 2) / denom
        return loss, {"td_abs_mean": torch.sum(mask * torch.abs(td)) / denom,
                      "q_mean": torch.sum(mask * q_taken.detach()) / denom}

    return loss_fn


class R2D2Config(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=R2D2, **kwargs)
        self.env = "CartPoleNoVel-v0"
        self.lr = 5e-4
        self.hidden = (64,)          # obs encoder widths
        self.gru_hidden = 128
        self.seq_len = 16            # stored sequence length
        self.burn_in = 4             # warm-up steps without loss
        self.buffer_size = 4_000     # in sequences
        self.learning_starts = 64    # sequences before training
        self.minibatch_size = 64     # sequences per update
        self.target_update_freq = 200
        self.updates_per_iter = 32
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 30_000


class R2D2(Trainable):
    def __init__(self, config: Dict[str, Any], device: DeviceLike = None):
        self.device = resolve_device(device)
        super().__init__(config)

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return R2D2Config()

    def setup(self, config: Dict[str, Any]) -> None:
        if "__algo_config" in config:
            self.config: AlgorithmConfig = config["__algo_config"]
        else:
            self.config = R2D2Config().update_from_dict(config)
        cfg = self.config
        self.env = make_env(cfg.env, cfg.num_envs_per_runner,
                            cfg.env_config, seed=cfg.seed)
        spec = self.env.spec
        if not spec.discrete:
            raise ValueError("R2D2 requires discrete actions")
        self._A = spec.num_actions
        H = cfg.gru_hidden
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        enc_dims = (spec.obs_dim,) + tuple(cfg.hidden)
        net = {
            "enc": models.init_mlp(gen, enc_dims, out_scale=1.0),
            "gru": init_gru(gen, enc_dims[-1], H),
            "head": models.init_mlp(gen, (H, self._A)),
        }
        params = {"q": net, "target": models.clone_tree(net)}
        self.learner = Learner(params, make_r2d2_loss(cfg.gamma, cfg.burn_in),
                               cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed,
                               device=self.device)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._rng = np.random.default_rng(cfg.seed)
        N = self.env.num_envs
        self._obs = self.env.reset()
        self._h = np.zeros((N, H), dtype=np.float32)
        # per-env open sequence accumulators
        self._open: List[Dict[str, list]] = [self._new_seq(i)
                                             for i in range(N)]
        self._env_steps_total = 0
        self._grad_updates = 0
        self._ep_return = np.zeros(N)
        self._return_window: List[float] = []

    # -- sequence bookkeeping ---------------------------------------------

    def _new_seq(self, env_i: int) -> Dict[str, Any]:
        return {"h0": self._h[env_i].copy(), "obs": [], "actions": [],
                "rewards": [], "dones": []}

    def _flush_seq(self, env_i: int) -> None:
        cfg = self.config
        seq = self._open[env_i]
        t = len(seq["obs"])
        if t == 0:
            self._open[env_i] = self._new_seq(env_i)
            return
        L, D = cfg.seq_len, self.env.spec.obs_dim
        obs = np.zeros((L, D), dtype=np.float32)
        obs[:t] = np.stack(seq["obs"])
        acts = np.zeros(L, dtype=np.int64)
        acts[:t] = seq["actions"]
        rews = np.zeros(L, dtype=np.float32)
        rews[:t] = seq["rewards"]
        dones = np.zeros(L, dtype=np.float32)
        dones[:t] = seq["dones"]
        valid = np.zeros(L, dtype=np.float32)
        valid[:t] = 1.0
        self.buffer.add_batch({
            "obs": obs[None], "actions": acts[None], "rewards": rews[None],
            "dones": dones[None], "valid": valid[None],
            "h0": seq["h0"][None]})
        self._open[env_i] = self._new_seq(env_i)

    @property
    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps_total
                   / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial \
            + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    @torch.no_grad()
    def _act(self, net: Dict, h: np.ndarray, obs: np.ndarray):
        """(h', q) as host arrays, read back in one transfer."""
        h2, q = act_q(net, torch.as_tensor(h, device=self.device),
                      torch.as_tensor(obs, dtype=torch.float32,
                                      device=self.device))
        both = torch.cat([h2, q], dim=-1).cpu().numpy()
        return both[:, :h.shape[1]].copy(), both[:, h.shape[1]:]

    def _collect(self, steps: int) -> None:
        cfg = self.config
        N = self.env.num_envs
        net = self.learner.get_params()["q"]
        for _ in range(steps):
            h2, q = self._act(net, self._h, self._obs)
            greedy = np.argmax(q, axis=-1)
            explore = self._rng.random(N) < self._epsilon
            rand = self._rng.integers(0, self._A, N)
            acts = np.where(explore, rand, greedy).astype(np.int64)
            next_obs, rewards, dones = self.env.step(acts)
            for i in range(N):
                seq = self._open[i]
                seq["obs"].append(self._obs[i])
                seq["actions"].append(acts[i])
                seq["rewards"].append(rewards[i])
                seq["dones"].append(float(dones[i]))
                if dones[i] or len(seq["obs"]) >= cfg.seq_len:
                    if dones[i]:
                        h2[i] = 0.0  # episode boundary resets the state
                    # update self._h BEFORE flushing: _flush_seq opens the
                    # successor via _new_seq, whose h0 copies self._h — it
                    # must see the post-step carried state
                    self._h[i] = h2[i]
                    self._flush_seq(i)
                else:
                    self._h[i] = h2[i]
            self._ep_return += rewards
            for i in np.nonzero(dones)[0]:
                self._return_window.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
            self._obs = next_obs
            self._env_steps_total += N
        self._return_window = self._return_window[-100:]

    # -- Trainable API ----------------------------------------------------

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        self._collect(cfg.rollout_fragment_length)
        metrics: Dict[str, Any] = {"epsilon": self._epsilon,
                                   "buffer_sequences": len(self.buffer)}
        if len(self.buffer) >= cfg.learning_starts:
            mlist = []
            for _ in range(cfg.updates_per_iter or 1):
                mb = self.buffer.sample(cfg.minibatch_size)
                mlist.append(self.learner.update_minibatch(mb))
                self._grad_updates += 1
                if self._grad_updates % cfg.target_update_freq == 0:
                    p = dict(self.learner.get_params())
                    p["target"] = models.clone_tree(p["q"])
                    self.learner.set_params(p)
            metrics.update(mean_metrics(mlist))
        metrics["env_steps_total"] = self._env_steps_total
        if self._return_window:
            metrics["episode_return_mean"] = float(
                np.mean(self._return_window))
        return metrics

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Greedy episodes on a fresh env with a fresh recurrent state."""
        cfg = self.config
        env = make_env(cfg.env, cfg.num_envs_per_runner, cfg.env_config,
                       seed=cfg.seed + 991)
        N, H = env.num_envs, cfg.gru_hidden
        net = self.learner.get_params()["q"]
        obs = env.reset()
        h = np.zeros((N, H), dtype=np.float32)
        ep_ret = np.zeros(N)
        returns: List[float] = []
        for _ in range(4096):
            h, q = self._act(net, h, obs)
            obs, r, d = env.step(np.argmax(q, axis=-1).astype(np.int64))
            ep_ret += r
            for i in np.nonzero(d)[0]:
                returns.append(float(ep_ret[i]))
                ep_ret[i] = 0.0
                h[i] = 0.0
            if len(returns) >= num_episodes:
                break
        return {"episodes": len(returns),
                "episode_return_mean": float(np.mean(returns))
                if returns else float("nan")}

    def get_params(self):
        return self.learner.get_params()

    def set_params(self, params) -> None:
        self.learner.set_params(params)

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        """JAX's payload: the params as numpy arrays in JAX's tree."""
        return {"params": params_to_numpy(self.learner.get_params()),
                "env_steps_total": self._env_steps_total}

    def load_checkpoint(self, checkpoint: Dict) -> None:
        self.learner.set_params(checkpoint["params"])
        self._env_steps_total = checkpoint.get("env_steps_total", 0)
