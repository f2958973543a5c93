"""DreamerV3 (compact): world-model RL with imagination training (port
of ``ray_tpu/rl/algorithms/dreamer.py``).

Reference analog: ``rllib/algorithms/dreamerv3/`` (Hafner et al. 2023).
The full architecture at reduced width, faithful to the v3 recipe where
it matters:

- **RSSM world model**: GRU deterministic state ``h`` + CATEGORICAL
  stochastic latent ``z`` (K groups x C classes, straight-through
  gradients, 1% unimix), posterior ``q(z|h, emb(obs))`` vs learned prior
  ``p(z|h)``; heads decode observation, reward, and episode-continue
  from ``(h, z)`` (reward and continue also from the current action).
- **KL balancing + free bits**: ``kl(sg(post)||prior)`` (dynamics) and
  ``0.1 * kl(post||sg(prior))`` (representation), each clipped below 1
  free nat per element before the mean.
- **Imagination actor-critic**: from every posterior state of the
  training batch, roll the PRIOR forward ``imag_horizon`` steps with the
  actor; the critic regresses lambda-returns on the imagined
  trajectories, the actor takes the REINFORCE gradient with advantages
  normalized by an EMA of the return percentile range, plus an entropy
  bonus.

One update (``DreamerFns.train_step``) keeps JAX's order: the world
model steps first; the actor's rollout runs on the UPDATED world model
from the states the pre-update one gave; the critic regresses on that
same rollout's returns, computed with the pre-update critic. Three
optimizers, each a clip at global norm 100 followed by Adam. JAX's
``lax.scan`` loops are Python loops here. The imagined rollout carries no
gradient to the actor (its actions are discrete draws and the world model
is frozen), so it runs without autograd and the actor's logits are
recomputed on the imagined features in one batched call for the loss.
Every categorical draw (the posterior and prior latents, the actions)
goes through ``models.gumbel`` from the trainable's generator, in the
order JAX splits its keys (not JAX's draws).

Vector observations and discrete actions only; sequences are collected
as fixed-length chunks with ``is_first`` flags, replayed uniformly.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.parallel.train_step import _unflatten_like, value_and_grad
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import DeviceTrainable
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.evaluation import ReturnWindow, run_episodes
from ray_tpu_torch.rl.learner import (adam_init, adam_update,
                                      clip_global_norm, mean_metrics)

CLIP_NORM = 100.0


class DreamerV3Config(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=DreamerV3, **kwargs)
        self.env = "CartPole-v1"
        self.lr = 3e-4                 # world-model lr
        self.actor_lr = 1e-4
        self.critic_lr = 1e-4
        self.hidden = (128,)           # head widths
        self.deter_dim = 128           # GRU state
        self.stoch_groups = 8          # K
        self.stoch_classes = 8         # C
        self.embed_dim = 128
        # replay chunks are rollout_fragment_length timesteps long
        self.batch_seqs = 16           # sequences per update
        self.imag_horizon = 10
        self.buffer_size = 50_000      # in timesteps
        self.learning_starts = 1_000
        self.updates_per_iter = 8
        self.entropy_coeff = 3e-3
        self.kl_dyn_scale = 1.0
        self.kl_rep_scale = 0.1
        self.free_nats = 1.0
        self.lambda_ = 0.95
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 16


def _mlp(gen: torch.Generator, dims, out_scale: float = 1.0) -> Dict:
    return models.init_mlp(gen, dims, out_scale=out_scale)


def _fwd(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return models.mlp_forward(p, x)


def _gru_init(gen: torch.Generator, in_dim: int, h_dim: int) -> Dict:
    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=gen.device)

    return {"wi": normal((in_dim, 3 * h_dim)) / math.sqrt(in_dim),
            "wh": normal((h_dim, 3 * h_dim)) / math.sqrt(h_dim),
            "b": torch.zeros(3 * h_dim, device=gen.device)}


def _gru(p: Dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    gi = x @ p["wi"] + p["b"]
    gh = h @ p["wh"]
    iz, ir, ia = torch.chunk(gi, 3, dim=-1)
    hz, hr, ha = torch.chunk(gh, 3, dim=-1)
    z = torch.sigmoid(iz + hz)
    r = torch.sigmoid(ir + hr)
    a = torch.tanh(ia + r * ha)
    return (1 - z) * a + z * h


def _unimix(logits: torch.Tensor, classes: int,
            mix: float = 0.01) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    probs = (1 - mix) * probs + mix / classes
    return torch.log(probs)


def _st_sample(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """Straight-through categorical over [..., K, C]: the one-hot of a
    draw in value, the softmax's gradient."""
    idx = models.categorical_sample(gen, logits)
    onehot = F.one_hot(idx, logits.shape[-1]).to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    return onehot + probs - probs.detach()


def _kl_cat(logits_a: torch.Tensor, logits_b: torch.Tensor) -> torch.Tensor:
    """KL(a || b) per group, summed over groups: [..., K, C] -> [...]."""
    pa = torch.softmax(logits_a, dim=-1)
    la = torch.log_softmax(logits_a, dim=-1)
    lb = torch.log_softmax(logits_b, dim=-1)
    return torch.sum(pa * (la - lb), dim=(-2, -1))


def init_dreamer(gen: torch.Generator, cfg: AlgorithmConfig, obs_dim: int,
                 num_actions: int) -> Tuple[Dict, Dict, Dict]:
    """(world model, actor, critic) on ``gen``'s device."""
    D, Z = cfg.deter_dim, cfg.stoch_groups * cfg.stoch_classes
    A, E, feat = num_actions, cfg.embed_dim, cfg.deter_dim + Z
    wm = {
        "enc": _mlp(gen, (obs_dim, E, E), out_scale=1.0),
        "gru": _gru_init(gen, Z + A, D),
        "prior": _mlp(gen, (D, *cfg.hidden, Z), out_scale=1.0),
        "post": _mlp(gen, (D + E, *cfg.hidden, Z), out_scale=1.0),
        "dec": _mlp(gen, (feat, *cfg.hidden, obs_dim), out_scale=1.0),
        # reward/continue condition on the CURRENT action too: with
        # auto-reset vector envs the post-action observation of a
        # terminal step is unobtainable, so r_t and cont_t are predicted
        # from (h_t, z_t, a_t)
        "rew": _mlp(gen, (feat + A, *cfg.hidden, 1), out_scale=0.01),
        "cont": _mlp(gen, (feat + A, *cfg.hidden, 1), out_scale=0.01),
    }
    actor = _mlp(gen, (feat, *cfg.hidden, A), out_scale=0.01)
    critic = _mlp(gen, (feat, *cfg.hidden, 1), out_scale=0.01)
    return wm, actor, critic


def _clip_adam(params: Dict, flat: Dict[str, torch.Tensor], state: Dict,
               lr: float):
    """optax.chain(clip_by_global_norm(100), adam(lr)) on one tree."""
    grads, _ = clip_global_norm(_unflatten_like(params, flat), CLIP_NORM)
    return adam_update(params, grads, state, lr)


class DreamerFns:
    """The RSSM step, the three losses and the whole update of one
    config and action count (JAX's closures in ``DreamerV3.setup``)."""

    def __init__(self, cfg: AlgorithmConfig, num_actions: int):
        self.cfg = cfg
        self.D, self.K, self.C = (cfg.deter_dim, cfg.stoch_groups,
                                  cfg.stoch_classes)
        self.Z = self.K * self.C
        self.A = num_actions
        self.H = cfg.imag_horizon

    def obs_step(self, wm, h, z_flat, a_onehot, emb, is_first, gen):
        """One posterior RSSM step; resets state on episode starts."""
        K, C = self.K, self.C
        keep = (1.0 - is_first)[..., None]
        h = h * keep
        z_flat = z_flat * keep
        a_onehot = a_onehot * keep
        h = _gru(wm["gru"], h, torch.cat([z_flat, a_onehot], dim=-1))
        prior_logits = _unimix(
            _fwd(wm["prior"], h).reshape(h.shape[0], K, C), C)
        post_logits = _unimix(
            _fwd(wm["post"], torch.cat([h, emb], dim=-1))
            .reshape(h.shape[0], K, C), C)
        z = _st_sample(gen, post_logits)
        return h, z.reshape(h.shape[0], self.Z), prior_logits, post_logits

    def wm_loss(self, wm, batch, gen):
        """batch: obs [B,T,o], actions [B,T] (the previous action's
        one-hot is built inside), rewards [B,T], conts [B,T], is_first
        [B,T]. T posterior steps, one latent draw each."""
        cfg, A, D, Z = self.cfg, self.A, self.D, self.Z
        B, T = batch["rewards"].shape
        emb = _fwd(wm["enc"], batch["obs"])                  # [B,T,E]
        a_onehot = F.one_hot(batch["actions"].long(), A).float()  # [B,T,A]
        # previous action enters the transition (a_{t-1} -> z_t)
        a_prev = torch.cat([torch.zeros_like(a_onehot[:, :1]),
                            a_onehot[:, :-1]], dim=1)
        dev = emb.device
        h = torch.zeros((B, D), device=dev)
        z = torch.zeros((B, Z), device=dev)
        hs, zs, prior_l, post_l = [], [], [], []
        for t in range(T):
            h, z, pr, po = self.obs_step(wm, h, z, a_prev[:, t], emb[:, t],
                                         batch["is_first"][:, t], gen)
            hs.append(h)
            zs.append(z)
            prior_l.append(pr)
            post_l.append(po)
        hs, zs = torch.stack(hs, dim=1), torch.stack(zs, dim=1)
        prior_l = torch.stack(prior_l, dim=1)
        post_l = torch.stack(post_l, dim=1)
        ft = torch.cat([hs, zs], dim=-1)                     # [B,T,feat]
        recon = _fwd(wm["dec"], ft)
        ft_a = torch.cat([ft, a_onehot], dim=-1)             # current a_t
        rew_pred = _fwd(wm["rew"], ft_a)[..., 0]
        cont_logit = _fwd(wm["cont"], ft_a)[..., 0]
        recon_loss = torch.mean(torch.sum(
            (recon - batch["obs"]) ** 2, dim=-1))
        rew_loss = torch.mean((rew_pred - batch["rewards"]) ** 2)
        cont_loss = F.binary_cross_entropy_with_logits(
            cont_logit, batch["conts"])
        kl_dyn = torch.clamp(_kl_cat(post_l.detach(), prior_l),
                             min=cfg.free_nats).mean()
        kl_rep = torch.clamp(_kl_cat(post_l, prior_l.detach()),
                             min=cfg.free_nats).mean()
        loss = recon_loss + rew_loss + cont_loss \
            + cfg.kl_dyn_scale * kl_dyn + cfg.kl_rep_scale * kl_rep
        states = (hs.reshape(-1, D).detach(), zs.reshape(-1, Z).detach())
        return loss, {"recon_loss": recon_loss, "rew_loss": rew_loss,
                      "cont_loss": cont_loss, "kl_dyn": kl_dyn,
                      "states": states}

    @torch.no_grad()
    def imagine(self, wm, actor, h0, z0, gen):
        """Prior rollout with the actor from [B*T] starts, H steps: the
        features [H, N, feat] and actions [H, N]; per step an action draw,
        then a prior latent draw."""
        A, K, C = self.A, self.K, self.C
        h, z = h0, z0
        fts, acts = [], []
        for _ in range(self.H):
            ft = torch.cat([h, z], dim=-1)
            a = models.categorical_sample(gen, _fwd(actor, ft))
            h = _gru(wm["gru"], h, torch.cat([z, F.one_hot(a, A).float()],
                                             dim=-1))
            prior_l = _unimix(_fwd(wm["prior"], h).reshape(h.shape[0], K, C),
                              C)
            z = _st_sample(gen, prior_l).reshape(h.shape[0], self.Z)
            fts.append(ft)
            acts.append(a)
        return torch.stack(fts), torch.stack(acts)

    def lambda_returns(self, rew, disc, values):
        """Hafner's lambda returns for t = 0..H-2 [H-1, N], mixing the
        next state's value and bootstrapping from ``values[-1]``."""
        lam = self.cfg.lambda_
        inputs = rew[:-1] + disc[:-1] * (1 - lam) * values[1:]
        acc = values[-1]
        rets = [None] * (self.H - 1)
        for t in range(self.H - 2, -1, -1):
            acc = inputs[t] + disc[t] * lam * acc
            rets[t] = acc
        return torch.stack(rets)

    def actor_loss(self, actor, critic, wm, h0, z0, gen, ret_scale: float):
        """ONE imagination rollout serves both losses: the actor's
        REINFORCE term here, and (through the detached aux) the critic
        regression in ``train_step``. ``wm`` and ``critic`` get no
        gradient."""
        cfg, A = self.cfg, self.A
        wm = models.tree_map(torch.Tensor.detach, wm)
        fts, acts = self.imagine(wm, actor, h0, z0, gen)
        with torch.no_grad():
            fts_a = torch.cat([fts, F.one_hot(acts, A).float()], dim=-1)
            rew = _fwd(wm["rew"], fts_a)[..., 0]             # [H, N]
            disc = cfg.gamma * torch.sigmoid(_fwd(wm["cont"], fts_a)[..., 0])
            values = _fwd(critic, fts)[..., 0]               # [H, N]
            rets = self.lambda_returns(rew, disc, values)    # [H-1, N]
            adv = (rets - values[:-1]) / max(ret_scale, 1.0)
        logp = torch.log_softmax(_fwd(actor, fts[:-1]), dim=-1)
        lp_a = torch.gather(logp, -1, acts[:-1][..., None])[..., 0]
        entropy = -torch.sum(torch.exp(logp) * logp, dim=-1).mean()
        loss = -torch.mean(lp_a * adv) - cfg.entropy_coeff * entropy
        return loss, {"fts": fts, "rets": rets, "entropy": entropy}

    @staticmethod
    def critic_loss(critic, fts, rets):
        vals = _fwd(critic, fts)[..., 0]
        return torch.mean((vals[:-1] - rets) ** 2)

    def train_step(self, wm, actor, critic, opt_states, batch, gen,
                   ret_scale: float):
        """One update of the three nets, in JAX's order. Returns (wm,
        actor, critic, opt_states, metrics), the metrics 0-d tensors on
        the device."""
        cfg = self.cfg
        wm_state, a_state, c_state = opt_states
        (wl, wm_aux), g = value_and_grad(
            lambda w: self.wm_loss(w, batch, gen), wm, has_aux=True)
        wm, wm_state = _clip_adam(wm, g, wm_state, cfg.lr)
        h0, z0 = wm_aux.pop("states")
        (al, aux), g = value_and_grad(
            lambda a: self.actor_loss(a, critic, wm, h0, z0, gen, ret_scale),
            actor, has_aux=True)
        actor, a_state = _clip_adam(actor, g, a_state, cfg.actor_lr)
        # the critic regresses on the SAME (pre-update-actor) rollout:
        # targets are the lambda returns of the pre-update critic
        cl, g = value_and_grad(
            lambda c: self.critic_loss(c, aux["fts"], aux["rets"]), critic)
        critic, c_state = _clip_adam(critic, g, c_state, cfg.critic_lr)
        q = torch.quantile(aux["rets"].reshape(-1),
                           torch.tensor([0.05, 0.95], device=cl.device))
        metrics = dict(wm_aux, wm_loss=wl, actor_loss=al, critic_loss=cl,
                       actor_entropy=aux["entropy"], ret_range=q[1] - q[0])
        return wm, actor, critic, (wm_state, a_state, c_state), metrics

    @torch.no_grad()
    def act(self, wm, actor, h, z, a_prev, obs, is_first, gen):
        """One collection step: the posterior update, then an action draw."""
        emb = _fwd(wm["enc"], obs)
        h, z, _, _ = self.obs_step(wm, h, z, a_prev, emb, is_first, gen)
        a = models.categorical_sample(gen, _fwd(actor,
                                                torch.cat([h, z], dim=-1)))
        return h, z, a


class DreamerV3(DeviceTrainable):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return DreamerV3Config()

    def setup(self, config: Dict[str, Any]) -> None:
        self.config = self.config_from(config)
        cfg = self.config
        self.env = make_env(cfg.env, cfg.num_envs_per_runner,
                            cfg.env_config)
        spec = self.env.spec
        if not spec.discrete or spec.is_pixel:
            raise ValueError("this DreamerV3 targets discrete actions "
                             "over vector observations")
        self.spec = spec
        A = spec.num_actions
        self.wm, self.actor, self.critic = init_dreamer(
            self.generator(cfg.seed), cfg, spec.obs_dim, A)
        self._fns = DreamerFns(cfg, A)
        self._wm_state = adam_init(self.wm)
        self._a_state = adam_init(self.actor)
        self._c_state = adam_init(self.critic)
        N, dev = cfg.num_envs_per_runner, self.device
        self._h = torch.zeros((N, cfg.deter_dim), device=dev)
        self._z = torch.zeros((N, self._fns.Z), device=dev)
        self._a_prev = torch.zeros((N, A), device=dev)
        self._is_first = np.ones(N, dtype=np.float32)
        self._gen = self.generator(cfg.seed + 99)
        self._obs = self.env.reset()
        self._A = A
        self._ret_scale = 1.0
        self._chunks: List[Dict[str, np.ndarray]] = []
        self._buf_steps = 0
        self._rng = np.random.default_rng(cfg.seed)
        self._env_steps_total = 0
        self._returns = ReturnWindow(N)

    # -- collection -------------------------------------------------------

    def _collect(self, steps: int) -> None:
        cfg = self.config
        N = self.env.num_envs
        rows = {k: [] for k in ("obs", "actions", "rewards", "conts",
                                "is_first")}
        for _ in range(steps):
            self._h, self._z, a = self._fns.act(
                self.wm, self.actor, self._h, self._z, self._a_prev,
                torch.as_tensor(self._obs, device=self.device),
                torch.as_tensor(self._is_first, device=self.device),
                self._gen)
            acts = a.cpu().numpy()
            rows["obs"].append(self._obs.copy())
            rows["is_first"].append(self._is_first.copy())
            next_obs, rew, dones = self.env.step(acts)
            rows["actions"].append(acts)
            rows["rewards"].append(rew.astype(np.float32))
            rows["conts"].append(1.0 - dones.astype(np.float32))
            self._a_prev = F.one_hot(a, self._A).float()
            self._is_first = dones.astype(np.float32)
            self._obs = next_obs
            self._env_steps_total += N
            self._returns.add(rew, dones)
        chunk = {k: np.stack(v, axis=1) for k, v in rows.items()}  # [N,T]
        self._chunks.append(chunk)
        self._buf_steps += steps * N
        max_chunks = max(1, cfg.buffer_size
                         // (cfg.rollout_fragment_length * N))
        if len(self._chunks) > max_chunks:
            drop = len(self._chunks) - max_chunks
            del self._chunks[:drop]
            self._buf_steps = sum(c["rewards"].size for c in self._chunks)

    def _sample_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.config
        out = {k: [] for k in ("obs", "actions", "rewards", "conts",
                               "is_first")}
        for _ in range(cfg.batch_seqs):
            c = self._chunks[self._rng.integers(len(self._chunks))]
            row = self._rng.integers(c["rewards"].shape[0])
            for k in out:
                out[k].append(c[k][row])
        batch = {k: np.stack(v) for k, v in out.items()}
        # the RSSM loop starts each sampled chunk from a zeroed (h, z), so
        # the first replayed step is an episode start even where the chunk
        # was cut mid-episode (the reference forces is_first there too)
        batch["is_first"][:, 0] = 1.0  # np.stack already copied
        return batch

    def _train_step(self, batch: Dict[str, np.ndarray]):
        """One update on a replayed batch; the ret_scale EMA is read to
        the host here, once an update."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        (self.wm, self.actor, self.critic,
         (self._wm_state, self._a_state, self._c_state),
         m) = self._fns.train_step(
            self.wm, self.actor, self.critic,
            (self._wm_state, self._a_state, self._c_state),
            batch, self._gen, self._ret_scale)
        # EMA of the imagined-return percentile range (v3's advantage
        # normalizer)
        self._ret_scale = 0.99 * self._ret_scale \
            + 0.01 * float(m["ret_range"])
        return m

    # -- Trainable API ----------------------------------------------------

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        self._collect(cfg.rollout_fragment_length)
        metrics: Dict[str, Any] = {"buffer_steps": self._buf_steps}
        if self._buf_steps >= cfg.learning_starts:
            mlist = [self._train_step(self._sample_batch())
                     for _ in range(cfg.updates_per_iter or 1)]
            metrics.update(mean_metrics(mlist))
            metrics["ret_scale"] = self._ret_scale
        metrics["env_steps_total"] = self._env_steps_total
        mean_ret = self._returns.mean()
        if mean_ret is not None:
            metrics["episode_return_mean"] = mean_ret
        return metrics

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Fresh env and generator, stochastic actor through the
        world-model filter."""
        cfg = self.config
        env = make_env(cfg.env, cfg.num_envs_per_runner, cfg.env_config)
        N, dev = env.num_envs, self.device
        state = {"h": torch.zeros((N, cfg.deter_dim), device=dev),
                 "z": torch.zeros((N, self._fns.Z), device=dev),
                 "a_prev": torch.zeros((N, self._A), device=dev),
                 "is_first": np.ones(N, dtype=np.float32),
                 "obs": env.reset()}
        gen = self.generator(cfg.seed + 12345)

        def step():
            state["h"], state["z"], a = self._fns.act(
                self.wm, self.actor, state["h"], state["z"],
                state["a_prev"], torch.as_tensor(state["obs"], device=dev),
                torch.as_tensor(state["is_first"], device=dev), gen)
            state["obs"], rew, dones = env.step(a.cpu().numpy())
            state["a_prev"] = F.one_hot(a, self._A).float()
            state["is_first"] = dones.astype(np.float32)
            return rew, dones

        return run_episodes(step, num_episodes, N)

    def get_params(self):
        return {"wm": self.wm, "actor": self.actor, "critic": self.critic}

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        return {"wm": params_to_numpy(self.wm),
                "actor": params_to_numpy(self.actor),
                "critic": params_to_numpy(self.critic),
                "ret_scale": self._ret_scale,
                "env_steps_total": self._env_steps_total}

    def load_checkpoint(self, checkpoint: Dict) -> None:
        put = lambda t: models.params_to_device(t, self.device)  # noqa
        self.wm = put(checkpoint["wm"])
        self.actor = put(checkpoint["actor"])
        self.critic = put(checkpoint["critic"])
        self._ret_scale = checkpoint.get("ret_scale", 1.0)
        self._env_steps_total = checkpoint.get("env_steps_total", 0)
