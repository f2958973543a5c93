"""DT: Decision Transformer — offline RL as sequence modeling (port of
``ray_tpu/rl/algorithms/dt.py``).

Reference analog: ``rllib/algorithms/dt/dt.py`` (Chen et al. 2021).
Trajectories become token sequences ``(R_1, s_1, a_1, R_2, s_2, a_2, …)``
where ``R_t`` is the return-to-go; a small causal transformer is trained
to predict ``a_t`` from the prefix, and at evaluation time the policy is
conditioned on a target return (``target_return``) that decays by the
rewards actually received.

The transformer here is a compact pre-LN causal model written out in
torch (param dicts like the rest of ``rl/models.py``) — 3 tokens per
timestep, learned timestep embeddings, action read off the state-token
stream. Windows of ``context_len`` timesteps are sampled uniformly over
steps, left-padded, and masked.

The attention is JAX's plain math (einsum, a causal AND key-padding mask
filled with -1e9 before the softmax, float32), not the flash kernel: a
left-padded query row sees only padded keys, and with -1e9 its softmax is
uniform and finite where -inf (or SDPA's boolean mask) would make it NaN
and poison the masked loss. ``gelu`` is the tanh form (``jax.nn.gelu``'s
default) and the layer norm has no scale or bias. The windows and the
evaluation rollouts draw from numpy as JAX's do.
"""

from __future__ import annotations

from typing import Any, Dict, List

import math

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.algorithms.offline import _to_arrays
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import Learner, mean_metrics


class DTConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=DT, **kwargs)
        self.minibatch_size = 64
        self.context_len = 20       # K timesteps (3K tokens)
        self.d_model = 64
        self.n_layers = 2
        self.n_heads = 2
        self.max_ep_len = 1000      # timestep-embedding table size
        self.target_return = 200.0  # eval conditioning (env-specific)
        self.rtg_scale = 100.0      # divide returns-to-go for embedding
        self.updates_per_iter = 50


# ---- tiny causal transformer (param-dict style, mirrors rl/models.py) ----

def _linear_init(gen: torch.Generator, din: int, dout: int,
                 scale: float = 1.0) -> Dict[str, torch.Tensor]:
    w = torch.randn((din, dout), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale / math.sqrt(din)
    return {"w": w, "b": torch.zeros(dout, dtype=torch.float32,
                                     device=gen.device)}


def _linear(p, x):
    return x @ p["w"] + p["b"]


def _ln(x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def init_dt_model(gen: torch.Generator, obs_dim: int, act_in: int,
                  act_out: int, d: int, n_layers: int,
                  max_ep_len: int) -> Dict:
    """JAX's tree on ``gen``'s device (the draws are not JAX's)."""
    params: Dict[str, Any] = {
        "emb_rtg": _linear_init(gen, 1, d),
        "emb_obs": _linear_init(gen, obs_dim, d),
        "emb_act": _linear_init(gen, act_in, d),
        "emb_t": torch.randn((max_ep_len, d), generator=gen,
                             dtype=torch.float32, device=gen.device) * 0.02,
        "head": _linear_init(gen, d, act_out, scale=0.01),
        "blocks": [],
    }
    for _ in range(n_layers):
        params["blocks"].append({
            "qkv": _linear_init(gen, d, 3 * d),
            "proj": _linear_init(gen, d, d),
            "fc1": _linear_init(gen, d, 4 * d),
            "fc2": _linear_init(gen, 4 * d, d),
        })
    return params


def dt_forward(params: Dict, rtg, obs, act_in, timesteps, pad_mask,
               n_heads: int):
    """rtg [B,K,1], obs [B,K,Do], act_in [B,K,Da], timesteps [B,K] int,
    pad_mask [B,K] (1=real). Returns action predictions [B,K,act_out]
    read from the state-token positions."""
    B, K = timesteps.shape
    d = params["emb_t"].shape[-1]
    te = params["emb_t"][timesteps.long()]                # [B,K,d]
    tok_r = _linear(params["emb_rtg"], rtg) + te
    tok_s = _linear(params["emb_obs"], obs) + te
    tok_a = _linear(params["emb_act"], act_in) + te
    # interleave (R, s, a) -> [B, 3K, d]
    x = torch.stack([tok_r, tok_s, tok_a], dim=2).reshape(B, 3 * K, d)
    tok_mask = torch.repeat_interleave(pad_mask, 3, dim=-1)  # [B, 3K]
    L = 3 * K
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    attn_mask = causal[None] & tok_mask[:, None, :].bool()
    neg = torch.tensor(-1e9, dtype=x.dtype, device=x.device)
    hd = d // n_heads

    for blk in params["blocks"]:
        h = _ln(x)
        qkv = _linear(blk["qkv"], h).reshape(B, L, 3, n_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B,L,H,hd]
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        att = torch.where(attn_mask[:, None], att, neg)
        att = torch.softmax(att, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, d)
        x = x + _linear(blk["proj"], out)
        h = _ln(x)
        x = x + _linear(blk["fc2"], F.gelu(_linear(blk["fc1"], h),
                                           approximate="tanh"))

    x = _ln(x)
    state_stream = x.reshape(B, K, 3, d)[:, :, 1]         # after s_t token
    return _linear(params["head"], state_stream)          # [B,K,act_out]


def make_dt_loss(discrete: bool, rtg_scale: float, n_heads: int):
    """``loss_fn(params, batch, gen)``: the masked action NLL (and
    accuracy) for discrete actions, the masked squared error for
    continuous ones."""
    def loss_fn(params, batch, gen=None):
        pred = dt_forward(params, batch["rtg"][..., None] / rtg_scale,
                          batch["obs"], batch["act_in"],
                          batch["timesteps"], batch["mask"], n_heads)
        mask = batch["mask"]
        denom = mask.sum() + 1e-8
        if discrete:
            logp = torch.log_softmax(pred, dim=-1)
            tgt = batch["actions"].long()
            nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
            loss = (nll * mask).sum() / denom
            acc = ((torch.argmax(pred, -1) == tgt) * mask).sum() / denom
            return loss, {"action_nll": loss, "action_acc": acc}
        err = ((pred - batch["actions"]) ** 2).sum(-1)
        loss = (err * mask).sum() / denom
        return loss, {"action_mse": loss}

    return loss_fn


def _episodes_from_arrays(data: Dict[str, np.ndarray],
                          gamma_unused: float) -> List[Dict[str, np.ndarray]]:
    """Split flat (obs, actions, rewards, dones[, env_ids]) rows into
    per-episode dicts with undiscounted returns-to-go (the DT target)."""
    eps: List[Dict[str, np.ndarray]] = []
    env_ids = data.get("env_ids")
    streams: Dict[Any, List[int]] = {}
    for i in range(len(data["rewards"])):
        e = env_ids[i] if env_ids is not None else 0
        streams.setdefault(e, []).append(i)
        if data["dones"][i]:
            idx = np.asarray(streams.pop(e))
            rew = data["rewards"][idx].astype(np.float64)
            rtg = np.cumsum(rew[::-1])[::-1]
            eps.append({"obs": data["obs"][idx],
                        "actions": data["actions"][idx],
                        "rewards": rew.astype(np.float32),
                        "rtg": rtg.astype(np.float32)})
    # trailing partial episodes still provide supervised windows
    for idx_list in streams.values():
        idx = np.asarray(idx_list)
        if len(idx) < 2:
            continue
        rew = data["rewards"][idx].astype(np.float64)
        rtg = np.cumsum(rew[::-1])[::-1]
        eps.append({"obs": data["obs"][idx],
                    "actions": data["actions"][idx],
                    "rewards": rew.astype(np.float32),
                    "rtg": rtg.astype(np.float32)})
    if not eps:
        raise ValueError("offline_data contains no completed episodes "
                         "(need dones markers)")
    return eps


class DT(Algorithm):
    need_env_runners = False  # offline: the dataset IS the experience

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return DTConfig()

    def build_learner(self) -> None:
        cfg, spec = self.config, self.spec
        if cfg.offline_data is None:
            raise ValueError("DT needs config.offline_data")
        data = _to_arrays(cfg.offline_data)
        for col in ("obs", "actions", "rewards", "dones"):
            if col not in data:
                raise ValueError(f"offline_data missing {col!r}")
        self._episodes = _episodes_from_arrays(data, cfg.gamma)
        self._ep_lens = np.asarray([len(e["rewards"])
                                    for e in self._episodes])
        self._rng = np.random.default_rng(cfg.seed)

        K = cfg.context_len
        act_in = spec.num_actions if spec.discrete else spec.action_dim
        act_out = act_in

        params = init_dt_model(
            self.generator(cfg.seed), spec.obs_dim, act_in, act_out,
            cfg.d_model, cfg.n_layers, cfg.max_ep_len)
        self._n_heads = cfg.n_heads
        self._discrete = spec.discrete
        self._scale = cfg.rtg_scale
        self._low, self._high = spec.action_low, spec.action_high
        self.learner = Learner(params, make_dt_loss(spec.discrete,
                                                    cfg.rtg_scale,
                                                    cfg.n_heads),
                               cfg.lr, grad_clip=cfg.grad_clip,
                               seed=cfg.seed, device=self.device)
        self._K = K
        self._act_in_dim = act_in

    @torch.no_grad()
    def _act_fn(self, params, rtg, obs, act_in, timesteps, mask):
        """The action at the newest slot: one forward on the device and
        one host read."""
        dev = self.device
        pred = dt_forward(params,
                          torch.as_tensor(rtg, device=dev)[..., None]
                          / self._scale, torch.as_tensor(obs, device=dev),
                          torch.as_tensor(act_in, device=dev),
                          torch.as_tensor(timesteps, device=dev),
                          torch.as_tensor(mask, device=dev), self._n_heads)
        last = pred[:, -1]
        if self._discrete:
            return torch.argmax(last, dim=-1).cpu().numpy()
        return torch.clamp(last, self._low, self._high).cpu().numpy()

    def _encode_actions(self, acts: np.ndarray) -> np.ndarray:
        if self.spec.discrete:
            out = np.zeros((len(acts), self.spec.num_actions),
                           dtype=np.float32)
            out[np.arange(len(acts)), acts.astype(np.int64)] = 1.0
            return out
        return np.atleast_2d(acts).astype(np.float32).reshape(
            len(acts), -1)

    def _minibatch(self, size: int) -> Dict[str, np.ndarray]:
        cfg, spec, K = self.config, self.spec, self._K
        p = self._ep_lens / self._ep_lens.sum()
        eps_idx = self._rng.choice(len(self._episodes), size=size, p=p)
        obs = np.zeros((size, K, spec.obs_dim), dtype=np.float32)
        act_in = np.zeros((size, K, self._act_in_dim), dtype=np.float32)
        if spec.discrete:
            actions = np.zeros((size, K), dtype=np.int64)
        else:
            actions = np.zeros((size, K, spec.action_dim), dtype=np.float32)
        rtg = np.zeros((size, K), dtype=np.float32)
        ts = np.zeros((size, K), dtype=np.int32)
        mask = np.zeros((size, K), dtype=np.float32)
        for b, ei in enumerate(eps_idx):
            ep = self._episodes[ei]
            n = len(ep["rewards"])
            start = int(self._rng.integers(0, n))
            seg = slice(start, min(start + K, n))
            ln = seg.stop - seg.start
            obs[b, -ln:] = ep["obs"][seg].reshape(ln, -1)
            # slot t holds a_t itself: the prediction for a_t is read at
            # the s_t token (index 3t+1), which the causal mask cuts off
            # BEFORE the a_t token (3t+2), so a_{t-1} is the newest action
            # visible — the canonical DT interleave
            act_in[b, -ln:] = self._encode_actions(ep["actions"][seg])
            if spec.discrete:
                actions[b, -ln:] = ep["actions"][seg]
            else:
                actions[b, -ln:] = ep["actions"][seg].reshape(ln, -1)
            rtg[b, -ln:] = ep["rtg"][seg]
            ts[b, -ln:] = np.clip(np.arange(seg.start, seg.stop),
                                  0, cfg.max_ep_len - 1)
            mask[b, -ln:] = 1.0
        return {"obs": obs, "act_in": act_in, "actions": actions,
                "rtg": rtg, "timesteps": ts, "mask": mask}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        m: Dict[str, Any] = {}
        for _ in range(cfg.updates_per_iter or 50):
            m = self.learner.update_minibatch(
                self._minibatch(cfg.minibatch_size))
        # offline: no env interaction; the last update's metrics, one read
        return mean_metrics([m])

    def evaluate(self, num_episodes: int = 5,
                 target_return: float = None) -> Dict[str, float]:
        """Return-conditioned rollout: condition on ``target_return`` and
        decay it by realized rewards (the DT evaluation protocol)."""
        cfg, spec, K = self.config, self.spec, self._K
        tgt0 = float(cfg.target_return if target_return is None
                     else target_return)
        env = make_env(cfg.env, 1, cfg.env_config)
        params = self.learner.get_params()
        returns = []
        for _ in range(num_episodes):
            obs = env.reset()
            hist_obs = [np.asarray(obs[0], dtype=np.float32).reshape(-1)]
            hist_act: List[np.ndarray] = []
            hist_rtg = [tgt0]
            ep_ret, t = 0.0, 0
            while t < cfg.max_ep_len:
                ln = min(len(hist_obs), K)
                o = np.zeros((1, K, spec.obs_dim), dtype=np.float32)
                a = np.zeros((1, K, self._act_in_dim), dtype=np.float32)
                r = np.zeros((1, K), dtype=np.float32)
                ts = np.zeros((1, K), dtype=np.int32)
                mk = np.zeros((1, K), dtype=np.float32)
                o[0, -ln:] = np.stack(hist_obs[-ln:])
                # slots -ln..-2 are past timesteps (their actions are
                # known); the current slot stays zero — the causal mask
                # keeps it invisible to this step's prediction anyway
                na = ln - 1
                if na > 0 and hist_act:
                    a[0, -ln:-1] = np.stack(hist_act[-na:])
                r[0, -ln:] = hist_rtg[-ln:]
                lo = len(hist_obs) - ln
                ts[0, -ln:] = np.clip(np.arange(lo, lo + ln),
                                      0, cfg.max_ep_len - 1)
                mk[0, -ln:] = 1.0
                act = np.asarray(self._act_fn(params, r, o, a, ts, mk))[0]
                step_act = (np.asarray([act])
                            if spec.discrete else act[None])
                obs, reward, done = env.step(step_act)
                ep_ret += float(reward[0])
                t += 1
                if done[0]:
                    break
                hist_obs.append(np.asarray(obs[0],
                                           dtype=np.float32).reshape(-1))
                hist_act.append(self._encode_actions(
                    np.asarray([act]).reshape(1, -1)
                    if not spec.discrete else np.asarray([act]))[0])
                hist_rtg.append(hist_rtg[-1] - float(reward[0]))
            returns.append(ep_ret)
        return {"episode_return_mean": float(np.mean(returns))}
