"""Anakin-fused rollouts on the device: env, policy and learner in one
iteration with no host read inside it (port of ``ray_tpu/rl/anakin.py``).

JAX compiles the whole iteration into one XLA program:

    rollout (``lax.scan`` over T steps, ``vmap`` over B envs)
      -> GAE advantages (reverse ``lax.scan``)
        -> PPO update (``lax.scan`` over epochs)

Here the same iteration runs eagerly on the device: a Python loop of T
batched env steps (``rl/device_env.py``), a reverse loop for GAE, then
``num_epochs`` full-batch updates with the constant Adam behind a
global-norm clip (``parallel/train_step.py:Adam``). Nothing in it reads a
device value back: the actions, resets, advantages, the clip factor and
the metrics stay tensors on the device, and the host sees only the final
metrics, converted once in ``AnakinRunner.train``. Params and optimizer
state update in place.

Eager PyTorch compiles nothing. ``AnakinRunner.compile_count()`` counts
the distinct carry signatures (leaf shapes and dtypes) the iteration has
run, which is what JAX's jit cache would be keyed on: 1 once warm, as
JAX's. ``bench_fused_vs_host`` times the fused iteration against the
host-loop ``EnvRunner`` path doing the same work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.train_step import Adam, _leaves, value_and_grad
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithms.ppo import make_ppo_loss
from ray_tpu_torch.rl.device_env import make_device_env
from ray_tpu_torch.rl.env_runner import EnvRunner


@dataclasses.dataclass
class AnakinConfig:
    """One fused-iteration recipe (PPO on a device env)."""

    env: str = "CartPole-v1"
    num_envs: int = 64
    rollout_len: int = 32
    hidden: Tuple[int, ...] = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 2
    grad_clip: float = 0.5
    seed: int = 0

    @property
    def env_steps_per_iter(self) -> int:
        return self.num_envs * self.rollout_len


def make_anakin_step(cfg: AnakinConfig, env_cls=None):
    """The fused iteration: ``step(carry) -> (carry, metrics)``.

    ``carry`` = (params, opt_state, env_state, obs, gen): ``gen`` is the
    ``torch.Generator`` the actions are drawn from. Params and optimizer
    state are updated in place and come back as the same objects; the
    metrics are 0-d tensors on the device."""
    env_cls = env_cls or make_device_env(cfg.env)
    loss_fn = make_ppo_loss(env_cls.spec, cfg.clip_param, cfg.vf_coeff,
                            cfg.entropy_coeff)
    opt = Adam(cfg.lr, grad_clip=cfg.grad_clip)
    T = cfg.rollout_len

    def step(carry):
        params, opt_state, env_state, obs, gen = carry
        with torch.no_grad():
            traj = []
            for _ in range(T):
                logits = models.policy_logits(params, obs)
                vals = models.value(params, obs)
                actions = models.categorical_sample(gen, logits)
                logp = models.categorical_logp(logits, actions)
                env_state, next_obs, rew, done = env_cls.step_batch(
                    env_state, actions)
                traj.append((obs, actions, logp, vals, rew, done))
                obs = next_obs
            obs_t, act_t, logp_t, val_t, rew_t, done_t = (
                torch.stack(x) for x in zip(*traj))
            next_val = models.value(params, obs)
            last_gae = torch.zeros_like(next_val)
            adv = [None] * T
            for t in reversed(range(T)):
                nonterminal = 1.0 - done_t[t].float()
                delta = rew_t[t] + cfg.gamma * next_val * nonterminal \
                    - val_t[t]
                last_gae = delta + cfg.gamma * cfg.lam * nonterminal \
                    * last_gae
                adv[t], next_val = last_gae, val_t[t]
            adv_t = torch.stack(adv)
            ret_t = adv_t + val_t

        def flat(a):
            return a.reshape((T * cfg.num_envs,) + a.shape[2:])

        batch = {"obs": flat(obs_t), "actions": flat(act_t),
                 "logp": flat(logp_t), "advantages": flat(adv_t),
                 "value_targets": flat(ret_t)}
        loss, aux = _ppo_epochs(cfg, loss_fn, opt, params, opt_state, batch)
        metrics = {
            "reward_mean_per_step": torch.mean(rew_t),
            "episodes_done": torch.sum(done_t),
            "loss": loss,
            "entropy": aux["entropy"],
            "kl": aux["kl"],
            "value_mean": torch.mean(val_t),
        }
        return (params, opt_state, env_state, obs, gen), metrics

    return step


def _ppo_epochs(cfg: AnakinConfig, loss_fn, opt: Adam, params, opt_state,
                batch):
    """``cfg.num_epochs`` full-batch steps in place; the last (loss, aux)."""
    for _ in range(cfg.num_epochs):
        (loss, aux), grads = value_and_grad(
            lambda p: loss_fn(p, batch, None), params, has_aux=True)
        opt.update(params, grads, opt_state)
    return loss, aux


def _signature(carry) -> Tuple:
    """Shapes and dtypes of the carry's tensors, by path: what a new
    jit-cache entry would be keyed on in JAX."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in _leaves(list(carry)).items()
                        if isinstance(v, torch.Tensor)))


class AnakinRunner:
    """Owns the fused iteration and its carry on one device (``cuda``
    unless ``device`` says otherwise).

    Params, env resets and actions draw from three generators seeded from
    ``cfg.seed`` (JAX splits one key three ways)."""

    def __init__(self, cfg: Optional[AnakinConfig] = None, *,
                 device: DeviceLike = None, **overrides):
        self.cfg = cfg or AnakinConfig(**overrides)
        self.device = resolve_device(device)
        env_cls = make_device_env(self.cfg.env)
        seeds = np.random.SeedSequence(self.cfg.seed).generate_state(3)
        g_params, g_env, g_run = (
            torch.Generator(device=self.device).manual_seed(int(s))
            for s in seeds)
        params = models.init_policy(g_params, env_cls.spec,
                                    hidden=self.cfg.hidden)
        opt_state = Adam(self.cfg.lr, grad_clip=self.cfg.grad_clip).init(
            params)
        env_state, obs = env_cls.reset_batch(g_env, self.cfg.num_envs)
        self._carry = (params, opt_state, env_state, obs, g_run)
        self._step_fn = make_anakin_step(self.cfg, env_cls)
        self._signatures = set()
        self.iterations = 0
        self.env_steps_total = 0

    @property
    def params(self):
        return self._carry[0]

    def compile_count(self) -> int:
        """Distinct carry signatures the iteration has run (1 == one
        program, as JAX's jit cache size)."""
        return len(self._signatures)

    def train(self, iterations: int = 1) -> Dict[str, Any]:
        """Run N fused iterations; returns the LAST iteration's metrics,
        read back to the host once, after the loop."""
        metrics = None
        for _ in range(iterations):
            self._signatures.add(_signature(self._carry))
            self._carry, metrics = self._step_fn(self._carry)
        self.iterations += iterations
        self.env_steps_total += iterations * self.cfg.env_steps_per_iter
        out = {k: float(v) for k, v in metrics.items()}
        out["env_steps_total"] = self.env_steps_total
        out["iterations"] = self.iterations
        return out

    def block(self) -> None:
        """Wait for the device to finish the carry (a timing boundary)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# ---------------------------------------------------------------------------
# A/B bench: fused Anakin vs the host-loop EnvRunner path
# ---------------------------------------------------------------------------


def make_host_leg(cfg: AnakinConfig, device: DeviceLike = None
                  ) -> Callable[[], None]:
    """The host-loop leg of ``bench_fused_vs_host``: one call runs one PPO
    iteration the existing architecture's way. ``EnvRunner.sample`` steps
    the numpy CartPole under per-step inference on the device (one
    launch sequence and one device-to-host read of the actions a step,
    numpy GAE), then the batch goes to the device for a separately
    launched update of ``num_epochs`` full-batch steps with the fused
    leg's loss and optimizer. Params and optimizer state persist across
    calls."""
    device = resolve_device(device)
    host = EnvRunner("CartPole-v1", cfg.num_envs, cfg.rollout_len,
                     seed=cfg.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = models.init_policy(gen, host.spec, hidden=cfg.hidden)
    loss_fn = make_ppo_loss(host.spec, cfg.clip_param, cfg.vf_coeff,
                            cfg.entropy_coeff)
    opt = Adam(cfg.lr, grad_clip=cfg.grad_clip)
    opt_state = opt.init(params)

    def host_iter() -> None:
        frag = host.sample(params)
        batch = {k: torch.as_tensor(frag[k], device=device)
                 for k in ("obs", "actions", "logp", "advantages",
                           "value_targets")}
        _ppo_epochs(cfg, loss_fn, opt, params, opt_state, batch)

    return host_iter


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_fused_vs_host(*, num_envs: int = 64, rollout_len: int = 32,
                        iters: int = 20, warmup: int = 3, seed: int = 0,
                        device: DeviceLike = None) -> Dict[str, Any]:
    """env-steps/s of the fused Anakin iteration vs the host-loop
    ``EnvRunner`` path (``make_host_leg``) running the SAME work at the
    SAME (B, T) shape: rollout, GAE, ``num_epochs`` full-batch PPO updates
    with the identical loss and optimizer. The fused leg reads nothing
    back inside an iteration; the host leg reads the actions every env
    step. ``warmup`` untimed iterations first, then ``iters`` timed, each
    leg bounded by device syncs. Returns JAX's keys, the rates unrounded
    (JAX rounds them)."""
    device = resolve_device(device)
    cfg = AnakinConfig(num_envs=num_envs, rollout_len=rollout_len,
                       seed=seed)
    runner = AnakinRunner(cfg, device=device)
    runner.train(warmup)
    runner.block()
    t0 = time.perf_counter()
    runner.train(iters)
    runner.block()
    fused_s = time.perf_counter() - t0
    fused_steps = iters * cfg.env_steps_per_iter

    host_iter = make_host_leg(cfg, device)
    for _ in range(warmup):
        host_iter()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        host_iter()
    _sync(device)
    host_s = time.perf_counter() - t0
    host_steps = iters * num_envs * rollout_len

    fused_sps = fused_steps / max(fused_s, 1e-9)
    host_sps = host_steps / max(host_s, 1e-9)
    return {
        "num_envs": num_envs, "rollout_len": rollout_len,
        "iters": iters, "warmup": warmup,
        "fused_env_steps_per_s": fused_sps,
        "host_env_steps_per_s": host_sps,
        "fused_vs_host_ratio": fused_sps / max(host_sps, 1e-9),
        "fused_compile_count": runner.compile_count(),
        "methodology": (
            "equal work both legs (rollout + GAE + {e}-epoch PPO update "
            "at B={b}, T={t}): {w} warmup iters then {n} timed; the fused "
            "leg reads nothing back inside an iteration and is bounded by "
            "device syncs; the host leg is EnvRunner.sample (per-step "
            "inference on the device + numpy env + numpy GAE) + a "
            "separately launched update".format(
                e=cfg.num_epochs, w=warmup, n=iters, b=num_envs,
                t=rollout_len)),
    }
