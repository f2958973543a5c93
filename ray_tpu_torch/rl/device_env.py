"""Batched environments on the device for the fused (Anakin) iteration:
the counterpart of ``ray_tpu/rl/jax_env.py``.

JAX writes each env copy as a pure function and ``vmap``s it over the
batch; here every method works on the whole batch [B] at once, which is
what the ``vmap`` computes. The dynamics are ``JaxCartPole``'s: the same
Euler-integrated CartPole-v1 in float32, the same termination bounds,
+1 a step, and a branchless auto-reset that selects between the stepped
state and a fresh [-0.05, 0.05] init for every env, done or not.

The reset noise differs. JAX carries one PRNG key per env in the state;
jax.random cannot be reproduced in torch, so the state here carries one
explicit ``torch.Generator`` (on the state's device) that draws the fresh
inits of the whole batch. Nothing reads the host: a whole rollout stays
on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rl.env import EnvSpec


class CartPoleState(NamedTuple):
    """The batch's state: x [B, 4] (x, x_dot, theta, theta_dot) float32,
    t [B] int32 steps into the episode, and the generator of the resets."""

    x: torch.Tensor
    t: torch.Tensor
    gen: torch.Generator


def _uniform(gen: torch.Generator, shape, device: torch.device
             ) -> torch.Tensor:
    """Uniform float32 in [-0.05, 0.05), JAX's reset range."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u.mul_(0.1).sub_(0.05)


class TorchCartPole:
    """CartPole-v1 dynamics over a batch of env copies. No instance state:
    the class carries the spec, the methods the state."""

    spec = EnvSpec(obs_dim=4, num_actions=2)

    # dynamics constants, identical to JaxCartPole's and env.CartPole's
    _GRAVITY, _MC, _MP = 9.8, 1.0, 0.1
    _L, _FMAG, _DT = 0.5, 10.0, 0.02
    _THETA_LIM = 12 * 2 * math.pi / 360
    _X_LIM = 2.4
    _MAX_T = 500

    @classmethod
    def reset_batch(cls, gen: torch.Generator, num_envs: int
                    ) -> Tuple[CartPoleState, torch.Tensor]:
        """B fresh env copies on ``gen``'s device: state + obs [B, 4]."""
        x = _uniform(gen, (num_envs, 4), gen.device)
        t = torch.zeros(num_envs, dtype=torch.int32, device=gen.device)
        return CartPoleState(x=x, t=t, gen=gen), x

    @classmethod
    def step_batch(cls, state: CartPoleState, actions: torch.Tensor
                   ) -> Tuple[CartPoleState, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
        """One transition of every env: (state', obs', reward [B], done [B]).

        Done envs are already reset in ``state'``, and obs' is the
        post-reset observation; reward and done describe the transition
        that ended."""
        x, x_dot, th, th_dot = state.x.unbind(-1)
        force = torch.where(actions == 1, cls._FMAG, -cls._FMAG)
        cos, sin = torch.cos(th), torch.sin(th)
        total_m = cls._MC + cls._MP
        pm_l = cls._MP * cls._L
        temp = (force + pm_l * th_dot ** 2 * sin) / total_m
        th_acc = (cls._GRAVITY * sin - cos * temp) / (
            cls._L * (4.0 / 3.0 - cls._MP * cos ** 2 / total_m))
        x_acc = temp - pm_l * th_acc * cos / total_m
        x = x + cls._DT * x_dot
        x_dot = x_dot + cls._DT * x_acc
        th = th + cls._DT * th_dot
        th_dot = th_dot + cls._DT * th_acc
        nxt = torch.stack([x, x_dot, th, th_dot], dim=-1)
        t = state.t + 1
        done = ((x.abs() > cls._X_LIM) | (th.abs() > cls._THETA_LIM)
                | (t >= cls._MAX_T))
        reward = torch.ones_like(x)
        # auto-reset: both sides computed, one select (no branch, no host
        # read)
        fresh = _uniform(state.gen, nxt.shape, nxt.device)
        nxt = torch.where(done[:, None], fresh, nxt)
        t = torch.where(done, torch.zeros_like(t), t)
        return CartPoleState(x=nxt, t=t, gen=state.gen), nxt, reward, done

    @classmethod
    def from_host_state(cls, x, gen: torch.Generator, t=None,
                        device: DeviceLike = None) -> CartPoleState:
        """Adopt a raw state [B, 4] (parity tests drive the JAX and torch
        dynamics from the same initial conditions). ``gen`` must live on
        ``device``."""
        device = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        t_arr = (torch.zeros(x.shape[0], dtype=torch.int32, device=device)
                 if t is None else
                 torch.as_tensor(t, dtype=torch.int32, device=device))
        return CartPoleState(x=x, t=t_arr, gen=gen)


DEVICE_ENVS = {"CartPole-v1": TorchCartPole}


def make_device_env(name: str):
    if name not in DEVICE_ENVS:
        raise KeyError(f"no device env {name!r}; available: "
                       f"{sorted(DEVICE_ENVS)}")
    return DEVICE_ENVS[name]
