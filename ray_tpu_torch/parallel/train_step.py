"""The training step on one device (port of ``ray_tpu/parallel/train_step.py``).

``default_optimizer`` is optax's ``chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))`` written out (JAX leaves it to
optax, not to a kernel). ``make_train_step`` returns ``(params, opt_state,
batch) -> (params, opt_state, {"loss", "grad_norm"})``: the loss and its
gradients through the Llama forward (``attn_impl="flash"`` runs the CUDA
flash kernels forward and backward), then the optimizer.

Unlike JAX, which donates the buffers to a pure function, the step updates
params and optimizer state in place and returns the same objects: at the
1b preset that saves a 4.4 GB copy of the fp32 params (and 8.8 GB of
moments) a step. The mesh, ``Plan``, 1f1b and the step profiler are not
ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, check_params_on, resolve_device
from ray_tpu_torch.models import llama

Batch = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.95, 1e-8    # JAX's default_optimizer passes these


def _leaves(params: llama.Params) -> Dict[str, torch.Tensor]:
    """Every param tensor by name, layer weights as ``layers/<name>``."""
    flat = {}
    for name, node in params.items():
        if isinstance(node, dict):
            flat.update({f"{name}/{k}": t for k, t in node.items()})
        else:
            flat[name] = node
    return flat


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Clip by the global norm, then AdamW on a warmup-cosine schedule, with
    optax's arithmetic:

    - clip (``optax.clip_by_global_norm``): g * grad_clip / norm when the
      norm is at least ``grad_clip``, g otherwise;
    - moments m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, bias-corrected
      by the update count after its increment; update m^ / (sqrt(v^) + eps)
      plus ``weight_decay`` * param on every leaf (optax's default mask);
    - the update times -lr(count), with count taken before its increment
      (``warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup +
      1))``): the first step has lr 0 and moves no param, though the
      moments update.
    """

    lr: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    grad_clip: float

    def schedule(self, count: int) -> float:
        """Linear warmup from 0, then cosine decay to 0."""
        warm = self.warmup_steps
        if count < warm:
            return self.lr * count / warm
        decay = max(self.total_steps, warm + 1) - warm
        t = min(count - warm, decay)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    def init(self, params: llama.Params) -> dict:
        leaves = _leaves(params)
        zeros = lambda: {k: torch.zeros_like(t, dtype=torch.float32)
                         for k, t in leaves.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, params: llama.Params, grads: Dict[str, torch.Tensor],
               state: dict) -> torch.Tensor:
        """Apply one step to ``params`` and ``state`` in place; returns the
        global norm of ``grads`` before clipping. ``grads`` is consumed (it
        is clipped in place)."""
        norm = torch.nn.utils.get_total_norm(list(grads.values()))
        clip = torch.where(norm < self.grad_clip, 1.0,
                           self.grad_clip / norm)
        lr = self.schedule(state["count"])
        count = state["count"] + 1
        bc1, bc2 = 1.0 - B1 ** count, 1.0 - B2 ** count
        for name, p in _leaves(params).items():
            g = grads[name].mul_(clip)
            m, v = state["mu"][name], state["nu"][name]
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(EPS))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        state["count"] = count
        return norm


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup_steps: int = 100, total_steps: int = 10000,
                      grad_clip: float = 1.0) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
                 total_steps=total_steps, grad_clip=grad_clip)


def init_state(cfg: llama.LlamaConfig, optimizer: AdamW, *,
               generator: torch.Generator, device: DeviceLike = None
               ) -> Tuple[llama.Params, dict]:
    """fp32 master params from ``generator`` (which must live on
    ``device``) and the optimizer's zero state; the one-device stand-in for
    JAX's ``init_sharded_state``."""
    params = llama.init_params(cfg, generator=generator, device=device,
                               dtype=torch.float32)
    return params, optimizer.init(params)


def _to_device(batch: Batch, device: torch.device) -> Batch:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: llama.LlamaConfig, optimizer: AdamW,
                    loss_fn: Optional[Callable] = None,
                    device: DeviceLike = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}), params and state updated in place (the same objects come
    back). ``batch`` holds tokens [B, S+1] (numpy or tensors; moved to the
    device). ``grad_norm`` is the global norm before clipping. The metrics
    are 0-d tensors on the device: reading them waits for the step."""
    device = resolve_device(device)
    loss_fn = loss_fn or llama.lm_loss

    def step(params, opt_state, batch):
        check_params_on(params, device)
        batch = _to_device(batch, device)
        leaves = _leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
        try:
            loss = loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        finally:
            for t in leaves.values():
                t.requires_grad_(False)
        gnorm = optimizer.update(params, dict(zip(leaves, grads)), opt_state)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def make_multi_step(cfg: llama.LlamaConfig, optimizer: AdamW, n_steps: int,
                    loss_fn: Optional[Callable] = None,
                    device: DeviceLike = None) -> Callable:
    """K train steps over a stacked batch: (params, opt_state, batches) ->
    (params, opt_state, metrics) with each leaf of ``batches`` [K, ...] and
    each metric [K]. JAX fuses the K steps into one ``lax.scan`` program;
    here they are a loop of ``make_train_step``'s step."""
    step = make_train_step(cfg, optimizer, loss_fn, device)

    def steps(params, opt_state, batches):
        for k, v in batches.items():
            if len(v) != n_steps:
                raise ValueError(f"batch leaf {k!r} stacks {len(v)} steps, "
                                 f"want {n_steps}")
        per_step = []
        for i in range(n_steps):
            params, opt_state, m = step(params, opt_state,
                                        {k: v[i] for k, v in batches.items()})
            per_step.append(m)
        return params, opt_state, {k: torch.stack([m[k] for m in per_step])
                                   for k in per_step[0]}

    return steps


def _batch_tokens(batch, stacked: bool = False) -> Tuple[int, int]:
    """(trained tokens, seq len) of one step's batch. Token batches are
    [B, S+1] ([K, B, S+1] stacked): S positions train per row. A batch with
    no usable token-shaped leaf gives (0, 1)."""
    need = 3 if stacked else 2
    leaf = batch.get("tokens") if isinstance(batch, dict) else None
    if leaf is None or np.ndim(leaf) < need:
        values = batch.values() if isinstance(batch, dict) else ()
        cands = [x for x in values if np.ndim(x) >= need]
        if not cands:
            return 0, 1
        leaf = cands[0]
    shape = tuple(leaf.shape)
    if stacked:
        k, b, s1 = shape[:3]
        return k * b * max(1, s1 - 1), max(1, s1 - 1)
    b, s1 = shape[:2]
    return b * max(1, s1 - 1), max(1, s1 - 1)
