"""The training step on one device (port of ``ray_tpu/parallel/train_step.py``).

``default_optimizer`` is optax's ``chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))`` written out (JAX leaves it to
optax, not to a kernel). ``make_train_step`` returns ``(params, opt_state,
batch) -> (params, opt_state, {"loss", "grad_norm"})``: the loss and its
gradients through the config's family (``model_family``: the Llama
decoder or the MoE; ``attn_impl="flash"`` runs the CUDA flash kernels
forward and backward), then the optimizer. Both step functions run under
the step profiler's hook (``_instrumented``), one predicate a step while
profiling is off. ``Adam`` is the constant-rate ``optax.adam`` (optionally
behind a global-norm clip) that the RLHF learner and the fused PPO
iteration use; both optimizers share one moment update (``_adam_apply``).
``value_and_grad`` is ``jax.value_and_grad`` over a params tree.

Unlike JAX, which donates the buffers to a pure function, the step updates
params and optimizer state in place and returns the same objects: at the
1b preset that saves a 4.4 GB copy of the fp32 params (and 8.8 GB of
moments) a step. The mesh, ``Plan``, ``shard_batch``, ``auto_mesh`` and
1f1b are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, check_params_on, resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.util import step_profiler

Batch = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.95, 1e-8    # JAX's default_optimizer passes these
ADAM_B2 = 0.999                  # optax.adam's default (b1, eps as above)


def _leaves(params) -> Dict[str, torch.Tensor]:
    """Every param tensor by its path, parts joined by ``/``: the Llama
    family's layer weights as ``layers/<name>``, a list's items by index
    (an MLP's ``pi/layers/0/w``)."""
    flat = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            flat[prefix] = node
            return
        for k, child in items:
            walk(f"{prefix}/{k}" if prefix else str(k), child)

    walk("", params)
    return flat


def _adam_init(params) -> dict:
    leaves = _leaves(params)
    zeros = lambda: {k: torch.zeros_like(t, dtype=torch.float32)
                     for k, t in leaves.items()}
    return {"count": 0, "mu": zeros(), "nu": zeros()}


def _clip_scale(grads: Dict[str, torch.Tensor], max_norm: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global norm, scale): ``optax.clip_by_global_norm``'s factor,
    max_norm / norm when the norm is at least ``max_norm``, else 1. A
    device tensor: no host read."""
    norm = torch.nn.utils.get_total_norm(list(grads.values()))
    return norm, torch.where(norm < max_norm, 1.0, max_norm / norm)


@torch.no_grad()
def _adam_apply(params, grads: Dict[str, torch.Tensor], state: dict, *,
                lr: float, b1: float, b2: float, eps: float,
                scale: Optional[torch.Tensor] = None,
                weight_decay: float = 0.0) -> None:
    """One Adam step in place, optax's arithmetic: each grad times
    ``scale`` (the clip factor; consumed in place), moments m = b1 m +
    (1 - b1) g and v = b2 v + (1 - b2) g^2 bias-corrected by the count
    after its increment, update m^ / (sqrt(v^) + eps) plus
    ``weight_decay`` * param, then the param moves by -lr times it."""
    count = state["count"] + 1
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    for name, p in _leaves(params).items():
        g = grads[name] if scale is None else grads[name].mul_(scale)
        m, v = state["mu"][name], state["nu"][name]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        if weight_decay:
            u.add_(p, alpha=weight_decay)
        p.add_(u, alpha=-lr)
    state["count"] = count


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
        return _adam_init(params)

    def update(self, params: llama.Params, grads: Dict[str, torch.Tensor],
               state: dict) -> torch.Tensor:
        """Apply one step to ``params`` and ``state`` in place; returns the
        global norm of ``grads`` before clipping. ``grads`` is consumed (it
        is clipped in place)."""
        norm, clip = _clip_scale(grads, self.grad_clip)
        _adam_apply(params, grads, state, lr=self.schedule(state["count"]),
                    b1=B1, b2=B2, eps=EPS, scale=clip,
                    weight_decay=self.weight_decay)
        return norm


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr)`` at a constant rate, behind
    ``optax.clip_by_global_norm(grad_clip)`` when ``grad_clip`` is set
    (``optax.chain(clip_by_global_norm(c), adam(lr))``): optax's defaults
    b1 0.9, b2 0.999, eps 1e-8, no weight decay, no schedule, so the first
    step already moves by ``lr``. The RLHF learner and the fused PPO
    iteration train with it (``ray_tpu/rl/rlhf/pipeline.py:164``,
    ``ray_tpu/rl/anakin.py:73-74``)."""

    lr: float
    grad_clip: Optional[float] = None

    def init(self, params) -> dict:
        return _adam_init(params)

    def update(self, params, grads: Dict[str, torch.Tensor],
               state: dict) -> torch.Tensor:
        """Apply one step to ``params`` and ``state`` in place; returns the
        global norm of ``grads`` (before clipping, when clipped). ``grads``
        is consumed."""
        if self.grad_clip is None:
            norm, clip = torch.nn.utils.get_total_norm(
                list(grads.values())), None
        else:
            norm, clip = _clip_scale(grads, self.grad_clip)
        _adam_apply(params, grads, state, lr=self.lr, b1=B1, b2=ADAM_B2,
                    eps=EPS, scale=clip)
        return norm


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup_steps: int = 100, total_steps: int = 10000,
                      grad_clip: float = 1.0) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
                 total_steps=total_steps, grad_clip=grad_clip)


def model_family(cfg):
    """The module implementing ``cfg``'s family (``init_params`` /
    ``lm_loss``): the MoE family for a ``MoEConfig``, the Llama decoder
    otherwise."""
    from ray_tpu_torch.models import moe

    return moe if isinstance(cfg, moe.MoEConfig) else llama


def supports_multi_step(cfg) -> bool:
    """Whether ``make_multi_step`` can fuse K steps for this config. JAX's
    1f1b pipeline schedule cannot; the port's configs have no pipeline
    fields (1f1b is not ported), so this is always true here and the
    driver's degrade logic reads like JAX's."""
    return not (getattr(cfg, "pipeline_axis", None) is not None
                and getattr(cfg, "pipeline_schedule", "gpipe") == "1f1b")


def init_state(cfg: llama.LlamaConfig, optimizer: AdamW, *,
               generator: torch.Generator, device: DeviceLike = None
               ) -> Tuple[llama.Params, dict]:
    """fp32 master params of ``cfg``'s family from ``generator`` (which
    must live on ``device``) and the optimizer's zero state; the
    one-device stand-in for JAX's ``init_sharded_state``."""
    params = model_family(cfg).init_params(cfg, generator=generator,
                                           device=device,
                                           dtype=torch.float32)
    return params, optimizer.init(params)


def _to_device(batch: Batch, device: torch.device) -> Batch:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def value_and_grad(fn: Callable, params, has_aux: bool = False):
    """``jax.value_and_grad`` over a params tree: ``fn(params)`` gives a
    scalar loss (``(loss, aux)`` with ``has_aux``); returns that output,
    detached, and the loss's gradient for every leaf by its ``_leaves``
    name (zeros for a leaf the loss does not reach)."""
    leaves = _leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        out = fn(params)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    detach = lambda t: t.detach() if isinstance(t, torch.Tensor) else t
    if has_aux:
        out = (detach(out[0]), {k: detach(v) for k, v in out[1].items()})
    else:
        out = detach(out)
    return out, dict(zip(leaves, grads))


def make_train_step(cfg: llama.LlamaConfig, optimizer: AdamW,
                    loss_fn: Optional[Callable] = None,
                    device: DeviceLike = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}), params and state updated in place (the same objects come
    back). ``batch`` holds tokens [B, S+1] (numpy or tensors; moved to the
    device). ``grad_norm`` is the global norm before clipping. The metrics
    are 0-d tensors on the device: reading them waits for the step.
    ``loss_fn`` defaults to the family's ``lm_loss``."""
    step = _step_fn(cfg, optimizer, loss_fn, resolve_device(device))
    return _instrumented(step, cfg)


def _step_fn(cfg, optimizer: AdamW, loss_fn: Optional[Callable],
             device: torch.device) -> Callable:
    """The uninstrumented single step of ``make_train_step``."""
    loss_fn = loss_fn or model_family(cfg).lm_loss

    def step(params, opt_state, batch):
        check_params_on(params, device)
        batch = _to_device(batch, device)
        loss, grads = value_and_grad(lambda p: loss_fn(p, batch, cfg),
                                     params)
        gnorm = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_multi_step(cfg: llama.LlamaConfig, optimizer: AdamW, n_steps: int,
                    loss_fn: Optional[Callable] = None,
                    device: DeviceLike = None) -> Callable:
    """K train steps over a stacked batch: (params, opt_state, batches) ->
    (params, opt_state, metrics) with each leaf of ``batches`` [K, ...] and
    each metric [K]. JAX fuses the K steps into one ``lax.scan`` program;
    here they are a loop of ``make_train_step``'s step, with no host read
    between them."""
    if not supports_multi_step(cfg):
        raise NotImplementedError("multi-step over the 1f1b schedule is "
                                  "unsupported; use single-step "
                                  "(StepDriver degrades automatically)")
    step = _step_fn(cfg, optimizer, loss_fn, resolve_device(device))

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

    return _instrumented(steps, cfg, stacked=True, steps_per_launch=n_steps)


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


def _signature(batch) -> Tuple:
    """Shapes and dtypes of a batch's leaves, by key: what a new jit-cache
    entry would be keyed on in JAX."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in batch.items()))


_PROGRAM_IDS = itertools.count()


def _instrumented(fn: Callable, cfg, stacked: bool = False,
                  steps_per_launch: int = 1) -> Callable:
    """The (params, opt_state, batch) entry point every trainer calls: the
    step profiler's per-step record (wall / compile / dispatch / device
    sync split, analytic MFU) around ``fn``. Disabled profiling costs one
    predicate per step. The profiler key is a fresh counter value per
    built step, never ``id(fn)``, which CPython reuses after GC and would
    book a new program's first call as dispatch.

    ``run._signatures`` collects the batch signatures (leaf shapes and
    dtypes) the program has run: eager PyTorch compiles nothing, and their
    count stands in for the size of JAX's jit cache (1 once warm for a
    steady feed)."""
    program_id = next(_PROGRAM_IDS)
    signatures = set()

    def run(params, opt_state, batch):
        signatures.add(_signature(batch))
        if not step_profiler.is_enabled():
            return fn(params, opt_state, batch)
        from ray_tpu_torch.util import flops as F

        tokens, seq = _batch_tokens(batch, stacked)
        return step_profiler.profiled_call(
            "train", fn, (params, opt_state, batch),
            key=("train", program_id), tokens=tokens,
            steps=steps_per_launch,
            flops=tokens * F.train_flops_per_token(cfg, seq))

    run._signatures = signatures
    return run
