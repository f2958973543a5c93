"""RLHF model pieces over the Llama trunk: reward scoring and sequence
logprobs (port of ``ray_tpu/rl/rlhf/models.py``).

- the REWARD model is a Llama trunk with a scalar head read at the last
  position;
- the REFERENCE model is a frozen copy of the initial policy, whose
  per-token logprobs anchor the KL penalty;
- the POLICY is the Llama LM itself.

Attention runs through ``llama.forward_hidden``, so with
``attn_impl="flash"`` on ``cuda`` the scoring forwards launch the
tensor-core forward kernel and the learner's backward the dq and dkv
kernels (``ops/flash.py``). JAX caches one compiled program per (config,
shape); eager PyTorch compiles nothing, so there is no cache here.
``reward_score`` and ``sequence_logprobs`` are the scoring entry points
(JAX's jitted ones) and run without autograd; ``seq_logprob_body`` is the
differentiable core the learner's loss calls.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import llama

Params = Dict[str, object]


def init_reward_params(cfg: llama.LlamaConfig, *,
                       generator: torch.Generator,
                       device: DeviceLike = None,
                       dtype: Optional[torch.dtype] = None) -> Params:
    """Llama trunk + scalar reward head [d, 1] (read at the final
    position), drawn from ``generator`` (on ``device``) and stored in
    ``dtype`` (default: the compute dtype)."""
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    lm = llama.init_params(cfg, generator=generator, device=device,
                           dtype=dtype)
    head = torch.randn((cfg.d_model, 1), generator=generator,
                       dtype=torch.float32, device=device)
    head = head.mul_(1.0 / math.sqrt(cfg.d_model)).to(dtype)
    return {"lm": lm, "head": head}


@torch.no_grad()
def reward_score(rm: Params, tokens: torch.Tensor,
                 cfg: llama.LlamaConfig) -> torch.Tensor:
    """tokens [B, S] -> reward [B] (fp32): the last position's hidden
    state times the head, cast to the hidden's dtype."""
    hidden, _ = llama.forward_hidden(rm["lm"], tokens, cfg)
    return (hidden[:, -1, :] @ rm["head"].to(hidden.dtype)).float()[:, 0]


def seq_logprob_body(params: Params, tokens: torch.Tensor, prompt_len: int,
                     cfg: llama.LlamaConfig) -> torch.Tensor:
    """The differentiable core of :func:`sequence_logprobs`: logits of
    tokens[:, :-1], log-softmax, and the logprob of each generated token
    tokens[:, prompt_len:] under the logits that predict it,
    logits[:, prompt_len-1:]."""
    logits = llama.forward(params, tokens[:, :-1], cfg)
    logp_all = torch.log_softmax(logits, dim=-1)
    targets = tokens[:, prompt_len:]
    preds = logp_all[:, prompt_len - 1:, :]
    return torch.gather(preds, -1, targets.long()[..., None])[..., 0]


@torch.no_grad()
def sequence_logprobs(params: Params, tokens: torch.Tensor, prompt_len: int,
                      cfg: llama.LlamaConfig) -> torch.Tensor:
    """Per-token logprob of the GENERATED span under ``params``.

    tokens [B, S] (prompt + generation, S > prompt_len) -> [B, S -
    prompt_len] logprobs of tokens[:, prompt_len:] given their prefixes.
    """
    s = tokens.shape[1]
    if prompt_len < 1 or prompt_len >= s:
        raise ValueError(f"prompt_len {prompt_len} out of range for "
                         f"sequence length {s}")
    return seq_logprob_body(params, tokens, prompt_len, cfg)
