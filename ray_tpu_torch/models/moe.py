"""Mixtral-style sparse-MoE transformer (port of ``ray_tpu/models/moe.py``).

The attention half, RoPE, norms and the chunked loss are the Llama
family's (:mod:`ray_tpu_torch.models.llama`); each layer's dense SwiGLU
FFN becomes ``n_experts`` stacked experts ([L, E, ...] leaves ``e_gate``,
``e_up``, ``e_down``) behind a router ([L, d, E]).

Routing is JAX's, token for token: router logits in fp32, softmax, the
top ``top_k`` experts (ties to the lower expert index, as ``lax.top_k``),
their gates renormalised, and a slot in each chosen expert's capacity
buffer of ``C = max(1, int(capacity_factor * G * K / E))`` slots given in
the flattened [K, G] selection order; a selection whose slot is ``>= C``
is dropped (the residual stream carries the token). Load-balancing aux
loss: ``E * sum_e(top-1 fraction_e * mean prob_e)``.

The computation is PyTorch's, not JAX's one-hot einsums: JAX's [G, E, C]
dispatch and combine tensors grow as G^2 K E under drop-free routing
(C = G K). Here the tokens are scattered by index into an [E, Cb + 1, d]
buffer, the experts run as three batched ``torch.matmul`` over it, and
each token gathers its K outputs back, weighted by its gates in the
compute dtype (as JAX's combine casts them). ``Cb = min(C, G)``: a token
picks K distinct experts, so no expert holds more than G selections, and
row ``Cb`` takes the dropped ones, whose outputs are discarded. No step
reads a count back to the host.

``sharding_rules`` (the ``ep`` axis) waits for the port's multi-GPU
placement.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rope import rope_angles

Params = llama.Params


@dataclasses.dataclass(frozen=True)
class MoEConfig(llama.LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Llama's leaves with the dense FFN replaced by the router and
        the stacked experts."""
        d, f, E, L = self.d_model, self.d_ff, self.n_experts, self.n_layers
        shapes = super().param_shapes()
        for name in ("w_gate", "w_up", "w_down"):
            del shapes[f"layers/{name}"]
        shapes["layers/router"] = (L, d, E)
        shapes["layers/e_gate"] = (L, E, d, f)
        shapes["layers/e_up"] = (L, E, d, f)
        shapes["layers/e_down"] = (L, E, f, d)
        return shapes

    def active_params(self) -> int:
        """Params touched per token (top-k experts): the FLOPs-relevant
        count for MFU estimates."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        moe = self.top_k * 3 * d * f + d * self.n_experts
        head = 0 if self.tie_embeddings else d * v
        return v * d + l * (attn + moe + 2 * d) + d + head


PRESETS: Dict[str, MoEConfig] = {
    "moe-debug": MoEConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                           n_kv_heads=4, d_ff=128, max_seq_len=256,
                           n_experts=4, top_k=2),
    "8x160m": MoEConfig(vocab_size=32000, d_model=768, n_layers=12,
                        n_heads=12, n_kv_heads=12, d_ff=2048,
                        max_seq_len=2048, n_experts=8, top_k=2),
    "8x410m": MoEConfig(vocab_size=32000, d_model=1024, n_layers=24,
                        n_heads=16, n_kv_heads=16, d_ff=2816,
                        max_seq_len=2048, n_experts=8, top_k=2),
}


def init_params(cfg: MoEConfig, *, generator: torch.Generator,
                device=None, dtype: Optional[torch.dtype] = None) -> Params:
    """Scaled-normal init of Llama's non-FFN leaves, the routers and the
    stacked experts [L, E, ...] from ``generator`` (on ``device``)."""
    return llama.init_params(cfg, generator=generator, device=device,
                             dtype=dtype)


def _route(cfg: MoEConfig, tokens: torch.Tensor,
           layer: Dict[str, torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [G, d] -> (router probs [G, E] in fp32, each token's top-k
    experts [G, K]). A stable descending sort: equal probs keep the lower
    expert first, as ``lax.top_k``."""
    logits = tokens.float() @ layer["router"].float()             # [G, E]
    probs = torch.softmax(logits, dim=-1)
    topk_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[:, :cfg.top_k]
    return probs, topk_idx


def _moe_ffn(cfg: MoEConfig, h: torch.Tensor,
             layer: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S, d] -> ([B, S, d], aux_loss): top-k capacity routing
    (module docstring), dispatched by index."""
    b, s, d = h.shape
    E, K = cfg.n_experts, cfg.top_k
    G = b * s
    C = max(1, int(cfg.capacity_factor * G * K / E))
    cdt = h.dtype
    tokens = h.reshape(G, d)

    probs, topk_idx = _route(cfg, tokens, layer)
    topk_probs = probs.gather(1, topk_idx)
    topk_probs = topk_probs / (topk_probs.sum(-1, keepdim=True) + 1e-9)

    # slot = earlier selections of the same expert in [K, G] order
    flat = topk_idx.T.reshape(K * G)
    onehot = F.one_hot(flat, E)                                   # [KG, E]
    slot_flat = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    slot = slot_flat.reshape(K, G).T                              # [G, K]
    keep = slot < C
    gates = (topk_probs * keep).to(cdt)

    cb = min(C, G)
    row = torch.where(keep, slot, cb)          # dropped -> the spare row
    expert_in = tokens.new_zeros(E, cb + 1, d).index_put(
        (topk_idx, row), tokens[:, None, :].expand(G, K, d))
    gate = F.silu(expert_in @ layer["e_gate"].to(cdt))
    up = expert_in @ layer["e_up"].to(cdt)
    expert_out = (gate * up) @ layer["e_down"].to(cdt)            # [E, Cb+1, d]
    picked = expert_out[topk_idx, row]                            # [G, K, d]
    picked = torch.where(keep[..., None], picked, 0)
    out = (picked.float() * gates.float()[..., None]).sum(1).to(cdt)

    frac = F.one_hot(topk_idx[:, 0], E).float().mean(0)          # top-1
    aux = E * (frac * probs.mean(0)).sum()
    return out.reshape(b, s, d), aux


def ffn_half(cfg: MoEConfig, x: torch.Tensor,
             layer: Dict[str, torch.Tensor], drop_free: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE FFN + residual; returns (hidden, aux_loss).
    ``drop_free``: capacity covers every selection (inference routing:
    capacity drops are a training-time load-balancing construct)."""
    c = (dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
         if drop_free else cfg)
    h = rmsnorm(x, layer["mlp_norm"].to(cfg.compute_dtype), cfg.norm_eps)
    ffn, aux = _moe_ffn(c, h, layer)
    return x + ffn, aux


def _moe_block(cfg: MoEConfig, x: torch.Tensor,
               layer: Dict[str, torch.Tensor], sin: torch.Tensor,
               cos: torch.Tensor, segment_ids: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Llama attention half + the MoE FFN; returns (hidden, aux)."""
    x = llama.attention_half(cfg, x, layer, sin, cos, segment_ids)
    return ffn_half(cfg, x, layer)


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (final-norm hidden, head, mean aux loss over layers); each block
    under ``torch.utils.checkpoint`` with ``cfg.remat`` and grad on."""
    cdt = cfg.compute_dtype
    x = params["embed"][tokens].to(cdt)
    sin, cos = rope_angles(tokens.shape[1], cfg.head_dim, cfg.rope_theta,
                           cdt, x.device)
    layers = {k: w.unbind(0) for k, w in params["layers"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        layer = {k: ws[i] for k, ws in layers.items()}
        if remat:
            x, a = checkpoint(_moe_block, cfg, x, layer, sin, cos,
                              segment_ids, use_reentrant=False)
        else:
            x, a = _moe_block(cfg, x, layer, sin, cos, segment_ids)
        aux = aux + a
    x = rmsnorm(x, params["final_norm"].to(cdt), cfg.norm_eps)
    return x, llama.lm_head(params, cfg), aux / cfg.n_layers


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
            segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [batch, seq] -> logits [batch, seq, vocab] (fp32)."""
    x, head, _ = forward_hidden(params, tokens, cfg, segment_ids)
    return (x @ head).float()


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: MoEConfig) -> torch.Tensor:
    """Next-token CE (llama's ``chunked_ce``) + ``router_aux_coef`` x the
    router aux loss."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x, head, aux = forward_hidden(params, inputs, cfg,
                                  batch.get("segment_ids"))
    ce = llama.chunked_ce(x, head, targets, batch.get("loss_mask"),
                          cfg.loss_chunk)
    return ce + cfg.router_aux_coef * aux
