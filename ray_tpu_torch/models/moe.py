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

On a mesh (``sharding_rules``: experts over ``ep``, their ff dim over
``tp``, their model dim over ``fsdp``) the routing stays JAX's global one:
the FFN's input is all-gathered over the data axes and every rank routes
every token (``_route``, ``_assign``, through ``local_map``, the same on
each rank),
then runs only its experts and ff columns (``_experts``), so its output
is partial over ep and tp and the residual add sums it. Every rank of a
(dp, fsdp) group repeats the routing and its experts' work for the whole
batch: the semantics of JAX's single program, not its speed.
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
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.sharding import P, ShardingRules

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


init_leaves = llama.init_leaves
_unflatten = llama._unflatten


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


def _assign(cfg: MoEConfig, probs: torch.Tensor, topk_idx: torch.Tensor,
            dtype: torch.dtype):
    """Capacity slots for the selections (module docstring): (each
    selection's row in its expert's buffer [G, K], the spare row
    ``min(C, G)`` where dropped; keep [G, K]; gates [G, K] in ``dtype``, 0
    where dropped; the aux loss)."""
    G = probs.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, G)
    topk_probs = probs.gather(1, topk_idx)
    topk_probs = topk_probs / (topk_probs.sum(-1, keepdim=True) + 1e-9)

    # slot = earlier selections of the same expert in [K, G] order
    flat = topk_idx.T.reshape(K * G)
    onehot = F.one_hot(flat, E)                                   # [KG, E]
    slot_flat = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    slot = slot_flat.reshape(K, G).T                              # [G, K]
    keep = slot < C
    gates = (topk_probs * keep).to(dtype)
    row = torch.where(keep, slot, min(C, G))   # dropped -> the spare row

    frac = F.one_hot(topk_idx[:, 0], E).float().mean(0)          # top-1
    aux = E * (frac * probs.mean(0)).sum()
    return row, keep, gates, aux


def _capacity(cfg: MoEConfig, G: int) -> int:
    """C, the slots of each expert's capacity buffer for G tokens."""
    return max(1, int(cfg.capacity_factor * G * cfg.top_k / cfg.n_experts))


def _experts(tokens: torch.Tensor, topk_idx: torch.Tensor,
             row: torch.Tensor, keep: torch.Tensor, gates: torch.Tensor,
             e_gate: torch.Tensor, e_up: torch.Tensor, e_down: torch.Tensor,
             cb: int, first: int = 0) -> torch.Tensor:
    """Experts ``first``.. (as many as ``e_gate`` holds) on their
    selections: tokens scattered by index into an [E, cb + 1, d] buffer,
    three batched matmuls, each token's K outputs gathered back and
    summed, weighted by its gates. A dropped selection, or one of another
    rank's experts, goes to the spare row ``cb`` and adds nothing; on a
    rank's blocks the sum is its share, over its experts and ff
    columns."""
    G, d = tokens.shape
    K, n, cdt = topk_idx.shape[1], e_gate.shape[0], tokens.dtype
    mine = keep & (topk_idx >= first) & (topk_idx < first + n)
    e = torch.where(mine, topk_idx - first, 0)
    r = torch.where(mine, row, cb)
    expert_in = tokens.new_zeros(n, cb + 1, d).index_put(
        (e, r), tokens[:, None, :].expand(G, K, d))
    gate = F.silu(expert_in @ e_gate.to(cdt))
    up = expert_in @ e_up.to(cdt)
    expert_out = (gate * up) @ e_down.to(cdt)                    # [n, cb+1, d]
    picked = torch.where(mine[..., None], expert_out[e, r], 0)   # [G, K, d]
    return (picked.float() * gates.float()[..., None]).sum(1).to(cdt)


def _moe_ffn(cfg: MoEConfig, h: torch.Tensor,
             layer: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S, d] -> ([B, S, d], aux_loss): top-k capacity routing
    (module docstring), dispatched by index."""
    b, s, d = h.shape
    tokens = h.reshape(b * s, d)
    probs, topk_idx = _route(cfg, tokens, layer)
    row, keep, gates, aux = _assign(cfg, probs, topk_idx, tokens.dtype)
    out = _experts(tokens, topk_idx, row, keep, gates, layer["e_gate"],
                   layer["e_up"], layer["e_down"],
                   min(_capacity(cfg, b * s), b * s))
    return out.reshape(b, s, d), aux


def _sharded_ffn(cfg: MoEConfig, x: torch.Tensor,
                 layer: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on a mesh (module docstring): (what it adds to the
    residual stream x, aux loss). The routing map takes x gathered over
    the data axes and gives every rank the same selections (all its
    outputs replicated); the experts map gives each rank's share, partial
    over ep and tp. Their local gradients: the routing's inputs get the
    same full gradient on every rank (its outputs' gradients are summed
    first); the experts' tokens and gates get shares, partial over ep and
    tp; an expert weight gets its full gradient, the same on every rank
    of a data group (each saw every token)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    cdt = cfg.compute_dtype
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    b, s, d = x.shape
    G = b * s
    cb = min(_capacity(cfg, G), G)
    rep = (Replicate(),) * len(names)
    shares = tuple(Partial() if n in ("ep", "tp") else Replicate()
                   for n in names)
    norm, router = layer["mlp_norm"].to(cdt), llama.weight(
        layer["router"], cfg)
    experts = [llama.weight(layer[k], cfg)
               for k in ("e_gate", "e_up", "e_down")]

    def route(x, norm, router):
        tokens = rmsnorm(x, norm, cfg.norm_eps).reshape(G, d)
        probs, topk_idx = _route(cfg, tokens, {"router": router})
        return (tokens, topk_idx,
                *_assign(cfg, probs, topk_idx, tokens.dtype))

    tokens, topk_idx, row, keep, gates, aux = local_map(
        route, out_placements=(rep,) * 6, in_placements=(rep,) * 3,
        in_grad_placements=(rep,) * 3, device_mesh=mesh,
        redistribute_inputs=True)(x, norm, router)
    first = sharding.block_box(layer["e_gate"].shape, mesh.shape,
                               experts[0].placements,
                               mesh.get_coordinate())[0][0]
    out = local_map(
        lambda *a: _experts(*a, cb=cb, first=first),
        out_placements=(shares,),
        in_placements=(rep,) * 5 + tuple(w.placements for w in experts),
        in_grad_placements=(shares, rep, rep, rep, shares) + tuple(
            w.placements for w in experts),
        device_mesh=mesh, redistribute_inputs=True)(
        tokens, topk_idx, row, keep, gates, *experts)
    return out.reshape(b, s, d), aux


def ffn_half(cfg: MoEConfig, x: torch.Tensor,
             layer: Dict[str, torch.Tensor], drop_free: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE FFN + residual; returns (hidden, aux_loss).
    ``drop_free``: capacity covers every selection (inference routing:
    capacity drops are a training-time load-balancing construct)."""
    c = (dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
         if drop_free else cfg)
    if sharding.is_sharded(x):
        ffn, aux = _sharded_ffn(c, x, layer)
        return sharding.residual_add(x, ffn), aux
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
    x = llama.embed(params, tokens, cfg)
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


def sharding_rules(pipeline: bool = False) -> ShardingRules:
    """JAX's rules (``ray_tpu/models/moe.py:219-235``): Llama's, plus the
    experts over ``ep``, their ff dim over ``tp`` and model dim over
    ``fsdp``; the router's model dim over fsdp."""
    if pipeline:
        raise NotImplementedError(
            "pipeline parallelism for the MoE family is not implemented")
    return ShardingRules([
        (r"embed$", P("tp", "fsdp")),
        (r"lm_head$", P("fsdp", "tp")),
        (r"layers/w[qkv]$", P(None, "fsdp", "tp")),
        (r"layers/wo$", P(None, "tp", "fsdp")),
        (r"layers/router$", P(None, "fsdp", None)),
        (r"layers/e_(gate|up)$", P(None, "ep", "fsdp", "tp")),
        (r"layers/e_down$", P(None, "ep", "tp", "fsdp")),
        (r"layers/.*norm", P(None)),
        (r"norm", P()),
    ])


data_rules = llama.data_rules
