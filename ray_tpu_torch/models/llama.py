"""Llama-family decoder-only transformer (port of ``ray_tpu/models/llama.py``).

Parameters are a plain dict shaped like the JAX pytree: layer weights are
stacked on a leading [n_layers] axis and keep JAX's ``x @ W`` orientation
(``wq`` is [d, hq*hd], ``lm_head`` is [d, V]); with ``tie_embeddings`` the
head is ``embed.T``. Every param is cast to the compute dtype where it is
used, as JAX's ``.astype(cdt)``; ``Tensor.to`` returns the tensor itself
when the dtype already matches. So serving stores its params in the
compute dtype (``init_params``' default, ``convert.params_from_jax``) and
pays no cast, while training keeps fp32 masters (``dtype=torch.float32``)
and casts at each use, as the JAX trainer does.

Attention backends: ``attn_impl="xla"`` runs the plain PyTorch ``mha``;
``"flash"`` runs the CUDA flash kernels (their plain versions on the CPU),
forward and backward; ``"ring"`` and ``"ulysses"`` split the sequence over
the mesh's ``sp`` axis (``parallel/context.py``; they need the ambient
``mesh_scope`` the train step sets) and attend through the same kernels.

Training: ``lm_loss`` and ``chunked_ce``. With ``cfg.remat`` and grad
enabled, each decoder block runs under ``torch.utils.checkpoint``
(non-reentrant): it keeps only the block's input and recomputes the rest
in backward. JAX's ``jax.checkpoint`` with
``dots_with_no_batch_dims_saveable`` keeps the matmul outputs too: a
different save set, the same values. Under ring or Ulysses attention the
recompute runs the block's collectives again (every rank the same ones,
in the same order). ``pipeline_axis`` splits the layer stack over that
mesh axis (``parallel/pipeline.py``): GPipe through ``lm_loss``, or with
``pipeline_schedule="1f1b"`` the interleaved schedule of
``lm_loss_and_grads_1f1b``, which returns the gradients itself.

On a mesh (``parallel/train_step.py``) the params and the batch are
DTensors placed by ``sharding_rules`` and ``data_rules``, and the same
functions run on them: each weight is cast and then all-gathered over
fsdp where it is used (``sharding.gather_fsdp``, ZeRO-3); each block's
attention and MLP run on the rank's local blocks (``sharding.rows_map``:
rows over dp and fsdp, heads and ff columns over tp), so the flash
kernels only ever see plain tensors, and the residual add sums the tp
shares; the embedding lookup and the loss run under DTensor propagation
on the vocab-sharded table and head. Under ring or Ulysses attention
the stream is also split over ``sp`` by sequence between the embedding
and the final norm (``sharding.split_sequence``): each block runs on its
rank's chunk with the RoPE positions of that chunk, and the final norm
and the loss run on the whole sequence again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import mha
from ray_tpu_torch.ops.flash import flash_attention
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, rope_angles
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.context import (SP_IMPLS, current_mesh,
                                            mesh_scope,
                                            sequence_parallel_attention)
from ray_tpu_torch.parallel.sharding import P, ShardingRules

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # Cross-entropy sequence chunk: >0 computes the loss in [B, chunk, V]
    # slices, each recomputed in backward, so the full fp32 logits never
    # materialize at once
    loss_chunk: int = 0
    # "xla" (plain PyTorch mha, the reference), "flash" (CUDA kernels),
    # "ring" / "ulysses" (sequence-parallel over the mesh "sp" axis; need
    # an ambient mesh_scope)
    attn_impl: str = "xla"
    # Pipeline parallelism: "pp" splits the layer stack over that mesh axis
    # (not with ring/ulysses). Schedule: "gpipe" (stash grows with M) or
    # "1f1b" (interleaved manual backward, stash O(P): parallel/pipeline.py)
    pipeline_axis: Optional[str] = None
    pipeline_microbatches: int = 4
    pipeline_schedule: str = "gpipe"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every parameter's shape, layer weights as ``layers/<name>``
        (each model family lists its own leaves)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        shapes = {
            "embed": (self.vocab_size, d),
            "layers/attn_norm": (L, d),
            "layers/wq": (L, d, hq * hd),
            "layers/wk": (L, d, hkv * hd),
            "layers/wv": (L, d, hkv * hd),
            "layers/wo": (L, hq * hd, d),
            "layers/mlp_norm": (L, d),
            "layers/w_gate": (L, d, f),
            "layers/w_up": (L, d, f),
            "layers/w_down": (L, f, d),
            "final_norm": (d,),
        }
        if not self.tie_embeddings:
            shapes["lm_head"] = (d, self.vocab_size)
        return shapes


PRESETS: Dict[str, LlamaConfig] = {
    "debug": LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128, max_seq_len=128),
    "debug_draft": LlamaConfig(vocab_size=256, d_model=32, n_layers=1,
                               n_heads=2, n_kv_heads=1, d_ff=64,
                               max_seq_len=128),
    "160m": LlamaConfig(vocab_size=32000, d_model=768, n_layers=12, n_heads=12,
                        n_kv_heads=12, d_ff=2048, max_seq_len=2048),
    "410m": LlamaConfig(vocab_size=32000, d_model=1024, n_layers=24, n_heads=16,
                        n_kv_heads=16, d_ff=2816, max_seq_len=2048),
    "1b": LlamaConfig(vocab_size=32000, d_model=2048, n_layers=22, n_heads=32,
                      n_kv_heads=4, d_ff=5632, max_seq_len=2048),
    "7b": LlamaConfig(),
}

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")


def _fan_in(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """Scaled-normal fan-in of a matrix; None for a norm (ones)."""
    if name.endswith("norm"):
        return None
    return shape[1] if name == "embed" else shape[-2]


def _unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    params: Params = {"layers": {}}
    for name, t in flat.items():
        if name.startswith("layers/"):
            params["layers"][name[len("layers/"):]] = t
        else:
            params[name] = t
    return params


def init_params(cfg: LlamaConfig, *, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Scaled-normal init from ``generator`` (which must live on
    ``device``) of every leaf of ``cfg.param_shapes()``; layer params
    stacked on a leading [n_layers] axis, stored in ``dtype`` (default:
    the compute dtype)."""
    return _unflatten(dict(init_leaves(cfg, generator=generator,
                                       device=resolve_device(device),
                                       dtype=dtype or cfg.compute_dtype)))


def init_leaves(cfg: LlamaConfig, *, generator: torch.Generator,
                device: torch.device, dtype: torch.dtype):
    """``init_params``' leaves one at a time, as (flat name, tensor) in
    ``cfg.param_shapes()`` order: ``init_sharded_state`` places each
    before the next is drawn."""
    for name, shape in cfg.param_shapes().items():
        fan_in = _fan_in(name, shape)
        if fan_in is None:
            yield name, torch.ones(shape, dtype=dtype, device=device)
            continue
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        yield name, x.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def layer_params(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights: views into the stacked tensors."""
    return {k: w[i] for k, w in params["layers"].items()}


def weight(w: torch.Tensor, cfg) -> torch.Tensor:
    """A param as a matmul uses it: cast to the compute dtype and, on a
    mesh, all-gathered over fsdp (``sharding.gather_fsdp``)."""
    return sharding.gather_fsdp(w.to(cfg.compute_dtype))


def lm_head(params: Params, cfg: LlamaConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return weight(head, cfg)


def embed(params: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """The embedding rows of ``tokens`` in the compute dtype: gathered,
    then cast (the values of JAX's cast-then-gather). On a mesh the lookup
    runs on the table gathered over fsdp and still split over tp by vocab
    (``sharding.embedding``): the residual stream starts partial over tp
    and its first use sums it."""
    table = params["embed"]
    if not sharding.is_sharded(table):
        return table[tokens].to(cfg.compute_dtype)
    return sharding.embedding(tokens, sharding.gather_fsdp(table),
                              cfg.compute_dtype)


def attend(cfg: LlamaConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *, q_offset: Union[int, torch.Tensor] = 0,
           segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention through the configured backend."""
    if cfg.attn_impl != "xla" and segment_ids is not None:
        raise NotImplementedError(
            f"segment_ids (packed sequences) require attn_impl='xla'; got "
            f"{cfg.attn_impl!r} — failing loudly rather than attending "
            f"across document boundaries")
    if cfg.attn_impl in SP_IMPLS:
        return sequence_parallel_attention(q, k, v, impl=cfg.attn_impl,
                                           causal=True)
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=True, q_offset=q_offset)
    if cfg.attn_impl == "xla":
        return mha(q, k, v, causal=True, segment_ids=segment_ids,
                   q_offset=q_offset)
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo")
FFN_KEYS = ("mlp_norm", "w_gate", "w_up", "w_down")


def _attention_out(cfg: LlamaConfig, x: torch.Tensor,
                   layer: Dict[str, torch.Tensor], sin: torch.Tensor,
                   cos: torch.Tensor,
                   segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """What pre-norm attention adds to the residual stream. On a rank's
    blocks (heads split over tp) it is that rank's share: the sum over
    its heads of their output projections."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    cdt = cfg.compute_dtype
    h = rmsnorm(x, layer["attn_norm"].to(cdt), cfg.norm_eps)
    q = apply_rope((h @ layer["wq"].to(cdt)).reshape(b, s, -1, hd), sin,
                   cos)
    k = apply_rope((h @ layer["wk"].to(cdt)).reshape(b, s, -1, hd), sin,
                   cos)
    v = (h @ layer["wv"].to(cdt)).reshape(b, s, -1, hd)
    attn = attend(cfg, q, k, v, segment_ids=segment_ids)
    return attn.reshape(b, s, -1) @ layer["wo"].to(cdt)


def _ffn_out(cfg: LlamaConfig, x: torch.Tensor,
             layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """What the pre-norm SwiGLU MLP adds to the residual stream (on a
    rank's blocks: its share over its ff columns)."""
    cdt = cfg.compute_dtype
    h = rmsnorm(x, layer["mlp_norm"].to(cdt), cfg.norm_eps)
    gate = F.silu(h @ layer["w_gate"].to(cdt))
    up = h @ layer["w_up"].to(cdt)
    return (gate * up) @ layer["w_down"].to(cdt)


def _on_blocks(fn, cfg, x: torch.Tensor, layer: Dict[str, torch.Tensor],
               keys: Tuple[str, ...], ids=()) -> torch.Tensor:
    """``fn(x, {key: weight}, *ids)`` on a mesh: the weights cast and
    gathered over fsdp (``weight``), then ``sharding.rows_map`` runs
    ``fn`` on each rank's blocks."""
    ws = tuple(weight(layer[k], cfg) for k in keys)
    local = lambda x, *rest: fn(x, dict(zip(keys, rest[:len(keys)])),
                                *rest[len(keys):])
    return sharding.rows_map(local, x, ws, ids)


def attention_half(cfg: LlamaConfig, x: torch.Tensor,
                   layer: Dict[str, torch.Tensor],
                   sin: torch.Tensor, cos: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Pre-norm attention + residual. On a mesh the attention runs on
    each rank's [b/(dp*fsdp), s, h/tp, d] blocks (s/sp where the stream
    splits its sequence, with the RoPE tables of the rank's positions),
    so the flash kernels only see plain tensors; q and kv heads split
    contiguously by the same tp keep GQA's head map local
    (``plan.compile_plan`` checks both head counts divide by tp)."""
    if not sharding.is_sharded(x):
        return x + _attention_out(cfg, x, layer, sin, cos, segment_ids)
    sin, cos = sharding.sequence_block(x, sin, cos)
    fn = lambda x, lw, *seg: _attention_out(cfg, x, lw, sin, cos,
                                            seg[0] if seg else None)
    ids = () if segment_ids is None else (segment_ids,)
    return sharding.residual_add(
        x, _on_blocks(fn, cfg, x, layer, ATTN_KEYS, ids))


def ffn_half(cfg: LlamaConfig, x: torch.Tensor,
             layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pre-norm SwiGLU MLP + residual — shared by the train and decode
    paths."""
    if not sharding.is_sharded(x):
        return x + _ffn_out(cfg, x, layer)
    fn = lambda x, lw: _ffn_out(cfg, x, lw)
    return sharding.residual_add(x, _on_blocks(fn, cfg, x, layer, FFN_KEYS))


def _block(cfg: LlamaConfig, x: torch.Tensor, layer: Dict[str, torch.Tensor],
           sin: torch.Tensor, cos: torch.Tensor,
           segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """One decoder block: pre-norm attention + pre-norm SwiGLU MLP."""
    x = attention_half(cfg, x, layer, sin, cos, segment_ids)
    return ffn_half(cfg, x, layer)


def _stage_scan(cfg: LlamaConfig, stage_layers: Dict[str, torch.Tensor],
                h: torch.Tensor, seg: Optional[torch.Tensor]) -> torch.Tensor:
    """One pipeline stage: this rank's block of layers over ``h`` (plain
    tensors), the stage body of both schedules. The RoPE tables are made
    here, as JAX's stage makes them inside its shard_map body. No remat
    inside: the schedules recompute whole stages."""
    sin, cos = rope_angles(h.shape[1], cfg.head_dim, cfg.rope_theta,
                           cfg.compute_dtype, h.device)
    layers = {k: w.unbind(0) for k, w in stage_layers.items()}
    for i in range(len(layers["wq"])):
        h = _block(cfg, h, {k: ws[i] for k, ws in layers.items()}, sin,
                   cos, seg)
    return h


def _pipeline_mesh(cfg: LlamaConfig, subject: str, what: str):
    """The ambient mesh a pipeline schedule runs on, with JAX's refusals
    (in its words for ``subject`` and ``what``): no ring or Ulysses
    attention inside a pipeline, and a mesh."""
    if cfg.attn_impl in SP_IMPLS:
        raise ValueError(f"{subject} incompatible with ring/ulysses "
                         f"attention (nested shard_map); use attn_impl="
                         f"'flash' or 'xla'")
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"{what} needs an ambient mesh "
                         f"(parallel.context.mesh_scope)")
    return mesh


def _pipelined_layers(layers: Dict[str, torch.Tensor], x, cfg: LlamaConfig,
                      segment_ids) -> torch.Tensor:
    """The layer stack split over the ``pp`` mesh axis, GPipe-microbatched
    (``pipeline.pipeline_apply``). The batch rides (dp, fsdp, tp) inside
    the pipeline: each tp lane runs its own rows through whole stages
    (stage weights are replicated across tp, as in JAX's layout)."""
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = _pipeline_mesh(cfg, "pipeline_axis is", "pipeline_axis")

    def stage(stage_layers, h, seg=None):
        return _stage_scan(cfg, stage_layers, h, seg)

    return pipeline_apply(
        stage, layers, x, mesh, axis_name=cfg.pipeline_axis,
        num_microbatches=cfg.pipeline_microbatches,
        batch_axes=(("dp", "fsdp", "tp"),), remat=cfg.remat,
        extras=segment_ids)


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [batch, seq] -> (final-norm hidden [batch, seq, d], head
    [d, V]), both in the compute dtype."""
    cdt = cfg.compute_dtype
    x = embed(params, tokens, cfg)
    if cfg.pipeline_axis is not None:
        x = _pipelined_layers(params["layers"], x, cfg, segment_ids)
    else:
        x = _layers(params, x, cfg, segment_ids)
    x = rmsnorm(x, params["final_norm"].to(cdt), cfg.norm_eps)
    return x, lm_head(params, cfg)


def remat_context_fn():
    """``checkpoint``'s ``context_fn`` for a block that may run ring or
    Ulysses attention: the recompute runs where autograd's engine runs it
    (a device thread for CUDA tensors), outside this thread's
    ``mesh_scope``, so it gets the forward's mesh back through its own
    context."""
    mesh = current_mesh()
    if mesh is None:
        return noop_context_fn
    return lambda: (contextlib.nullcontext(), mesh_scope(mesh))


def _layers(params: Params, x, cfg: LlamaConfig, segment_ids):
    """The decoder blocks in order, each under remat when training."""
    sin, cos = rope_angles(x.shape[1], cfg.head_dim, cfg.rope_theta,
                           cfg.compute_dtype, x.device)
    if cfg.attn_impl in SP_IMPLS:
        x = sharding.split_sequence(x)
    # unbind, not w[i]: one stack in backward instead of a full-size zero
    # gradient per layer
    layers = {k: w.unbind(0) for k, w in params["layers"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    contexts = remat_context_fn()
    for i in range(cfg.n_layers):
        layer = {k: ws[i] for k, ws in layers.items()}
        if remat:
            x = checkpoint(_block, cfg, x, layer, sin, cos, segment_ids,
                           use_reentrant=False, context_fn=contexts)
        else:
            x = _block(cfg, x, layer, sin, cos, segment_ids)
    return sharding.gather_sequence(x)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [batch, seq] -> logits [batch, seq, vocab] (fp32)."""
    x, head = forward_hidden(params, tokens, cfg, segment_ids)
    return (x @ head).float()


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy (fp32 scalar); ``batch`` has tokens
    [B, S+1] and optionally ``loss_mask`` [B, S] and ``segment_ids``
    [B, S]. ``cfg.loss_chunk`` (dividing S, smaller than S) computes it in
    sequence chunks (``chunked_ce``)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x, head = forward_hidden(params, inputs, cfg, batch.get("segment_ids"))
    return chunked_ce(x, head, targets, batch.get("loss_mask"),
                      cfg.loss_chunk)


def lm_loss_and_grads_1f1b(params: Params, batch: Dict[str, torch.Tensor],
                           cfg: LlamaConfig):
    """(loss, grads) through the interleaved 1F1B pipeline
    (``pipeline.pipeline_1f1b``), which computes the stages' gradients
    itself. The embedding lookup is differentiated outside the pipeline
    (autograd takes the first stage's input cotangents back into the
    table); the final norm and the head sit inside the last stage's loss,
    so the backward can start there. ``make_train_step`` picks it for
    ``cfg.pipeline_schedule == "1f1b"``. The grads are DTensors partial
    where the schedule leaves them (the step sums them)."""
    from ray_tpu_torch.parallel.pipeline import pipeline_1f1b

    if cfg.tie_embeddings:
        raise NotImplementedError(
            "1f1b needs untied embeddings (the head lives inside the "
            "pipeline's last stage; the embedding outside it)")
    mesh = _pipeline_mesh(cfg, "pipeline schedules are", "1f1b")
    cdt = cfg.compute_dtype
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    table = params["embed"].detach().requires_grad_(True)
    with torch.enable_grad():
        x = embed({"embed": table}, inputs, cfg)
    batch_axes = ("dp", "fsdp", "tp")
    if sharding.is_sharded(x):
        x = x.redistribute(x.device_mesh, sharding.placements(
            P(batch_axes), x.device_mesh, x.ndim))

    def stage_fn(stage_layers, h, seg):
        return _stage_scan(cfg, stage_layers, h, seg)

    def head_loss_fn(head, y, tgt, msk):
        y = rmsnorm(y, head["final_norm"].to(cdt), cfg.norm_eps)
        return chunked_ce(y, head["lm_head"].to(cdt), tgt, msk,
                          cfg.loss_chunk)

    head = {"final_norm": params["final_norm"],
            "lm_head": params["lm_head"]}
    loss, g_layers, g_head, g_x = pipeline_1f1b(
        stage_fn, head_loss_fn, params["layers"], head, x.detach(), targets,
        mesh, axis_name=cfg.pipeline_axis,
        num_microbatches=cfg.pipeline_microbatches, batch_axes=batch_axes,
        segments=batch.get("segment_ids"), loss_mask=batch.get("loss_mask"))
    if sharding.is_sharded(x):
        g_x = g_x.redistribute(x.device_mesh, x.placements)
    g_embed, = torch.autograd.grad(x, [table], g_x)
    grads = {"embed": g_embed, "final_norm": g_head["final_norm"],
             "lm_head": g_head["lm_head"]}
    grads.update({f"layers/{k}": g for k, g in g_layers.items()})
    return loss, grads


def _nll(x: torch.Tensor, head: torch.Tensor,
         targets: torch.Tensor) -> torch.Tensor:
    logits = (x @ head).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def _chunk_sums(x, head, targets, mask):
    nll = _nll(x, head, targets)
    return (nll * mask).sum(), mask.sum()


def chunked_ce(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
               mask: Optional[torch.Tensor], chunk: int) -> torch.Tensor:
    """Cross entropy from final hiddens [B, S, d] and head [d, V].

    With ``chunk`` dividing S (and smaller), each [B, chunk, V] slice of
    fp32 logits is made, reduced and dropped, and recomputed in backward
    under ``torch.utils.checkpoint`` (JAX's ``nothing_saveable`` scan), so
    peak memory holds one slice instead of [B, S, V] and its gradient."""
    S = targets.shape[1]
    if chunk and S % chunk == 0 and S > chunk:
        m = (torch.ones_like(targets, dtype=torch.float32) if mask is None
             else mask.float())
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, S, chunk):
            sl = slice(c, c + chunk)
            args = (x[:, sl], head, targets[:, sl], m[:, sl])
            if torch.is_grad_enabled():
                s, n = checkpoint(_chunk_sums, *args, use_reentrant=False)
            else:
                s, n = _chunk_sums(*args)
            total, count = total + s, count + n
        return total / count.clamp(min=1)
    nll = _nll(x, head, targets)
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def sharding_rules(pipeline: bool = False) -> ShardingRules:
    """JAX's param partitioning over the (dp, fsdp, tp) mesh
    (``ray_tpu/models/llama.py:374-412``): the stacked-layer axis
    unsharded, matrices with their contracting and output dims on (fsdp,
    tp), so forward matmuls all-gather over fsdp (ZeRO-3) and reduce over
    tp; norms replicated. Pipelined (``pipeline``): the layer stack over
    ``pp`` and every other dim, and the embedding and head, replicated:
    the pipeline consumes whole stage weights, so they are stored so."""
    if pipeline:
        return ShardingRules([
            (r"layers/", P("pp")),
            (r".*", P()),
        ])
    return ShardingRules([
        (r"embed$", P("tp", "fsdp")),
        (r"lm_head$", P("fsdp", "tp")),
        (r"layers/w[qkv]$", P(None, "fsdp", "tp")),
        (r"layers/wo$", P(None, "tp", "fsdp")),
        (r"layers/w_(gate|up)$", P(None, "fsdp", "tp")),
        (r"layers/w_down$", P(None, "tp", "fsdp")),
        (r"layers/.*norm", P(None)),
        (r"norm", P()),
    ])


def data_rules() -> ShardingRules:
    return ShardingRules([(r".*", P(("dp", "fsdp"), None))])
