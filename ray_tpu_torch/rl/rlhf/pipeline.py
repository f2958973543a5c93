"""The RLHF pipeline driver: four roles, strict phases, weight sync (port
of ``ray_tpu/rl/rlhf/pipeline.py``).

One iteration is four phases over four roles:

  generate   prompts decode on the generator's ``ContinuousEngine``
             slots (``models/serving.py``: mid-flight admission, k-step
             ticks; the engine the serve path runs)
  score      the reward model scores full sequences; the frozen reference
             model logprobs the generated spans
  update     the learner runs a PPO-style clipped update on the sampled
             sequences (sequence-level advantage = reward - kl_coeff *
             KL(policy || reference), batch-normalised with the
             population std, as ``jnp.std``)
  sync       the learner's weights land in the generator through the
             engine's drain-barrier ``load_params`` swap, so in-flight
             streams finish under the old weights and the next generate
             phase decodes the new ones

Placement. When the port's runtime is initialized, the pipeline places
the roles as JAX does: four actors (learner, reference, reward,
generator, the generator with one restart) in one ``PACK`` placement
group (``train/worker_group.RoleGroup("rlhf-<trace>")``), each bundle
with ``cpus_per_role`` CPUs and ``gpus_per_role`` GPUs (by default, on
``cuda``: a quarter of the one card each, or a card each where the
cluster has four; on the CPU none); each role computes on ``cuda``
unless the pipeline was asked for the CPU, all four are created before a
readiness ``ping``, and reward and reference score in parallel. The
learner ships a COPY of its policy in the generator's dtype with
``collective.ship_params`` (the ticket carries the stream address, not
the weights); the generator redeems it with ``fetch_params`` and swaps
it in behind the engine's drain barrier; a failed sync cancels the
shipment, and the producer's pump receipt joins the iteration record.
The shipment's leaves above the stream's inline size travel through the
node's object store, each freed once the generator has decoded it, so
the store holds at most one shipment at a time (2.2 GB of bf16 at 1b),
and less where the generator keeps up with the learner. ``ship_params``
needs the cluster backend: on the local backend the first sync raises,
as JAX's does.

Without a runtime the four roles are plain objects in one process on
one device (``cuda`` unless asked), called in JAX's phase order, reward
and reference one after the other. ``ship_weights`` then returns a
ticket holding the copy itself, ``sync_weights`` hands it to
``load_params``, and the receipt says ``"transport": "device"``; a failed
sync drops the copy (``cancel_shipment``).

Aliasing. JAX's arrays are immutable, so each role's params are its own.
The port updates in place, so every role owns a copy: params passed to a
role (the port's tensors or a numpy pytree shaped like JAX's) are copied
at construction, and a role built from the seed makes its own.

Each role stamps its phase interval inside the method (wall-clock
``t0``/``t1``, after the device work it waits for), and the driver joins
them into one iteration record on the pipeline flight recorder
(``util/pipeline_recorder.py``). The ``rt_rlhf_*`` series and the
pipeline's trace context go through an :class:`RLHFHooks` object, where
JAX writes them into its metrics registry and tracing.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import (params_from_jax,
                                          reward_params_from_jax)
from ray_tpu_torch.models.serving import ContinuousEngine
from ray_tpu_torch.parallel.train_step import Adam, _leaves, value_and_grad
from ray_tpu_torch.rl.models import host_tree
from ray_tpu_torch.rl.rlhf import models as rlhf_models
from ray_tpu_torch.util.pipeline_recorder import PipelineRecorder
from ray_tpu_torch.util.recorder_core import Sinks

Preset = Union[str, llama.LlamaConfig]

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RLHFConfig:
    """JAX's fields and defaults, and ``gpus_per_role`` beside JAX's
    ``cpus_per_role``. ``preset`` may also be a ``LlamaConfig`` (a preset
    with another attention backend or compute dtype)."""

    preset: Preset = "debug"
    num_prompts: int = 4          # sequences per iteration
    prompt_len: int = 8
    max_new_tokens: int = 16
    max_slots: int = 4            # generation engine decode slots
    decode_stride: int = 4
    lr: float = 1e-4
    kl_coeff: float = 0.1
    clip_param: float = 0.2
    num_epochs: int = 2
    seed: int = 0
    cpus_per_role: float = 1.0    # each role actor's CPUs
    # each role actor's GPUs: None = a quarter of one card on cuda, one
    # card each where the cluster has four, none on the CPU
    gpus_per_role: Optional[float] = None

    @property
    def max_len(self) -> int:
        return self.prompt_len + self.max_new_tokens + 2


class RLHFHooks:
    """Where the pipeline reports; every method is a no-op here.

    Subclass it to bind the calls to a metrics and tracing backend."""

    def metric(self, series: str, op: str, value: float,
               tags: Optional[Dict[str, str]] = None) -> None:
        """One observation after every iteration (JAX's series):
        ``rt_rlhf_iterations_total`` and ``rt_rlhf_tokens_generated_total``
        (op ``"inc"``), ``rt_rlhf_reward_mean`` (``"set"``),
        ``rt_rlhf_phase_seconds`` (``"observe"``, tags phase and side:
        ``driver`` or ``actor``), ``rt_rlhf_weight_sync_bytes_total``
        (``"inc"``, tag transport) and ``rt_rlhf_weight_sync_seconds``
        (``"observe"``)."""

    def activate(self, ctx: Dict[str, str]) -> Any:
        """Make the pipeline's trace context ({trace_id, span_id}) ambient
        around role construction and every iteration's phases; returns a
        token for :meth:`deactivate` (JAX: ``tracing.activate``)."""
        return None

    def deactivate(self, token: Any) -> None:
        """Undo :meth:`activate`."""


# ---------------------------------------------------------------------------
# roles
# ---------------------------------------------------------------------------


def _config(preset: Preset) -> llama.LlamaConfig:
    return llama.PRESETS[preset] if isinstance(preset, str) else preset


def _copy_tree(tree, device: torch.device, dtype: torch.dtype):
    """A fresh copy of every tensor of a params tree on ``device`` in
    ``dtype`` (never the same storage, even where nothing converts)."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v, device, dtype) for k, v in tree.items()}
    return tree.detach().to(device=device, dtype=dtype, copy=True)


def _own_policy(params, cfg: llama.LlamaConfig, seed: int,
                device: torch.device, dtype: torch.dtype):
    """The role's own policy params: drawn from ``seed`` when ``params``
    is None, else a copy of the port's tensors or of a numpy pytree."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        return llama.init_params(cfg, generator=gen, device=device,
                                 dtype=dtype)
    if isinstance(params.get("embed"), torch.Tensor):
        return _copy_tree(params, device, dtype)
    return params_from_jax(params, cfg, device=device, dtype=dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RLHFLearner:
    """The policy owner: fp32 master params, the PPO-style sequence update
    with the constant Adam, and weight shipment by ticket."""

    def __init__(self, preset: Preset, seed: int, lr: float,
                 kl_coeff: float, clip_param: float, num_epochs: int, *,
                 params=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = _config(preset)
        self._params = _own_policy(params, self.cfg, seed, self.device,
                                   torch.float32)
        self._kl_coeff = kl_coeff
        self._clip = clip_param
        self._num_epochs = num_epochs
        self._opt = Adam(lr)
        self._opt_state = self._opt.init(self._params)
        self._updates = 0

    def ping(self) -> str:
        return "learner"

    def _loss(self, params, tokens, old_logp, adv, prompt_len):
        logp = rlhf_models.seq_logprob_body(params, tokens, prompt_len,
                                            self.cfg)
        ratio = torch.exp(logp - old_logp)
        a = adv[:, None]
        surr = torch.minimum(
            ratio * a,
            torch.clamp(ratio, 1 - self._clip, 1 + self._clip) * a)
        return -torch.mean(surr), {"ratio_mean": torch.mean(ratio)}

    def update(self, sequences, rewards, ref_logps,
               prompt_len: int) -> Dict[str, Any]:
        """One PPO-style update on the sampled sequences; returns the
        iteration's metrics, the phase stamp and the new monotonic
        weights-version."""
        t0 = time.time()
        dev = self.device
        tokens = torch.tensor(np.asarray(sequences, np.int64), device=dev)
        rewards = torch.tensor(np.asarray(rewards, np.float32), device=dev)
        ref_logps = torch.tensor(np.asarray(ref_logps, np.float32),
                                 device=dev)
        old_logp = rlhf_models.sequence_logprobs(
            self._params, tokens, prompt_len, self.cfg)
        # sequence-level objective: reward-model score minus the KL
        # anchor to the reference policy, normalised across the batch
        kl_seq = torch.sum(old_logp - ref_logps, dim=-1)
        adj = rewards - self._kl_coeff * kl_seq
        adv = (adj - adj.mean()) / (adj.std(correction=0) + 1e-6)
        loss = ratio = torch.zeros((), device=dev)
        for _ in range(self._num_epochs):
            (loss, aux), grads = value_and_grad(
                lambda p: self._loss(p, tokens, old_logp, adv, prompt_len),
                self._params, has_aux=True)
            ratio = aux["ratio_mean"]
            self._opt.update(self._params, grads, self._opt_state)
            del grads
        self._updates += 1
        # the reads wait for the last epoch: t1 stamps after the device
        # work, or the driver would book it as orchestration tax
        loss_f, ratio_f = float(loss), float(ratio)
        kl_f = float(torch.mean(kl_seq))
        reward_f = float(torch.mean(rewards))
        t1 = time.time()
        return {"loss": loss_f, "ratio_mean": ratio_f,
                "kl_mean": kl_f, "reward_mean": reward_f,
                "updates": self._updates, "version": self._updates,
                "t0": t0, "t1": t1, "wall_s": round(t1 - t0, 6)}

    def ship_weights(self) -> Dict[str, Any]:
        """Snapshot the current policy for the generator: a copy of every
        leaf in the compute dtype (the engine's), shipped with
        ``collective.ship_params`` where the port's runtime is initialized
        (a role actor; the ticket is then the shipment's), else held by
        the ticket itself (one process); the ticket also carries the
        weights-version, the leaf and byte counts and the ship stamp
        (after the copy has landed)."""
        t0 = time.time()
        copy = _copy_tree(self._params, self.device, self.cfg.compute_dtype)
        _sync(self.device)
        if rt.is_initialized():
            from ray_tpu_torch import collective

            ticket = collective.ship_params(copy)
        else:
            leaves = _leaves(copy).values()
            ticket = {"params": copy, "n_leaves": len(leaves),
                      "nbytes": sum(t.numel() * t.element_size()
                                    for t in leaves)}
        t1 = time.time()
        ticket.update(version=self._updates, t0=t0, t1=t1,
                      wall_s=round(t1 - t0, 6))
        return ticket

    def shipment_receipt(self, sid: str) -> Optional[Dict[str, Any]]:
        """The producer's pump receipt of one shipment (first and last
        ``take``), joined with the consumer's fetch into the iteration's
        transfer receipt."""
        from ray_tpu_torch import collective

        return collective.shipment_receipt(sid)

    def cancel_shipment(self, ticket: Dict[str, Any]) -> None:
        """Drop an unredeemed ticket's copy or shipment (the pipeline
        calls this when the generator's sync fails)."""
        if "sid" in ticket:
            from ray_tpu_torch import collective

            collective.cancel_shipment(ticket)
        ticket.pop("params", None)

    def get_params(self):
        return self._params


class RLHFReference:
    """Frozen copy of the initial policy: the KL anchor."""

    def __init__(self, preset: Preset, seed: int, *, params=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = _config(preset)
        # the same seed as the learner's: the reference IS the initial
        # policy, per the standard RLHF recipe
        self._params = _own_policy(params, self.cfg, seed, self.device,
                                   torch.float32)

    def ping(self) -> str:
        return "reference"

    def logprobs(self, sequences, prompt_len: int) -> Dict[str, Any]:
        t0 = time.time()
        tokens = torch.tensor(np.asarray(sequences, np.int64),
                              device=self.device)
        out = _host(rlhf_models.sequence_logprobs(
            self._params, tokens, prompt_len, self.cfg))
        t1 = time.time()
        return {"logprobs": out, "t0": t0, "t1": t1,
                "wall_s": round(t1 - t0, 6)}


class RLHFReward:
    """The preference model: scalar score per full sequence."""

    def __init__(self, preset: Preset, seed: int, *, params=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = _config(preset)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self._params = rlhf_models.init_reward_params(
                self.cfg, generator=gen, device=self.device,
                dtype=torch.float32)
        elif isinstance(params.get("head"), torch.Tensor):
            self._params = _copy_tree(params, self.device, torch.float32)
        else:
            self._params = reward_params_from_jax(
                params, self.cfg, device=self.device, dtype=torch.float32)

    def ping(self) -> str:
        return "reward"

    def score(self, sequences) -> Dict[str, Any]:
        t0 = time.time()
        tokens = torch.tensor(np.asarray(sequences, np.int64),
                              device=self.device)
        out = _host(rlhf_models.reward_score(self._params, tokens, self.cfg))
        t1 = time.time()
        return {"scores": out, "t0": t0, "t1": t1,
                "wall_s": round(t1 - t0, 6)}


class RLHFGenerator:
    """The generation role: one ContinuousEngine (the serve path's
    continuous batcher) decoding the policy in the compute dtype; weight
    syncs land through the drain-barrier swap."""

    def __init__(self, preset: Preset, seed: int, max_slots: int,
                 max_len: int, decode_stride: int, *, params=None,
                 device: DeviceLike = None):
        self.device = device = resolve_device(device)
        self.cfg = _config(preset)
        # same seed as the learner: generation starts on the SAME initial
        # policy the learner will update
        params = _own_policy(params, self.cfg, seed, device,
                             self.cfg.compute_dtype)
        self.engine = ContinuousEngine(
            params, self.cfg, max_slots=max_slots, max_len=max_len,
            decode_stride=decode_stride, device=device)
        # the version of the weights decoding now (0 = the seed init; each
        # sync stamps the learner version its ticket carried; an actor
        # restart rebuilds on the seed weights, version 0 again)
        self._weights_version = 0

    def ping(self) -> str:
        return "generator"

    def generate(self, prompts, max_new_tokens: int) -> Dict[str, Any]:
        """Decode every prompt through the engine's slots (mid-flight
        admission; the engine queues past the slot budget). Returns full
        sequences (prompt + generation), engine counters, and the
        weights-version the batch decoded under."""
        t0 = time.time()
        tp0 = time.perf_counter()
        version_start = self._weights_version
        queues = [self.engine.submit_stream(
            np.asarray(p, np.int32), max_new_tokens) for p in prompts]
        seqs = []
        for p, q in zip(prompts, queues):
            toks = [t for t in iter(q.get, None)]
            seqs.append(list(p) + toks)
        dt = time.perf_counter() - tp0
        t1 = time.time()
        n_new = sum(len(s) - len(p) for s, p in zip(seqs, prompts))
        return {"sequences": np.asarray(seqs, np.int32),
                "tokens_generated": n_new,
                "tok_s": round(n_new / max(dt, 1e-9), 1),
                "wall_s": round(dt, 4),
                "t0": t0, "t1": t1,
                "weights_version_start": version_start,
                "weights_version": self._weights_version,
                "engine": self.engine.stats()}

    def sync_weights(self, ticket: Dict[str, Any]) -> Dict[str, Any]:
        """Redeem the learner's ticket: its copy (one process) or its
        shipment (``collective.fetch_params``, the leaves landing on this
        role's card in the engine's dtype), swapped in behind the drain
        barrier (the engine adopts the tensors). Stamps the sync interval
        and the version now decoding; the ticket is redeemed once."""
        t0 = time.time()
        tp0 = time.perf_counter()
        if "sid" in ticket:
            from ray_tpu_torch import collective

            params, info = collective.fetch_params(ticket)
        else:
            params = ticket.pop("params")
            info = {"transport": "device", "rpcs": 0,
                    "nbytes": int(ticket["nbytes"]),
                    "n_leaves": int(ticket["n_leaves"]),
                    "oid_leaves": 0, "inline_leaves": 0}
        swap = self.engine.load_params(params)
        del params
        self._weights_version = int(
            ticket.get("version", self._weights_version + 1))
        info.update(swap)
        info["version"] = self._weights_version
        info["sync_s"] = round(time.perf_counter() - tp0, 4)
        info["t0"] = t0
        info["t1"] = time.time()
        return info

    def engine_stats(self) -> Dict[str, Any]:
        return self.engine.stats()


# ---------------------------------------------------------------------------
# the pipeline driver
# ---------------------------------------------------------------------------


class RLHFPipeline:
    """Builds the four roles (actors of a ``RoleGroup`` where the port's
    runtime is initialized, else objects on one device) and runs
    generate, score, update and sync in turn.

    ``params`` (the initial policy) and ``reward_params`` default to
    draws from ``cfg.seed`` and ``cfg.seed + 1``; given, each role copies
    them. ``sinks`` receive the flight recorder's drain; ``hooks`` the
    ``rt_rlhf_*`` series and the trace context. ``trace_id`` names the
    pipeline's trace. On actors ``learner``, ``reference``, ``reward`` and
    ``generator`` are the roles' actor handles, and ``group`` their
    ``RoleGroup``.
    """

    def __init__(self, cfg: Optional[RLHFConfig] = None, *, params=None,
                 reward_params=None, device: DeviceLike = None,
                 hooks: Optional[RLHFHooks] = None,
                 sinks: Optional[Sinks] = None, **overrides):
        self.cfg = cfg or RLHFConfig(**overrides)
        c = self.cfg
        self.device = resolve_device(device)
        self.hooks = hooks or RLHFHooks()
        self._rng = np.random.default_rng(c.seed)
        self._lock = threading.Lock()
        self._iterations = 0       # rt: guarded-by(_lock)
        self._tokens_generated = 0  # rt: guarded-by(_lock)
        self._sync_bytes = 0       # rt: guarded-by(_lock)
        self._last: Dict[str, Any] = {}  # rt: guarded-by(_lock)
        # the learner's weights-version as of the LAST completed update
        # (what the learner held while this iteration's batch decoded):
        # staleness = this minus the version the generator decoded under
        self._learner_version = 0  # rt: guarded-by(_lock)
        self._trace_ctx = {"trace_id": uuid.uuid4().hex,
                           "span_id": uuid.uuid4().hex[:16]}
        self.trace_id = self._trace_ctx["trace_id"]
        dev = self.device
        self.group = None
        token = self.hooks.activate(self._trace_ctx)
        try:
            if rt.is_initialized():
                self._place_roles(host_tree(params), host_tree(reward_params))
            else:
                self.learner = RLHFLearner(
                    c.preset, c.seed, c.lr, c.kl_coeff, c.clip_param,
                    c.num_epochs, params=params, device=dev)
                self.reference = RLHFReference(c.preset, c.seed,
                                               params=params, device=dev)
                self.reward = RLHFReward(c.preset, c.seed + 1,
                                         params=reward_params, device=dev)
                self.generator = RLHFGenerator(
                    c.preset, c.seed, c.max_slots, c.max_len,
                    c.decode_stride, params=params, device=dev)
        finally:
            self.hooks.deactivate(token)
        self.recorder = PipelineRecorder(f"rlhf-{self.trace_id[:8]}",
                                         sinks=sinks)

    def gpus_per_role(self) -> float:
        """Each role's GPUs: ``cfg.gpus_per_role`` where set, else none
        on the CPU and, on ``cuda``, a card each where the cluster has
        four or more, else a quarter of one."""
        if self.cfg.gpus_per_role is not None:
            return float(self.cfg.gpus_per_role)
        if self.device.type != "cuda":
            return 0.0
        gpus = rt.cluster_resources().get("GPU", 0)
        if gpus < 1:
            raise RuntimeError(
                "the RLHF roles compute on cuda and the cluster has no "
                "GPU; pass device='cpu' for roles on the CPU")
        return 1.0 if gpus >= 4 else 0.25

    def _place_roles(self, params, reward_params) -> None:
        """The four roles as actors of one ``PACK`` placement group,
        created together, then pinged (JAX's ``RoleGroup.start``)."""
        from ray_tpu_torch.train.worker_group import RoleGroup

        c = self.cfg
        dev = self.device.type
        res = {"num_cpus": c.cpus_per_role, "num_gpus": self.gpus_per_role()}
        g = RoleGroup(f"rlhf-{self.trace_id[:8]}", strategy="PACK")
        g.add_role("learner", RLHFLearner, c.preset, c.seed, c.lr,
                   c.kl_coeff, c.clip_param, c.num_epochs, params=params,
                   device=dev, **res)
        g.add_role("reference", RLHFReference, c.preset, c.seed,
                   params=params, device=dev, **res)
        g.add_role("reward", RLHFReward, c.preset, c.seed + 1,
                   params=reward_params, device=dev, **res)
        # the generator survives one crash: it rebuilds on the seed
        # weights (version 0), which the next staleness stamp shows
        g.add_role("generator", RLHFGenerator, c.preset, c.seed,
                   c.max_slots, c.max_len, c.decode_stride, params=params,
                   device=dev, options={"max_restarts": 1}, **res)
        g.start()
        self.group = g
        self.learner, self.reference = g["learner"], g["reference"]
        self.reward, self.generator = g["reward"], g["generator"]

    def _submit(self, role: str, method: str, *args):
        """``role.method(*args)``: submitted (a ref) on actors, run in
        process (its value)."""
        fn = getattr(getattr(self, role), method)
        return fn.remote(*args) if self.group is not None else fn(*args)

    def _value(self, out):
        return rt.get(out) if self.group is not None else out

    # -- phases -----------------------------------------------------------

    def _sample_prompts(self) -> List[List[int]]:
        c = self.cfg
        vocab = _config(c.preset).vocab_size
        return [[int(t) for t in
                 self._rng.integers(1, vocab, size=c.prompt_len)]
                for _ in range(c.num_prompts)]

    def run_iteration(self) -> Dict[str, Any]:
        """One generate -> score -> update -> sync round; returns the
        iteration's metrics (also reported through the hooks and joined
        onto the pipeline flight recorder). A round that dies mid-phase
        stamps the interrupted phase on the recorder before re-raising."""
        c = self.cfg
        with self._lock:
            learner_version = self._learner_version
        iter_t0 = time.time()
        iter_p0 = time.perf_counter()
        cur_phase = "generate"
        token = self.hooks.activate(self._trace_ctx)
        try:
            phases: Dict[str, float] = {}
            t0 = time.perf_counter()
            gen = self._value(self._submit(
                "generator", "generate", self._sample_prompts(),
                c.max_new_tokens))
            phases["generate"] = time.perf_counter() - t0
            seqs = gen["sequences"]

            cur_phase = "score"
            t0 = time.perf_counter()
            # reward and reference are independent reads: in parallel on
            # actors (JAX's), one after the other in one process
            reward_out = self._submit("reward", "score", seqs)
            ref_out = self._submit("reference", "logprobs", seqs,
                                   c.prompt_len)
            reward_out, ref_out = self._value(reward_out), \
                self._value(ref_out)
            rewards = reward_out["scores"]
            ref_logps = ref_out["logprobs"]
            phases["score"] = time.perf_counter() - t0

            cur_phase = "update"
            t0 = time.perf_counter()
            update = self._value(self._submit(
                "learner", "update", seqs, rewards, ref_logps,
                c.prompt_len))
            phases["update"] = time.perf_counter() - t0

            cur_phase = "ship"
            t0 = time.perf_counter()
            ticket = self._value(self._submit("learner", "ship_weights"))
            d_ship = time.perf_counter() - t0
            cur_phase = "sync_swap"
            try:
                sync = self._value(self._submit("generator", "sync_weights",
                                                ticket))
            except BaseException:
                # the ticket was never redeemed: drop its copy or its
                # shipment (a stranded shipment holds a policy copy)
                try:
                    self._value(self._submit("learner", "cancel_shipment",
                                             ticket))
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
                raise
            d_swap = time.perf_counter() - t0 - d_ship
            phases["sync"] = time.perf_counter() - t0
            # the iteration's work ends here: the pump receipt read below
            # is recorder telemetry, outside the wall the coverage divides
            iter_p1 = time.perf_counter()
            pump = None
            if "sid" in ticket:
                try:
                    pump = self._value(self._submit(
                        "learner", "shipment_receipt", ticket["sid"]))
                except Exception:  # noqa: BLE001 — receipt is telemetry
                    pump = None
        except BaseException as exc:
            try:
                self.recorder.record_interrupt(
                    phase=cur_phase, t=time.time(), error=repr(exc))
            except Exception:  # noqa: BLE001 — recorder never masks
                pass           # the real failure
            raise
        finally:
            self.hooks.deactivate(token)
        iter_wall = iter_p1 - iter_p0

        intervals = [
            {"role": "generator", "phase": "generate",
             "t0": gen["t0"], "t1": gen["t1"]},
            {"role": "reward", "phase": "score_reward",
             "t0": reward_out["t0"], "t1": reward_out["t1"]},
            {"role": "reference", "phase": "score_ref",
             "t0": ref_out["t0"], "t1": ref_out["t1"]},
            {"role": "learner", "phase": "update",
             "t0": update["t0"], "t1": update["t1"]},
            {"role": "learner", "phase": "ship",
             "t0": ticket["t0"], "t1": ticket["t1"]},
            {"role": "generator", "phase": "sync_swap",
             "t0": sync["t0"], "t1": sync["t1"]},
        ]
        driver_s = {"generate": phases["generate"],
                    "score": phases["score"],
                    "update": phases["update"],
                    "ship": d_ship, "sync_swap": d_swap}
        receipt = {"version": int(ticket.get("version", 0)),
                   "nbytes": int(sync["nbytes"]),
                   "n_leaves": int(sync.get("n_leaves", 0)),
                   "oid_leaves": int(sync.get("oid_leaves", 0)),
                   "inline_leaves": int(sync.get("inline_leaves", 0)),
                   "transport": sync["transport"],
                   "rpcs": int(sync.get("rpcs", 0)),
                   "ship_wall_s": ticket.get("wall_s", 0.0),
                   "fetch_wall_s": sync.get("fetch_wall_s", 0.0),
                   "barrier_drain_s": sync["drain_s"],
                   "swap_apply_s": sync.get("apply_s", 0.0)}
        if pump and "pump_wall_s" in pump:
            receipt["pump_wall_s"] = pump["pump_wall_s"]
            receipt["frames_taken"] = int(pump.get("frames_taken", 0))
        decoded_version = int(gen.get("weights_version", 0))
        staleness = max(0, learner_version - decoded_version)

        result = {
            "iteration": None,  # filled under the lock below
            "tokens_generated": int(gen["tokens_generated"]),
            "generate_tok_s": gen["tok_s"],
            "reward_mean": update["reward_mean"],
            "kl_mean": update["kl_mean"],
            "loss": update["loss"],
            "sync_transport": sync["transport"],
            "sync_bytes": int(sync["nbytes"]),
            "sync_oid_leaves": int(sync.get("oid_leaves", 0)),
            "sync_s": sync["sync_s"],
            "swap_drain_s": sync["drain_s"],
            "phases_s": {k: round(v, 4) for k, v in phases.items()},
            "phases_actor_s": {iv["phase"]: round(
                max(0.0, iv["t1"] - iv["t0"]), 4) for iv in intervals},
            "weights_version": int(update.get("version", 0)),
            "decoded_version": decoded_version,
            "staleness": staleness,
            "receipt": receipt,
            "trace_id": self.trace_id,
        }
        with self._lock:
            self._iterations += 1
            self._tokens_generated += result["tokens_generated"]
            self._sync_bytes += result["sync_bytes"]
            self._learner_version = result["weights_version"]
            result["iteration"] = self._iterations
            self._last = result
        try:
            derived = self.recorder.record_iteration(
                iteration=result["iteration"], t0=iter_t0,
                wall_s=iter_wall, intervals=intervals,
                driver_s=driver_s,
                tokens=result["tokens_generated"],
                learner_version=learner_version,
                decoded_version=decoded_version, receipt=receipt)
            result["bubble_fraction"] = derived.get("bubble_fraction")
            result["coverage"] = derived.get("coverage")
            result["tax_s"] = derived.get("tax_s")
            if derived.get("restart_gap_s") is not None:
                result["restart_gap_s"] = derived["restart_gap_s"]
        except Exception:  # noqa: BLE001 — recorder never fails a round
            pass
        try:
            self._report(result, phases, intervals)
        except Exception:  # noqa: BLE001 — telemetry never fails a round
            pass
        return result

    def _report(self, result: Dict[str, Any], phases: Dict[str, float],
                intervals: List[Dict[str, Any]]) -> None:
        m = self.hooks.metric
        m("rt_rlhf_iterations_total", "inc", 1.0)
        m("rt_rlhf_tokens_generated_total", "inc",
          float(result["tokens_generated"]))
        m("rt_rlhf_reward_mean", "set", result["reward_mean"])
        for phase, secs in phases.items():
            m("rt_rlhf_phase_seconds", "observe", secs,
              {"phase": phase, "side": "driver"})
        for iv in intervals:
            m("rt_rlhf_phase_seconds", "observe",
              max(0.0, iv["t1"] - iv["t0"]),
              {"phase": iv["phase"], "side": "actor"})
        m("rt_rlhf_weight_sync_bytes_total", "inc",
          float(result["sync_bytes"]),
          {"transport": result["sync_transport"]})
        m("rt_rlhf_weight_sync_seconds", "observe", result["sync_s"])

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"iterations": self._iterations,
                   "tokens_generated": self._tokens_generated,
                   "sync_bytes_total": self._sync_bytes,
                   "trace_id": self.trace_id,
                   "placement": (
                       self.group.describe() if self.group is not None
                       else {role: str(self.device) for role in
                             ("learner", "reference", "reward",
                              "generator")}),
                   "last": dict(self._last)}
        try:
            out["recorder"] = self.recorder.summary()
        except Exception:  # noqa: BLE001 — stats never fail on telemetry
            pass
        return out

    def shutdown(self) -> None:
        try:
            self.recorder.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        if self.group is not None:
            self.group.shutdown()
        else:
            self.generator.engine.shutdown()
