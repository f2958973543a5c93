"""StepDriver: the fused-K training fast path (port of
``ray_tpu/train/driver.py``).

One driver owns the whole step path:

- **K-fused launches**: ``steps_per_launch`` batches stack into one
  [K, B, ...] batch and ONE call of ``make_multi_step``'s program runs K
  optimizer steps back to back, with no host read between them (host
  dispatch paid once per K; JAX compiles them into one ``lax.scan``
  program, here they are K eager steps enqueued together).
- **Graceful degrade**: ragged tails (fewer than K batches left) fall
  back to the single-step program, loss- and param-exact either way.
- **Compute-limited accounting**: the driver splits loop wall into host
  (batch pull + stack + device put) and step (dispatch) time and reports
  ``rt_train_steps_per_launch`` / ``rt_train_host_overhead_ratio``
  through :class:`TrainHooks`.
- **Flight recorder**: every fused-K launch stamps its phase walls
  {data_wait, h2d, dispatch, device_compute, host_tax, compile} plus
  K/tokens/shape/analytic FLOPs into
  :class:`~ray_tpu_torch.util.train_recorder.TrainRecorder`
  (``self.recorder``); device-done lands through a CUDA event the
  recorder's watcher thread waits for, never a synchronize on the step
  path. ``RT_TRAIN_RECORDER=0`` reduces this to one predicate per launch.

The mesh and the sharding ``Plan`` are not ported: the driver runs on one
device and refuses ``mesh=`` and ``plan=``. JAX's ``steps_per_launch=None``
reads the train session's ``FastPathConfig``; the port has no session, so
the knob is passed here and defaults to 1.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel import train_step as ts
from ray_tpu_torch.util import flops as F
from ray_tpu_torch.util.recorder_core import Sinks
from ray_tpu_torch.util.train_recorder import TrainRecorder

#: the driver's series, under the JAX package's names
SERIES = {"steps_per_launch": "rt_train_steps_per_launch",
          "host_overhead": "rt_train_host_overhead_ratio"}


class TrainHooks:
    """Where the driver reports its metrics; a no-op here.

    Subclass it to bind the observations to a metrics backend."""

    def metric(self, series: str, op: str, value: float) -> None:
        """One observation: ``rt_train_steps_per_launch`` with op
        ``"observe"`` after every launch (JAX: a histogram with buckets
        1, 2, 4, ..., 64), and ``rt_train_host_overhead_ratio`` with op
        ``"set"`` every 8 launches and at the end of a run (JAX: a
        gauge)."""


class StepDriver:
    """Drives (params, opt_state) through a stream of batches, K steps per
    launch.

    ``batches`` may yield per-step batches (dict leaves shaped [B, ...],
    numpy or tensors: the driver stacks K of them) or pre-stacked
    [k, B, ...] batches from ``iter_device_batches(stack=K)`` (the
    iterator advertises via its ``stack`` attribute). Anything with
    ``k == steps_per_launch`` runs fused; smaller tails run step by step
    through the single-step program.
    """

    def __init__(self, cfg: Any, optimizer: Any, *,
                 mesh: Any = None, loss_fn: Optional[Callable] = None,
                 steps_per_launch: int = 1,
                 plan: Any = None, device: DeviceLike = None,
                 hooks: Optional[TrainHooks] = None,
                 sinks: Optional[Sinks] = None):
        if mesh is not None or plan is not None:
            raise NotImplementedError(
                "the port's StepDriver runs on one device: the mesh and "
                "the sharding Plan are not ported yet")
        if steps_per_launch < 1:
            raise ValueError(
                f"steps_per_launch must be >= 1, got {steps_per_launch}")
        self.device = resolve_device(device)
        self.requested_steps_per_launch = steps_per_launch
        self.fused = steps_per_launch > 1 and ts.supports_multi_step(cfg)
        self.steps_per_launch = steps_per_launch if self.fused else 1
        self.cfg = cfg
        self.hooks = hooks or TrainHooks()
        # the training flight recorder: per-launch phase records,
        # launch-gap accounting and the MFU-gap waterfall; only the fused
        # path stamps it, so single-step drivers carry a dormant recorder
        self.recorder: Optional[TrainRecorder] = TrainRecorder(sinks=sinks)
        self._fpt_cache: Dict[int, float] = {}
        self._single = ts.make_train_step(cfg, optimizer, loss_fn,
                                          self.device)
        self._multi = (ts.make_multi_step(cfg, optimizer,
                                          self.steps_per_launch, loss_fn,
                                          self.device)
                       if self.fused else None)
        self.launches = 0
        self.steps = 0
        self.host_s = 0.0
        self.step_s = 0.0
        # (params, opt_state) AFTER the latest launch: what an on_launch
        # checkpoint must serialize (the step updates them in place, so
        # these are the same objects the caller passed in)
        self.state: Optional[Tuple[Any, Any]] = None

    # ---- introspection ------------------------------------------------------
    def compile_count(self) -> int:
        """Distinct batch signatures (leaf shapes and dtypes) the ACTIVE
        program has run: eager PyTorch compiles nothing, and this stands
        in for the size of JAX's jit cache (1 once warm, for a steady
        feed)."""
        fn = self._multi if self._multi is not None else self._single
        return len(fn._signatures)

    def host_overhead_ratio(self) -> float:
        total = self.host_s + self.step_s
        return (self.host_s / total) if total > 0 else 0.0

    def reset_attribution(self) -> None:
        """Zero the host/step wall accounting (call after warmup so the
        reported ratio describes the steady state, not the first calls).
        Launch/step counters are left alone: callers diff those."""
        self.host_s = 0.0
        self.step_s = 0.0

    def report(self) -> Dict[str, Any]:
        """Loop-side attribution (the ``rt_train_*`` series, as a dict)."""
        return {
            "steps": self.steps,
            "launches": self.launches,
            "steps_per_launch": self.steps_per_launch,
            "host_s": round(self.host_s, 4),
            "step_s": round(self.step_s, 4),
            "host_overhead_ratio": round(self.host_overhead_ratio(), 4),
        }

    # ---- batch plumbing -----------------------------------------------------
    def _place(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's leaves on the driver's device (a no-op for leaves
        already there, as the device feed's)."""
        return ts._to_device(batch, self.device)

    @staticmethod
    def _stack(batches: List[Dict[str, Any]]) -> Dict[str, Any]:
        """K per-step batches into one [K, B, ...] batch, on the host
        for numpy leaves."""
        return {k: (np.stack([b[k] for b in batches])
                    if isinstance(batches[0][k], np.ndarray)
                    else torch.stack([torch.as_tensor(b[k])
                                      for b in batches]))
                for k in batches[0]}

    @staticmethod
    def _lead(batch: Dict[str, Any]) -> int:
        leaves = list(batch.values())
        return leaves[0].shape[0] if leaves else 0

    def _launch_meta(self, batch: Dict[str, Any]
                     ) -> Tuple[int, int, Tuple[int, ...]]:
        """(tokens, seq, lead-leaf shape) of a stacked batch: the
        recorder's FLOPs join reads these (shapes only, no device
        sync)."""
        leaves = list(batch.values())
        shape = tuple(int(d) for d in leaves[0].shape) if leaves else ()
        tokens, seq = ts._batch_tokens(batch, stacked=True)
        return tokens, seq, shape

    def _launch_flops(self, tokens: int, seq: int) -> float:
        """Analytic FLOPs for one fused launch via ``util/flops.py``,
        per-token cost cached per seq length (custom-loss configs without
        transformer geometry record launches without an MFU join)."""
        if tokens <= 0:
            return 0.0
        fpt = self._fpt_cache.get(seq)
        if fpt is None:
            try:
                fpt = float(F.train_flops_per_token(self.cfg, seq))
            except Exception:  # noqa: BLE001 — non-transformer cfg
                fpt = 0.0
            self._fpt_cache[seq] = fpt
        return tokens * fpt

    # ---- the loop -----------------------------------------------------------
    def run(self, params: Any, opt_state: Any, batches: Iterable[Any],
            on_launch: Optional[Callable[[Dict[str, Any]], None]] = None,
            stacked: Optional[bool] = None
            ) -> Tuple[Any, Any, Optional[Dict[str, Any]]]:
        """Drive the whole iterator; returns (params, opt_state, metrics of
        the last launch; leaves stay on the device, each fused metrics
        leaf a [k] per-step tensor). ``on_launch`` fires once per launch
        with those metrics; its wall is booked as host time (host tax).
        ``stacked`` overrides the pre-stacked autodetection
        (``batches.stack``) for wrappers that lose the attribute."""
        prestacked = (getattr(batches, "stack", 1) > 1 if stacked is None
                      else stacked)
        K = self.steps_per_launch
        adv = getattr(batches, "stack", None)
        if prestacked and self.fused and adv is not None and adv != K:
            raise ValueError(
                f"iterator stacks {adv} batches per group but the driver "
                f"fuses {K} steps per launch — every group would silently "
                f"degrade to single-step; use iter_device_batches("
                f"stack={K})")
        last_metrics: Optional[Dict[str, Any]] = None
        pend: List[Dict[str, Any]] = []
        it = iter(batches)
        rec = self.recorder if (self.recorder is not None
                                and self.recorder.enabled
                                and self.fused) else None
        rec_data_s = 0.0  # data_wait accumulated toward the pending launch
        rec_t0: Optional[float] = None  # epoch start of its wall
        while True:
            if rec is not None and rec_t0 is None:
                rec_t0 = time.time()
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                batch = None
            if rec is not None and batch is not None:
                rec_data_s += time.perf_counter() - t0
            if batch is not None and not prestacked and K > 1:
                pend.append(batch)
                if len(pend) < K:
                    self.host_s += time.perf_counter() - t0
                    continue
                t_stack = time.perf_counter()
                batch, pend = self._stack(pend), []
                if rec is not None:
                    # the K-batch stack is the loader's wall too
                    rec_data_s += time.perf_counter() - t_stack
                stacked = True
            elif batch is not None:
                stacked = prestacked and self._lead(batch) >= 1
            if batch is None:
                # ragged tail of a self-stacked run: fewer than K batches
                # left — single-step them
                tail, pend = pend, []
                for b in tail:
                    params, opt_state, last_metrics = self._run_single(
                        params, opt_state, b, t_host0=t0, on_launch=on_launch)
                    t0 = time.perf_counter()
                self.host_s += time.perf_counter() - t0
                break
            if stacked and self._lead(batch) == K and self._multi is not None:
                if rec is not None:
                    data_ready_t = time.time()  # stacked batch in hand
                    tokens, seq_len, shape = self._launch_meta(batch)
                t_h2d = time.perf_counter()
                placed = self._place(batch)
                h2d_s = time.perf_counter() - t_h2d
                self.host_s += time.perf_counter() - t0
                n_exec = self.compile_count() if rec is not None else 0
                t1 = time.perf_counter()
                params, opt_state, metrics = self._multi(
                    params, opt_state, placed)
                dispatch_s = time.perf_counter() - t1
                t_disp_end = time.time() if rec is not None else 0.0
                self.step_s += dispatch_s
                self.launches += 1
                self.steps += K
                self._observe(K)
                last_metrics = metrics
                self.state = (params, opt_state)
                seq = 0
                if rec is not None:
                    # a call with a new batch signature is the program's
                    # first under it (the build, cuBLAS setup and
                    # allocator growth): book it as compile, not dispatch
                    # (step-profiler convention, so the two can't drift)
                    compiled = self.compile_count() > n_exec
                    seq = rec.record_launch(
                        t_start=rec_t0, data_wait_s=rec_data_s,
                        h2d_s=h2d_s,
                        dispatch_s=0.0 if compiled else dispatch_s,
                        compile_s=dispatch_s if compiled else 0.0,
                        data_ready_t=data_ready_t,
                        t_dispatch_end=t_disp_end, k=K, tokens=tokens,
                        batch_shape=shape,
                        flops=self._launch_flops(tokens, seq_len))
                    # async done-hook: a CUDA event after the launch,
                    # waited for by the recorder's watcher thread
                    rec.watch_outputs(seq, metrics)
                    rec_data_s, rec_t0 = 0.0, None
                if on_launch is not None:
                    # callback work (report handoff, checkpoint snapshot
                    # dispatch) is host-side loop time — attribute it
                    tc = time.perf_counter()
                    on_launch(metrics)
                    tax = time.perf_counter() - tc
                    self.host_s += tax
                    if rec is not None and seq:
                        rec.add_host_tax(seq, tax)
            elif stacked:
                # pre-stacked ragged tail (k < K, or any stacked input
                # once the driver degraded to K=1) — slice and single-step
                rec_data_s, rec_t0 = 0.0, None
                k = self._lead(batch)
                if self.fused and k > K:
                    # a tail group is always SMALLER than K; a bigger one
                    # means the feed stacks more than the driver fuses and
                    # launch amortization would silently turn off — refuse
                    raise ValueError(
                        f"stacked group of {k} batches exceeds "
                        f"steps_per_launch {K}: the feed's stacking does "
                        f"not match the driver's fusion factor")
                self.host_s += time.perf_counter() - t0
                for i in range(k):
                    b = {key: v[i] for key, v in batch.items()}
                    params, opt_state, last_metrics = self._run_single(
                        params, opt_state, b, on_launch=on_launch)
            else:
                rec_data_s, rec_t0 = 0.0, None
                params, opt_state, last_metrics = self._run_single(
                    params, opt_state, batch, t_host0=t0,
                    on_launch=on_launch)
        self.hooks.metric(SERIES["host_overhead"], "set",
                          self.host_overhead_ratio())
        return params, opt_state, last_metrics

    def _run_single(self, params, opt_state, batch, *, t_host0=None,
                    on_launch=None):
        t0 = t_host0 if t_host0 is not None else time.perf_counter()
        placed = self._place(batch)
        self.host_s += time.perf_counter() - t0
        t1 = time.perf_counter()
        params, opt_state, metrics = self._single(params, opt_state, placed)
        self.step_s += time.perf_counter() - t1
        self.launches += 1
        self.steps += 1
        self._observe(1)
        self.state = (params, opt_state)
        if on_launch is not None:
            tc = time.perf_counter()
            on_launch(metrics)
            self.host_s += time.perf_counter() - tc
        return params, opt_state, metrics

    def _observe(self, k: int) -> None:
        try:
            self.hooks.metric(SERIES["steps_per_launch"], "observe",
                              float(k))
            if self.launches % 8 == 0:
                self.hooks.metric(SERIES["host_overhead"], "set",
                                  self.host_overhead_ratio())
        except Exception:  # noqa: BLE001 — telemetry must not fail the step
            pass
