"""The per-worker training session.

Reference analog: ``_TrainSession`` (``train/_internal/session.py:132`` —
``report :612/:844``, ``get_checkpoint :902``, ``get_dataset_shard :1208``).
``report`` enqueues (metrics, checkpoint) into a bounded queue the driver
drains — backpressure keeps a fast training loop from outrunning a slow
driver, the same contract as the reference's result queue
(``trainable/function_trainable.py:199-264``).

Off-step-path reporting (ROADMAP item 2): the step loop's ``report`` call
only hands the metrics dict to a dedicated **drainer thread**; metric
coercion to host scalars (the device→host sync a live device tensor
forces) and the checkpoint completion fence happen on that thread, so the
fused-K launch loop never blocks behind a ``device_get`` or a slow
serialization. ``FastPathConfig.async_report=False`` restores the
synchronous path (the bench A/B's control leg).

Port of ``ray_tpu/train/session.py``: a reported torch tensor (a loss on
the card, a bf16 norm) is read on the drainer with ``.detach().cpu()``,
bfloat16 and float16 widened to float32 first (numpy has no bfloat16),
so the step loop never waits on the copy.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import FastPathConfig


def _to_host(value: Any) -> Any:
    """Coerce one metric leaf to a host value: tensors and arrays become
    python scalars (size 1) or host ndarrays, everything else passes
    through. torch is looked up, never imported: a tensor's module is
    loaded already."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        t = value.detach().cpu()  # the one device->host sync, on the drainer
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        value = t.numpy()
    if hasattr(value, "__array__") and not isinstance(value, (str, bytes)):
        import numpy as np

        arr = np.asarray(value)  # the one device->host sync, on the drainer
        if arr.size == 1:
            return arr.reshape(()).item()
        return arr
    return value


def coerce_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Host-scalar coercion for a reported metrics dict (drainer-side)."""
    return {k: _to_host(v) for k, v in metrics.items()}


class TrainContext:
    def __init__(self, world_rank: int, world_size: int,
                 local_rank: int = 0, node_rank: int = 0,
                 experiment_name: str = ""):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.node_rank = node_rank
        self.experiment_name = experiment_name

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank


class TrainSession:
    def __init__(self, context: TrainContext,
                 checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 queue_size: int = 2,
                 fast_path: Optional[FastPathConfig] = None):
        self.context = context
        self.loaded_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        self.fast_path = fast_path or FastPathConfig()
        self.results: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        # report handoff lane: the step loop appends, the drainer coerces/
        # fences and forwards into `results`. Bounded so a wedged driver
        # still backpressures eventually, but deep enough that a slow
        # checkpoint never stalls the loop mid-launch.
        self._handoff: "queue.Queue" = queue.Queue(maxsize=64)
        self._drainer: Optional[threading.Thread] = None
        self._drainer_lock = threading.Lock()

    # ---- the drainer thread -------------------------------------------------
    def _ensure_drainer(self) -> None:
        with self._drainer_lock:
            if self._drainer is None or not self._drainer.is_alive():
                self._drainer = threading.Thread(
                    target=self._drain_loop, daemon=True,
                    name=f"rt-train-report-drain-r{self.context.world_rank}")
                self._drainer.start()

    def _drain_loop(self) -> None:
        while True:
            item = self._handoff.get()
            if item is None:  # finish() sentinel follows the final put
                return
            try:
                if item["type"] == "report":
                    item["metrics"] = coerce_metrics(item["metrics"])
                    ckpt = item.get("checkpoint")
                    if ckpt is not None and hasattr(ckpt, "wait_pending"):
                        # the ack fence: an async save must complete before
                        # the report (and thus CheckpointManager) sees it
                        ckpt.wait_pending()
            except Exception as e:  # noqa: BLE001 — surfaced as an error
                item = {"type": "error", "error": e}  # round to the driver
                self.error = e
            self.results.put(item)
            if item["type"] != "report":
                return  # done/error terminates the drainer

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        """Hand one (metrics, checkpoint) round to the driver.

        Contract: the dict is shallow-copied at the call site (free — no
        device sync) and its leaves are coerced to host scalars on the
        session's drainer thread, so live device tensors are fine
        (the device→host sync happens off the step path) and the caller
        may reuse the dict object; the reported leaf VALUES must not be
        mutated in place. With ``async_report=False`` (FastPathConfig) coercion
        and the checkpoint fence run synchronously on the calling thread.
        Backpressure: the handoff lane is bounded (64 rounds) on the async
        path, the results queue (2 rounds) on the sync path.
        """
        if not self.fast_path.async_report:
            metrics = coerce_metrics(metrics)
            if checkpoint is not None and hasattr(checkpoint, "wait_pending"):
                checkpoint.wait_pending()
            self.results.put({"type": "report", "metrics": metrics,
                              "checkpoint": checkpoint})
            return
        self._ensure_drainer()
        # shallow copy: free (no device sync — the array leaves are shared,
        # not read), and a caller reusing one metrics dict across steps
        # keeps the old contract; leaf VALUES are still coerced lazily on
        # the drainer
        self._handoff.put({"type": "report", "metrics": dict(metrics),
                           "checkpoint": checkpoint})

    def finish(self, error: Optional[BaseException] = None) -> None:
        self.error = error
        self.finished.set()
        item = {"type": "error", "error": error} if error else {"type": "done"}
        if self.fast_path.async_report and self._drainer is not None \
                and self._drainer.is_alive():
            # ride the handoff lane so every earlier report drains first
            self._handoff.put(item)
            self._handoff.put(None)
        else:
            self.results.put(item)


_session_lock = threading.Lock()
_session: Optional[TrainSession] = None


def init_session(session: TrainSession) -> None:
    global _session
    with _session_lock:
        _session = session


def clear_session() -> None:
    global _session
    with _session_lock:
        _session = None


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "No train session: this API must be called inside a "
            "train_loop_per_worker launched by a Trainer")
    return _session


# ---- public per-worker API -------------------------------------------------

def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None) -> None:
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().loaded_checkpoint


def get_context() -> TrainContext:
    return get_session().context


def get_fast_path() -> FastPathConfig:
    """The trainer-configured fast-path knobs (steps_per_launch etc.) for
    this worker; a default config outside a session."""
    if _session is None:
        return FastPathConfig()
    return _session.fast_path


def get_dataset_shard(name: str = "train"):
    shard = get_session().dataset_shards.get(name)
    if shard is None:
        raise KeyError(f"no dataset shard named {name!r}")
    return shard
