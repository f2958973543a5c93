"""TorchTrainer: the data-parallel trainer driving a gang of torch workers.

Reference analog: ``DataParallelTrainer`` (``train/data_parallel_trainer.py:59``)
+ ``BackendExecutor`` (``_internal/backend_executor.py:46``): create the gang
in a placement group, bootstrap the collective backend, run the user loop on
every rank, drain reported (metrics, checkpoint) rounds, restart the gang
from the last checkpoint on failure (``FailureConfig.max_failures`` —
elastic-restart, like the reference).

Port of ``ray_tpu/train/trainer.py``: the port's ``TorchTrainer`` is the
twin of JAX's ``JaxTrainer`` (the same fit loop, drain and restarts) and,
with ``ScalingConfig(gpus_per_worker=0)``, of JAX's gloo ``TorchTrainer``.
A gang of more than one worker joins one torch process group
(``train/torch/config.py:64``) through the GCS-KV rendezvous: NCCL for
GPU workers, gloo for CPU ones.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.config import session_root_default
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup



class TrainingFailedError(RuntimeError):
    pass


class Result:
    def __init__(self, metrics: Optional[Dict], checkpoint: Optional[Checkpoint],
                 path: str, error: Optional[str] = None,
                 metrics_history: Optional[List[Dict]] = None):
        self.metrics = metrics
        self.checkpoint = checkpoint
        self.path = path
        self.error = error
        self.metrics_history = metrics_history or []

    def __repr__(self):
        return (f"Result(metrics={self.metrics}, checkpoint={self.checkpoint}, "
                f"error={self.error})")


class TorchTrainer:
    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 use_torch_distributed: bool = True,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.train_fn = train_loop_per_worker
        self.train_config = train_loop_config or {}
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.use_torch_distributed = use_torch_distributed
        self.resume_checkpoint = resume_from_checkpoint

    @property
    def _dist_bootstrap(self):
        return ("bootstrap_torch_distributed" if self.use_torch_distributed
                else None)

    # -- dataset sharding -----------------------------------------------------
    def _shard_datasets(self, rank: int, world: int) -> Dict[str, Any]:
        shards = {}
        datasets = getattr(self, "_attempt_datasets", None) or self.datasets
        for name, ds in datasets.items():
            split = getattr(ds, "streaming_split", None)
            if split is not None:
                shards[name] = ds.streaming_split(world)[rank]
            elif isinstance(ds, (list, tuple)):
                shards[name] = list(ds[rank::world])
            else:
                shards[name] = ds  # caller shards by rank inside the loop
        return shards

    # -- the fit loop ---------------------------------------------------------
    def fit(self) -> Result:
        name = self.run_config.name or f"TorchTrainer_{uuid.uuid4().hex[:8]}"
        storage = (self.run_config.storage_path
                   or session_root_default("ray_tpu_torch_results"))
        run_dir = os.path.join(storage, name)
        os.makedirs(run_dir, exist_ok=True)
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager(
            run_dir, num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order)

        failures_left = self.run_config.failure_config.max_failures
        latest_checkpoint = self.resume_checkpoint
        metrics_history: List[Dict] = []
        last_error: Optional[str] = None

        while True:
            # per-attempt dataset copies: a retry after worker death must
            # re-execute the dataset (fresh coordinator), and concurrent
            # trials sharing one Dataset object (Train-on-Tune, local
            # backend) must not see each other's split caches — Dataset's
            # __getstate__ scrubs the cache, so copy() isolates it
            import copy as _copy

            self._attempt_datasets = {
                name: (_copy.copy(ds)
                       if hasattr(ds, "reset_streaming_split") else ds)
                for name, ds in self.datasets.items()}
            group = WorkerGroup(self.scaling, name)
            group.start()
            try:
                if self._dist_bootstrap and self.scaling.num_workers > 1:
                    group.run(self._dist_bootstrap,
                              f"{name}:{uuid.uuid4().hex[:6]}",
                              self.scaling.backend, timeout=300)
                n = self.scaling.num_workers
                ray_tpu_torch.get([
                    w.start.remote(self.train_fn, self.train_config,
                                   latest_checkpoint,
                                   self._shard_datasets(i, n),
                                   self.run_config.fast_path)
                    for i, w in enumerate(group.workers)], timeout=300)
                error = self._drain_results(group, manager, metrics_history)
                if error is None:
                    final = metrics_history[-1] if metrics_history else None
                    return Result(final, manager.best_checkpoint
                                  or manager.latest_checkpoint,
                                  run_dir, None, metrics_history)
                last_error = error
                if failures_left == 0:
                    raise TrainingFailedError(
                        f"training failed (no restart budget left): {error}")
                failures_left -= 1
                self._emit_gang_restart(
                    name, error,
                    self.run_config.failure_config.max_failures
                    - failures_left)
                latest_checkpoint = manager.latest_checkpoint or latest_checkpoint
            finally:
                group.shutdown()

    @staticmethod
    def _emit_gang_restart(name: str, error: str, restart_num: int) -> None:
        """Stamp a FailureConfig-driven gang restart into the failure
        plane: a FailureEvent on the feed (visible in `rt errors` /
        `rt doctor`) plus a `rt_actor_restarts_total` tick, so train-level
        recovery is observable like every other restart. Best-effort —
        recovery must not fail on telemetry."""
        try:
            from ray_tpu_torch.core import failure as F
            from ray_tpu_torch.core.worker import global_worker

            backend = global_worker().backend
            if backend is not None and hasattr(backend, "_gcs"):
                err = ((error or "").strip().splitlines() or [""])[0][:300]
                category = (F.WORKER_CRASH if "died" in err
                            else F.TASK_ERROR)
                F.emit(backend.io.spawn, backend._gcs, category,
                       f"TorchTrainer gang restart {restart_num} "
                       f"(from last checkpoint): {err}",
                       name="TorchTrainer", experiment=name,
                       restarting=True, gang_restart=True)
            from ray_tpu_torch.util import metrics as M

            M.get_or_create(
                M.Counter, "rt_actor_restarts_total",
                "Actor restarts scheduled by the GCS after a failure").inc()
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def _drain_results(self, group: WorkerGroup, manager: CheckpointManager,
                       history: List[Dict]) -> Optional[str]:
        """Drain symmetric report rounds; returns error string on failure."""
        active = list(group.workers)
        while active:
            try:
                round_results = ray_tpu_torch.get(
                    [w.next_result.remote() for w in active])
            except Exception as e:  # actor died (worker process crash)
                return f"worker died: {e!r}"
            errors = [r for r in round_results if r["type"] == "error"]
            if errors:
                return errors[0].get("message", "unknown") + "\n" + \
                    errors[0].get("traceback", "")
            reports = [(w, r) for w, r in zip(active, round_results)
                       if r["type"] == "report"]
            if reports:
                rank0_report = reports[0][1]
                metrics = dict(rank0_report["metrics"])
                ckpt = rank0_report.get("checkpoint")
                if ckpt is not None:
                    saved = manager.register(ckpt, metrics)
                    metrics["checkpoint_path"] = saved.path
                metrics["_round"] = len(history)
                metrics["_timestamp"] = time.time()
                history.append(metrics)
            active = [w for w, r in zip(active, round_results)
                      if r["type"] == "report"]
        return None

