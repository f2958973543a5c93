"""The gang of training worker actors.

Reference analog: ``WorkerGroup`` (``train/_internal/worker_group.py:101``)
of ``RayTrainWorker`` actors + the gang placement logic of
``BackendExecutor._create_placement_group`` (``backend_executor.py:166``).
Workers are placed one-per-bundle in a placement group shaped by the
ScalingConfig (a slice group for GPU gangs). Port of
``ray_tpu/train/worker_group.py``: a GPU gang that no node of the cluster
can hold raises at once, where JAX's waits out the placement group's
timeout (its raylets queue infeasible work for an autoscaler); it never
runs on the CPU instead.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import TrainContext, TrainSession
from ray_tpu_torch.util.placement_group import (
    PlacementGroupSchedulingStrategy,
    placement_group,
    remove_placement_group,
    slice_group,
)


class TrainWorker:
    """Actor hosting one rank of the training gang."""

    def __init__(self, rank: int, world_size: int, experiment_name: str):
        self.rank = rank
        self.world_size = world_size
        self.experiment_name = experiment_name
        self.session: Optional[TrainSession] = None
        self._thread: Optional[threading.Thread] = None

    def ping(self) -> int:
        return self.rank

    def bootstrap_torch_distributed(self, group_name: str,
                                    backend_name: str) -> None:
        from ray_tpu_torch.collective.rendezvous import bootstrap_torch_distributed

        bootstrap_torch_distributed(self.world_size, self.rank, group_name,
                                    backend_name)

    def start(self, train_fn: Callable, config: Dict[str, Any],
              checkpoint: Optional[Checkpoint],
              dataset_shards: Optional[Dict[str, Any]],
              fast_path=None) -> None:
        ctx = TrainContext(self.rank, self.world_size,
                           experiment_name=self.experiment_name)
        self.session = TrainSession(ctx, checkpoint=checkpoint,
                                    dataset_shards=dataset_shards,
                                    fast_path=fast_path)
        session_mod.init_session(self.session)

        def run():
            try:
                if _takes_config(train_fn):
                    train_fn(config)
                else:
                    train_fn()
                self.session.finish()
            except BaseException as e:  # noqa: BLE001
                traceback.print_exc()
                self.session.finish(error=e)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"rt-train-rank{self.rank}")
        self._thread.start()

    def next_result(self) -> Dict[str, Any]:
        """Blocks until the worker reports, finishes, or errors."""
        item = self.session.results.get()
        if item["type"] == "error":
            err = item["error"]
            return {"type": "error", "message": repr(err),
                    "traceback": "".join(traceback.format_exception(
                        type(err), err, err.__traceback__))}
        return item

    def shutdown(self) -> None:
        session_mod.clear_session()


def _takes_config(fn: Callable) -> bool:
    import inspect

    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return True


class RoleGroup:
    """A heterogeneous gang: one NAMED role actor per placement-group
    bundle (the RLHF shape: policy learner / reference / reward /
    generation engine placed together, reference arxiv 2312.11819's
    adaptive placement).

    Unlike :class:`WorkerGroup` (N identical ranks running one train
    fn), each role brings its own actor class, resources and ctor args.
    The group reserves ONE placement group shaped by the roles' bundles,
    so the whole pipeline lands atomically (or not at all), and
    ``describe()`` reports which bundle each role occupies — the
    placement story ``rt trace`` shows when the creating driver runs
    under a span (`RLHFPipeline` enables tracing around ``start()`` so
    every ``<Role>.__init__`` + readiness ping becomes a span).

    A role's bundle may hold a GPU share beside its CPUs (``num_gpus``:
    a fraction shares a card, whole GPUs pin the role's worker to its
    cards through ``CUDA_VISIBLE_DEVICES``). ``start`` creates every role
    before it pings any, so cold workers start together.
    """

    def __init__(self, name: str, strategy: str = "PACK"):
        self.name = name
        self.strategy = strategy
        self.pg = None
        self.actors: Dict[str, Any] = {}
        self._roles: List[Dict[str, Any]] = []

    def add_role(self, role: str, actor_cls: type, *args,
                 num_cpus: float = 1, num_gpus: float = 0,
                 options: Optional[Dict] = None,
                 **kwargs) -> "RoleGroup":
        """Declare one role (call before ``start``); chainable."""
        if any(r["role"] == role for r in self._roles):
            raise ValueError(f"duplicate role {role!r}")
        self._roles.append({"role": role, "cls": actor_cls, "args": args,
                            "kwargs": kwargs, "num_cpus": num_cpus,
                            "num_gpus": num_gpus,
                            "options": dict(options or {})})
        return self

    @staticmethod
    def _bundle(r: Dict[str, Any]) -> Dict[str, float]:
        b = {"CPU": r["num_cpus"]}
        if r["num_gpus"]:
            b["GPU"] = r["num_gpus"]
        return b

    def start(self, timeout: float = 300) -> None:
        if not self._roles:
            raise ValueError("no roles declared")
        bundles = [self._bundle(r) for r in self._roles]
        self.pg = placement_group(bundles, strategy=self.strategy,
                                  name=self.name)
        if not self.pg.wait(timeout=timeout):
            remove_placement_group(self.pg)
            self.pg = None
            raise TimeoutError(
                f"role group {self.name!r}: could not reserve {bundles}")
        try:
            for i, r in enumerate(self._roles):
                opts = dict(r["options"])
                opts.setdefault("num_cpus", r["num_cpus"])
                if r["num_gpus"]:
                    opts.setdefault("num_gpus", r["num_gpus"])
                opts["scheduling_strategy"] = \
                    PlacementGroupSchedulingStrategy(self.pg, i)
                handle = ray_tpu_torch.remote(r["cls"]).options(**opts).remote(
                    *r["args"], **r["kwargs"])
                self.actors[r["role"]] = handle
            # readiness barrier: every role constructed (and its span
            # recorded) before the pipeline starts issuing phases
            ray_tpu_torch.get([a.ping.remote() for a in self.actors.values()],
                        timeout=timeout)
        except BaseException:
            self.shutdown()
            raise

    def __getitem__(self, role: str):
        return self.actors[role]

    def describe(self) -> List[Dict[str, Any]]:
        """role -> bundle placement (the `rt trace` companion table)."""
        return [{"role": r["role"], "bundle_index": i,
                 "num_cpus": r["num_cpus"], "num_gpus": r["num_gpus"],
                 "actor": type(r["cls"]).__name__
                 if not isinstance(r["cls"], type) else r["cls"].__name__}
                for i, r in enumerate(self._roles)]

    def shutdown(self) -> None:
        for handle in self.actors.values():
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self.actors = {}
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            self.pg = None


class WorkerGroup:
    def __init__(self, scaling: ScalingConfig, experiment_name: str):
        self.scaling = scaling
        self.experiment_name = experiment_name
        self.pg = None
        self.workers: List = []

    def _check_feasible(self) -> None:
        """Raise now when no alive node could ever hold one worker's GPUs."""
        need = self.scaling.gpus_per_worker
        if not need:
            return
        nodes = [nd for nd in ray_tpu_torch.nodes() if nd.get("alive", True)]
        most = max((nd.get("resources", {}).get("GPU", 0)
                    for nd in nodes), default=0)
        if most < need:
            raise RuntimeError(
                f"the gang needs {need} GPU(s) per worker and the largest "
                f"node of the cluster has {most:g}; a GPU worker is never "
                f"run on the CPU (pass ScalingConfig(gpus_per_worker=0) "
                f"for a CPU gang)")

    def start(self) -> None:
        n = self.scaling.num_workers
        self._check_feasible()
        if self.scaling.use_gpu and not self.scaling.resources_per_worker:
            # GPU gang: the slice PG shape (slice_group — one bundle per
            # host, GPUs pinned per bundle). A one-host gang packs; a
            # multi-host gang takes the ScalingConfig's strategy.
            self.pg = slice_group(
                num_hosts=n,
                gpus_per_host=self.scaling.gpus_per_worker,
                cpus_per_host=self.scaling.cpus_per_worker,
                strategy=(self.scaling.placement_strategy if n > 1
                          else "PACK"),
                name=self.experiment_name)
        else:
            self.pg = placement_group(
                [self.scaling.bundle() for _ in range(n)],
                strategy=self.scaling.placement_strategy)
        if not self.pg.wait(timeout=300):
            remove_placement_group(self.pg)
            raise TimeoutError(
                f"could not reserve {n} x {self.scaling.bundle()} "
                f"(placement group timed out)")
        try:
            actor_cls = ray_tpu_torch.remote(TrainWorker)
            bundle = self.scaling.bundle()
            self.workers = [
                actor_cls.options(
                    num_cpus=bundle.get("CPU", 1),
                    num_gpus=bundle.get("GPU", 0) or None,
                    scheduling_strategy=PlacementGroupSchedulingStrategy(self.pg, i),
                ).remote(i, n, self.experiment_name)
                for i in range(n)
            ]
            ray_tpu_torch.get([w.ping.remote() for w in self.workers], timeout=300)
        except BaseException:
            # Don't leak the gang's reservation on a failed start.
            self.shutdown()
            raise

    def run_async(self, method: str, *args) -> List:
        return [getattr(w, method).remote(*args) for w in self.workers]

    def run(self, method: str, *args, timeout: Optional[float] = None) -> List:
        return ray_tpu_torch.get(self.run_async(method, *args), timeout=timeout)

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
        self.workers = []
        self.pg = None
