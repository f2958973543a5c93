"""Multi-node-in-one-process test cluster.

Reference analog: ``python/ray/cluster_utils.py`` (``Cluster``, ``add_node
:168``, ``remove_node :241``) — real control planes with FAKE resource
counts, so scheduler/placement tests run anywhere: a "GPU node" here is a
raylet that claims ``num_gpus=4``; tasks scheduled to it get GPU indices
assigned without any hardware (they only matter when user code actually
touches CUDA).
"""

from __future__ import annotations

from typing import Dict, Optional

from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch.cluster.driver_backend import ClusterHandle
from ray_tpu_torch.cluster.raylet import Raylet


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict] = None,
                 gcs_persist_path: Optional[str] = None):
        self._handle = ClusterHandle()
        self._handle.start_gcs(persist_path=gcs_persist_path)
        self.head_node: Optional[Raylet] = None
        if initialize_head:
            self.head_node = self.add_node(**(head_node_args or {}))

    @property
    def gcs_address(self) -> str:
        return self._handle.gcs_address

    def add_node(self, *, num_cpus: float = 1, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None) -> Raylet:
        return self._handle.add_node(num_cpus=num_cpus, num_gpus=num_gpus,
                                     resources=resources, labels=labels)

    def remove_node(self, node: Raylet) -> None:
        self._handle.remove_node(node)

    def kill_gcs(self) -> None:
        """Chaos: crash the head (reference NodeKiller-style fault
        injection, ``_private/test_utils.py:1401``)."""
        self._handle.kill_gcs()

    def restart_gcs(self) -> str:
        return self._handle.restart_gcs()

    def connect_driver(self, namespace: Optional[str] = None):
        """Attach the global worker to this cluster as a driver."""
        import ray_tpu_torch
        from ray_tpu_torch.cluster.worker_core import ClusterBackend
        from ray_tpu_torch.core.worker import global_worker

        job_id = JobID.from_random()
        raylet = self.head_node or self._handle.raylets[0]
        backend = ClusterBackend(
            gcs_address=self.gcs_address,
            raylet_address=raylet.server.address,
            node_id=raylet.node_id,
            session_name=self._handle.session_name,
            job_id=job_id, role="driver")
        backend.connect()
        global_worker().connect(backend, job_id, "driver")
        return backend

    def shutdown(self) -> None:
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        else:
            self._handle.shutdown()
            return
        # shutdown() above tears down the backend; the handle still owns the
        # control-plane components if no driver was attached.
        try:
            self._handle.shutdown()
        except Exception:
            pass
