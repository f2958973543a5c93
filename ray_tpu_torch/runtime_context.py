"""Runtime context introspection (reference: ``python/ray/runtime_context.py``)."""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.core.worker import global_worker


class RuntimeContext:
    @property
    def job_id(self):
        return global_worker().job_id

    @property
    def task_id(self):
        return global_worker().current_task_id()

    @property
    def actor_id(self):
        return global_worker().current_actor_id()

    def get_job_id(self) -> str:
        return global_worker().job_id.hex()

    def get_task_id(self) -> Optional[str]:
        tid = global_worker().current_task_id()
        return tid.hex() if tid else None

    def get_actor_id(self) -> Optional[str]:
        aid = global_worker().current_actor_id()
        return aid.hex() if aid else None

    def get_node_id(self) -> str:
        backend = global_worker().backend
        node_id = getattr(backend, "node_id", None)
        if node_id is not None:
            return node_id
        nodes = backend.nodes()
        return nodes[0]["node_id"] if nodes else ""

    def get_gpu_ids(self) -> List[str]:
        """The devices this worker may use (reference: ``get_gpu_ids``),
        as ``CUDA_VISIBLE_DEVICES`` lists them: set by the raylet for a
        worker that holds GPUs (the port's ``get_tpu_ids``)."""
        from ray_tpu_torch._private.accelerator import _visible_ids

        return _visible_ids() or []

    def get_assigned_resources(self) -> Dict[str, float]:
        return {}


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
