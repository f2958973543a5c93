"""Lazy task/actor DAGs: ``fn.bind(...)`` builds a graph executed on demand.

Capability parity with the reference's ``python/ray/dag/`` (``DAGNode`` in
``dag/dag_node.py``; ``FunctionNode``/``ClassNode`` built by ``.bind()``;
``InputNode`` placeholder). Used by the serve layer for model composition and
by the workflow layer for durable execution.
"""

from ray_tpu_torch.dag.dag_node import (  # noqa: F401
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
)

__all__ = [
    "DAGNode", "FunctionNode", "ClassNode", "ClassMethodNode", "InputNode",
    "InputAttributeNode",
]
