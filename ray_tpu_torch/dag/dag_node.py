"""DAG node types and the recursive executor.

Reference parity: ``python/ray/dag/dag_node.py`` (``DAGNode``),
``function_node.py``, ``class_node.py``, ``input_node.py``. Nodes capture a
remote call without submitting it; ``execute()`` walks the graph bottom-up,
submitting each node once and passing ObjectRefs downstream so the cluster
scheduler sees the whole graph's parallelism.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """A lazily-evaluated node in a task/actor graph."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs)

    # -- graph traversal -----------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out: List[DAGNode] = []

        def scan(v):
            if isinstance(v, DAGNode):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    scan(x)
            elif isinstance(v, dict):
                for x in v.values():
                    scan(x)

        for a in self._bound_args:
            scan(a)
        for a in self._bound_kwargs.values():
            scan(a)
        return out

    def execute(self, *input_args, **input_kwargs):
        """Execute the whole DAG rooted at this node; returns the root's
        ObjectRef (or actor handle for a ClassNode root)."""
        cache: Dict[int, Any] = {}
        input_val = _InputValue(input_args, input_kwargs)
        return self._execute_node(cache, input_val)

    def _execute_node(self, cache: Dict[int, Any], input_val: "_InputValue"):
        key = id(self)
        if key not in cache:
            cache[key] = self._execute_impl(
                _resolve(self._bound_args, cache, input_val),
                _resolve(self._bound_kwargs, cache, input_val),
                input_val,
            )
        return cache[key]

    def _execute_impl(self, args, kwargs, input_val):
        raise NotImplementedError

    # -- introspection -------------------------------------------------------
    def get_all_nodes(self) -> List["DAGNode"]:
        seen: Dict[int, DAGNode] = {}

        def walk(n: DAGNode):
            if id(n) in seen:
                return
            seen[id(n)] = n
            for c in n._children():
                walk(c)

        walk(self)
        return list(seen.values())


class _InputValue:
    def __init__(self, args: Tuple, kwargs: Dict):
        self.args = args
        self.kwargs = kwargs

    def primary(self):
        if self.kwargs or len(self.args) > 1:
            raise ValueError(
                "DAG has a bare InputNode but execute() got multiple inputs; "
                "use InputNode attribute/index access in the DAG instead")
        return self.args[0] if self.args else None


def _resolve(value, cache, input_val):
    if isinstance(value, DAGNode):
        return value._execute_node(cache, input_val)
    if isinstance(value, tuple):
        return tuple(_resolve(v, cache, input_val) for v in value)
    if isinstance(value, list):
        return [_resolve(v, cache, input_val) for v in value]
    if isinstance(value, dict):
        return {k: _resolve(v, cache, input_val) for k, v in value.items()}
    return value


class FunctionNode(DAGNode):
    """``remote_fn.bind(...)`` — executes as ``remote_fn.remote(...)``."""

    def __init__(self, remote_fn, args, kwargs, options: Optional[Dict] = None):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn
        self._options = options or {}

    def options(self, **opts) -> "FunctionNode":
        merged = dict(self._options)
        merged.update(opts)
        return FunctionNode(self._remote_fn, self._bound_args,
                            self._bound_kwargs, merged)

    def _execute_impl(self, args, kwargs, input_val):
        fn = self._remote_fn
        if self._options:
            fn = fn.options(**self._options)
        return fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """``ActorClass.bind(...)`` — executes by creating the actor once."""

    def __init__(self, actor_cls, args, kwargs, options: Optional[Dict] = None):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._options = options or {}

    def options(self, **opts) -> "ClassNode":
        merged = dict(self._options)
        merged.update(opts)
        return ClassNode(self._actor_cls, self._bound_args,
                         self._bound_kwargs, merged)

    def __getattr__(self, name: str) -> "_BoundMethod":
        if name.startswith("_"):
            raise AttributeError(name)
        return _BoundMethod(self, name)

    def _execute_impl(self, args, kwargs, input_val):
        cls = self._actor_cls
        if self._options:
            cls = cls.options(**self._options)
        return cls.remote(*args, **kwargs)


class _BoundMethod:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name, args, kwargs)


class ClassMethodNode(DAGNode):
    """``class_node.method.bind(...)`` — actor method call on the (shared)
    actor created by the parent ClassNode. The parent may also be a live
    ActorHandle (``handle.method.bind(...)``), in which case no actor is
    created at execute time."""

    def __init__(self, class_node, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _children(self) -> List[DAGNode]:
        base = super()._children()
        if isinstance(self._class_node, DAGNode):
            return [self._class_node] + base
        return base

    def _execute_impl(self, args, kwargs, input_val):
        raise AssertionError("handled in _execute_node")

    def _execute_node(self, cache, input_val):
        key = id(self)
        if key not in cache:
            if isinstance(self._class_node, DAGNode):
                handle = self._class_node._execute_node(cache, input_val)
            else:
                handle = self._class_node  # live ActorHandle
            args = _resolve(self._bound_args, cache, input_val)
            kwargs = _resolve(self._bound_kwargs, cache, input_val)
            cache[key] = getattr(handle, self._method_name).remote(*args, **kwargs)
        return cache[key]


class InputNode(DAGNode):
    """Placeholder for the value passed to ``dag.execute(x)``.

    Context-manager form matches the reference API::

        with InputNode() as inp:
            dag = f.bind(inp)
        dag.execute(41)
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __getattr__(self, name: str) -> "InputAttributeNode":
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name, kind="attr")

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key, kind="item")

    def _execute_impl(self, args, kwargs, input_val):
        return input_val.primary()


class InputAttributeNode(DAGNode):
    """``inp.x`` / ``inp[0]`` — keyword or positional slice of execute()'s
    inputs: ``inp[i]`` is the i-th positional arg, ``inp.name`` the kwarg."""

    def __init__(self, input_node: InputNode, key, kind: str):
        super().__init__((), {})
        self._input_node = input_node
        self._key = key
        self._kind = kind

    def _children(self) -> List[DAGNode]:
        return []

    def _execute_impl(self, args, kwargs, input_val):
        if self._kind == "item":
            if isinstance(self._key, int):
                return input_val.args[self._key]
            return input_val.kwargs[self._key]
        return input_val.kwargs[self._key]
