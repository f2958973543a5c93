"""ray_tpu_torch.serve: online model serving on the port's runtime (the
twin of ``ray_tpu/serve``).

The controller/proxy/replica triad, power-of-two routing, dynamic batching
and ongoing-requests autoscaling, as in the JAX package; replicas pin whole
GPUs via ``ray_actor_options={"num_gpus": N}``, and ``@serve.batch`` keeps
the card fed with large fused batches.

    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    class Model:
        @serve.batch(max_batch_size=8)
        async def predict(self, xs): return model(stack(xs))
        async def __call__(self, request): return await self.predict(request.json())

    handle = serve.run(Model.bind())
    handle.remote(...).result()
"""

from ray_tpu_torch.serve.api import (Application, Deployment, delete,
                                     deployment, get_app_handle,
                                     get_deployment_handle, http_port, run,
                                     shutdown, start, start_grpc, status)
from ray_tpu_torch.serve.api import _forget_controller as _forget_controller_for_tests
from ray_tpu_torch.serve.asgi import (ASGIResponse, ASGIResponseStart,
                                      asgi_app, ingress)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                        HTTPOptions)
from ray_tpu_torch.serve.handle import (DeploymentHandle, DeploymentResponse,
                                        DeploymentResponseGenerator)
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.grpc_proxy import grpc_request
from ray_tpu_torch.serve.obs import get_serve_request_id
from ray_tpu_torch.serve.api import detailed_status, proxy_ports
from ray_tpu_torch.serve.proxy import ServeRequest

#: the LLM app functions, imported on first use: ``serve.llm`` imports torch
#: and the model, which a replica of any other deployment does not need
_LLM_EXPORTS = ("continuous_llm_app", "poisson_load", "static_llm_app")


def __getattr__(name):
    if name in _LLM_EXPORTS:
        from ray_tpu_torch.serve import llm

        return getattr(llm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ASGIResponse", "ASGIResponseStart",
    "Application", "AutoscalingConfig", "Deployment", "DeploymentConfig",
    "DeploymentHandle", "DeploymentResponse", "DeploymentResponseGenerator",
    "HTTPOptions", "ServeRequest",
    "asgi_app", "batch", "continuous_llm_app", "delete", "deployment",
    "detailed_status",
    "get_app_handle",
    "ingress",
    "get_deployment_handle", "get_multiplexed_model_id", "grpc_request",
    "get_serve_request_id",
    "http_port", "multiplexed", "poisson_load", "proxy_ports", "run",
    "shutdown", "start", "start_grpc", "static_llm_app",
    "status",
]
