"""RLHF over the Llama family (port of ``ray_tpu/rl/rlhf``): the reward
model and sequence-logprob utilities the roles share (``models``), and
``pipeline.RLHFPipeline``, which places the policy learner, reference,
reward model and generation engine as role actors of a ``RoleGroup``
(or, without the port's runtime, as objects in one process) and
interleaves generate, score, update and weight sync.
"""

from ray_tpu_torch.rl.rlhf.models import (  # noqa: F401
    init_reward_params,
    reward_score,
    sequence_logprobs,
)
from ray_tpu_torch.rl.rlhf.pipeline import (  # noqa: F401
    RLHFConfig,
    RLHFPipeline,
)
