"""Collective groups over ``torch.distributed`` (port of
``ray_tpu/collective/``): ``bootstrap_torch_distributed`` joins the
default process group, and the group API (``init_collective_group``,
``allreduce``, ...) runs named subgroups of it. Weight shipping over the
cluster runtime's stream plane (``ship_params``, ``fetch_params``) is not
ported yet (ROADMAP item R4). A gang started by the port's runtime meets
through its GCS key-value store."""

from ray_tpu_torch.collective.collective import (  # noqa: F401
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    group_stats,
    init_collective_group,
    recv,
    reducescatter,
    send,
)
from ray_tpu_torch.collective.rendezvous import (  # noqa: F401
    bootstrap_torch_distributed,
    clear_rendezvous,
)
