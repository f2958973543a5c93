"""Collective groups and weight shipments (port of
``ray_tpu/collective/``): ``bootstrap_torch_distributed`` joins the
default process group, and the group API (``init_collective_group``,
``allreduce``, ...) runs named subgroups of it, or groups declared on the
port's runtime (``create_collective_group``) whose members are runtime
actors. ``ship_params`` / ``fetch_params`` move a params tree between two
processes over the cluster runtime's stream plane. A gang started by the
port's runtime meets through its GCS key-value store. The mesh helpers
(``pg_slice_assignments``, ``mesh_for_slice_group``) are not ported yet
(ROADMAP item R4)."""

from ray_tpu_torch.collective.collective import (  # noqa: F401
    allgather,
    allreduce,
    barrier,
    broadcast,
    cancel_shipment,
    create_collective_group,
    destroy_collective_group,
    fetch_params,
    group_stats,
    init_collective_group,
    recv,
    reducescatter,
    send,
    ship_params,
    shipment_receipt,
)
from ray_tpu_torch.collective.rendezvous import (  # noqa: F401
    bootstrap_torch_distributed,
    clear_rendezvous,
)
