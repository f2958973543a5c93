"""One member's sequence of group-API calls, for the port's gang ranks
and for the JAX package's workers alike (``test_torch_collective.py``
ships it to them by value). Imports numpy only."""

import numpy as np


def run(col, rank: int, as_numpy) -> dict:
    """The group API's ops on rank-dependent inputs, in one program order
    for every member of the group ``"all"``. ``as_numpy`` turns an op's
    output into a numpy array."""
    x = np.arange(7.0) * (rank + 1) + 1
    out = {f"allreduce_{op}": as_numpy(col.allreduce(x, "all", op))
           for op in ("sum", "prod", "min", "max")}
    m = np.arange(14.0).reshape(7, 2) + rank
    out["reducescatter"] = as_numpy(col.reducescatter(m, "all"))
    out["reducescatter_max"] = as_numpy(col.reducescatter(m, "all", "max"))
    out["allgather"] = [as_numpy(t) for t in
                        col.allgather(np.array([rank, 2.0 * rank]), "all")]
    out["broadcast"] = as_numpy(col.broadcast(np.full(3, 10.0 * rank), 1,
                                              "all"))
    # buffered: rank 0's send returns before rank 1 posts its recv, which
    # it does only after a barrier that rank 0 reaches after sending
    if rank == 0:
        col.send(np.arange(5.0), 1, "all")
    col.barrier("all")
    if rank == 1:
        buf = np.zeros(5)
        col.recv(buf, 0, "all")
        out["recv"] = buf
    try:
        col.send(np.zeros(1), rank, "all")
    except ValueError as e:
        out["self_send"] = str(e)
    return out
