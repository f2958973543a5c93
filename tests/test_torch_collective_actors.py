"""The port's collective groups declared on its runtime, and its weight
shipments (``ray_tpu_torch/collective/collective.py``).

CPU, one port cluster for the module (``init(num_cpus=8, num_gpus=0)``).
``ship_params`` / ``fetch_params`` are held to JAX's contract
(``tests/test_zz_rlhf.py:174``): leaf-exact through push frames, with the
leaves above ``inline_max_bytes`` as oid frames through the object store,
and through the one-RPC fallback when chaos drops the push channel; a
spent ticket raises; ``cancel_shipment`` drops a shipment; the producer
keeps the last 32 receipts. Every oid frame is freed once the shipment
is fetched, by push or by the fallback: the store's bytes are back where
they were and no process keeps a frame mapped. Each leaf keeps its dtype (bfloat16
included). Then between two actors. The group API on a group declared on
the runtime (``_collective_ops.run``, the program the gloo gang test
runs) is held to numpy's results of JAX's semantics, by 4 member tasks on
the cluster (a gloo group of processes) and on the local backend (the
in-process plane, threads of this process).
"""

import cloudpickle
import numpy as np
import pytest
import torch

import _collective_ops
import _torch_actor_cases as cases
import ray_tpu_torch as rt
from ray_tpu_torch import collective as col
from ray_tpu_torch.cluster import stream
from ray_tpu_torch.util import chaos

WORLD = 4


@pytest.fixture(scope="module")
def cluster():
    if rt.is_initialized():
        rt.shutdown()
    cloudpickle.register_pickle_by_value(cases)
    cloudpickle.register_pickle_by_value(_collective_ops)
    rt.init(num_cpus=8, num_gpus=0)
    yield
    rt.shutdown()
    cloudpickle.unregister_pickle_by_value(cases)
    cloudpickle.unregister_pickle_by_value(_collective_ops)


def _tree():
    return {"w": torch.arange(200 * 1024, dtype=torch.float32),
            "layers": [{"b": torch.ones(17), "n": torch.tensor(7)},
                       {"h": torch.linspace(-3, 3, 40_000).to(
                           torch.bfloat16)}],
            "np": np.arange(30_000, dtype=np.int64).reshape(100, 300),
            "scalars": (1.5, torch.zeros(3, 3))}


def _assert_leaf_exact(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _assert_leaf_exact(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_leaf_exact(a, b)
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert got.device == want.device and torch.equal(got, want)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_ship_fetch_push_fallback_spent_and_cancel(cluster):
    tree = _tree()
    thresh = stream.inline_max_bytes()
    big = [t for t in (tree["w"], tree["layers"][1]["h"], tree["np"])]
    assert all(t.nbytes > thresh for t in big)
    used0, maps0 = cases.store_used_bytes(), cases.plasma_maps()
    ticket = col.ship_params(tree)
    assert ticket["n_leaves"] == 7
    assert ticket["nbytes"] == sum(
        t.nbytes for t in (tree["w"], tree["layers"][0]["b"],
                           tree["layers"][0]["n"], tree["layers"][1]["h"],
                           tree["np"], tree["scalars"][1]))
    got, info = col.fetch_params(ticket)
    _assert_leaf_exact(got, tree)
    assert info["transport"] == "push" and info["rpcs"] == 1
    assert info["oid_leaves"] == 3 and info["inline_leaves"] == 4
    assert info["nbytes"] == ticket["nbytes"] and info["fetch_wall_s"] > 0
    receipt = col.shipment_receipt(ticket["sid"])
    assert receipt["pump_done"] and receipt["frames_taken"] == 8
    assert receipt["pump_wall_s"] >= 0
    assert (cases.store_used_bytes(), cases.plasma_maps()) == (used0, maps0)

    # chaos breaks the push channel on its first take: the one reclaim
    # RPC hands over every leaf, exactly
    ticket2 = col.ship_params(tree)
    chaos.arm('{"seed": 1, "faults": [{"site": "rpc.drop", '
              '"target": "stream_push", "at": 1, "max_fires": 1}]}')
    try:
        got2, info2 = col.fetch_params(ticket2)
    finally:
        chaos.disarm()
    assert info2["transport"] == "fallback" and info2["rpcs"] == 2
    _assert_leaf_exact(got2, tree)
    # the pushed frames the consumer discarded went with the reclaim
    assert (cases.store_used_bytes(), cases.plasma_maps()) == (used0, maps0)

    # a redeemed ticket is spent; a cancelled one was never redeemable
    for spent in (ticket, ticket2):
        with pytest.raises(RuntimeError, match="unknown"):
            col.fetch_params(spent)
    ticket3 = col.ship_params(tree)
    col.cancel_shipment(ticket3)
    with pytest.raises(RuntimeError, match="unknown"):
        col.fetch_params(ticket3)

    # the receipt registry keeps the last 32
    sids = [ticket["sid"], ticket2["sid"], ticket3["sid"]]
    for _ in range(32):
        t = col.ship_params({"x": torch.ones(2)})
        col.cancel_shipment(t)
        sids.append(t["sid"])
    assert [col.shipment_receipt(s) is None for s in sids[:3]] == [True] * 3
    assert all(col.shipment_receipt(s) is not None for s in sids[-32:])


def test_ship_between_actors_push_and_drop(cluster):
    actor = rt.remote(cases.Shipper)
    producer, consumer = actor.remote(), actor.remote()
    assert rt.get(producer.pid.remote()) != rt.get(consumer.pid.remote())
    tree = _tree()
    for drop, transport in ((False, "push"), (True, "fallback")):
        ticket = rt.get(producer.ship.remote(tree))
        maps0 = rt.get(producer.maps.remote())
        got, info = rt.get(consumer.fetch.remote(ticket, drop))
        _assert_leaf_exact(got, tree)
        assert info["transport"] == transport and info["oid_leaves"] == 3
        receipt = rt.get(producer.receipt.remote(ticket["sid"]))
        assert receipt["pump_done"] and receipt["n_leaves"] == 7
        # every frame freed by the time the fetch returns: none left in
        # the store, none mapped by the consumer or the producer
        assert (info["store_delta"], info["maps_delta"]) == (0, 0)
        assert rt.get(producer.maps.remote()) == maps0
    for a in (producer, consumer):
        rt.kill(a)


def _expected(rank):
    """JAX's results of ``_collective_ops.run`` for ``rank`` of WORLD."""
    xs = [np.arange(7.0) * (r + 1) + 1 for r in range(WORLD)]
    ms = [np.arange(14.0).reshape(7, 2) + r for r in range(WORLD)]
    red = {"sum": np.sum, "prod": np.prod, "min": np.min, "max": np.max}
    out = {f"allreduce_{op}": fn(np.stack(xs), axis=0)
           for op, fn in red.items()}
    out["reducescatter"] = np.array_split(np.sum(ms, axis=0), WORLD)[rank]
    out["reducescatter_max"] = np.array_split(np.max(ms, axis=0),
                                              WORLD)[rank]
    out["allgather"] = [np.array([r, 2.0 * r]) for r in range(WORLD)]
    out["broadcast"] = np.full(3, 10.0)
    if rank == 1:
        out["recv"] = np.arange(5.0)
    out["self_send"] = "cannot send to self"
    return out


def _check_ops(results, members):
    for rank, got in enumerate(results):
        want = _expected(rank)
        assert set(got) == set(want) | {"stats"}
        for key, value in want.items():
            if key == "allgather":
                assert len(got[key]) == WORLD
                for a, b in zip(got[key], value):
                    np.testing.assert_array_equal(a, b)
            elif key == "self_send":
                assert got[key] == value
            else:
                np.testing.assert_array_equal(got[key], value,
                                              err_msg=f"{key} rank {rank}")
        stats = got["stats"]
        assert stats["world_size"] == WORLD and stats["rank"] == rank
        assert stats["calls"]["allreduce"] == 4
        assert members(stats["members"])


def test_declared_group_ops_on_the_cluster(cluster):
    """4 member tasks, each its own process: a gloo group met through
    rank 0's store, announced by the group's rendezvous actor."""
    col.create_collective_group(WORLD, "all")
    member = rt.remote(cases.collective_member)
    results = rt.get([member.remote(r, WORLD, "all", _collective_ops.run)
                      for r in range(WORLD)], timeout=120)
    col.destroy_collective_group("all")   # kills the rendezvous actor
    _check_ops(results, lambda m: len(m) == WORLD and ":" in m[0])
    with pytest.raises(ValueError, match="no actor named"):
        rt.get_actor("cg:all", namespace="_rt_collective")


def test_declared_group_ops_on_the_local_backend():
    """The local backend's members are threads of this process: the
    in-process plane gives the same results."""
    if rt.is_initialized():
        rt.shutdown()
    rt.init(local_mode=True, num_cpus=8)
    try:
        member = rt.remote(cases.collective_member)
        results = rt.get([member.remote(r, WORLD, "all",
                                        _collective_ops.run)
                          for r in range(WORLD)], timeout=60)
        _check_ops(results, lambda m: m == [f"local:{r}"
                                            for r in range(WORLD)])
        with pytest.raises(RuntimeError, match="cluster backend"):
            col.ship_params({"x": torch.ones(2)})
    finally:
        rt.shutdown()
    with pytest.raises(RuntimeError, match="not been initialized"):
        col.create_collective_group(2, "nowhere")
    with pytest.raises(RuntimeError, match="ray_tpu_torch.init"):
        col.init_collective_group(2, 0, "nowhere")
