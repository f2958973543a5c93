"""The port's collective groups (``ray_tpu_torch/collective``) on a gloo
gang of 4 ranks against JAX's host-plane group API on the same inputs,
run by 4 member tasks of a local cluster (``ray_tpu.collective``): allreduce (sum, prod, min, max), uneven
reducescatter, allgather, broadcast, a buffered send received after a
barrier, the self-send refusal (``_collective_ops.run``); then a subgroup
only its members join, and a group of one. The gang holds itself to ``LIMIT_S``."""

import numpy as np
import pytest

import _collective_ops
import _torch_gang as gang
from ray_tpu_torch.collective import rendezvous

LIMIT_S = 180
WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import cloudpickle

    import ray_tpu

    g = gang.start("collective", WORLD, tmp_path_factory.mktemp("coll"),
                   LIMIT_S)

    def member(rank, world):
        from ray_tpu import collective as jcol

        jcol.init_collective_group(world, rank, "all")
        return _collective_ops.run(jcol, rank, np.asarray)

    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    cloudpickle.register_pickle_by_value(_collective_ops)
    ray_tpu.init(num_cpus=WORLD)
    try:
        m = ray_tpu.remote(member)
        ref = ray_tpu.get([m.remote(r, WORLD) for r in range(WORLD)],
                          timeout=LIMIT_S)
        # the group's actor goes once every member is done: a member that
        # destroyed it on finishing could kill it before a slower member's
        # last barrier reply reached that member
        from ray_tpu import collective as jcol

        jcol.destroy_collective_group("all")
    finally:
        ray_tpu.shutdown()
        cloudpickle.unregister_pickle_by_value(_collective_ops)
    return ref, g.result()


def test_ops_match_jax(runs):
    ref, got = runs
    for rank in range(WORLD):
        want, have = ref[rank], got[rank]
        assert set(want) <= set(have)
        for key, value in want.items():
            if key == "allgather":
                assert len(have[key]) == WORLD
                for a, b in zip(have[key], value):
                    np.testing.assert_array_equal(a, b)
            elif key == "self_send":
                assert have[key] == value == "cannot send to self"
            else:
                np.testing.assert_array_equal(have[key], value,
                                              err_msg=f"{key} rank {rank}")


def test_reducescatter_chunks_are_uneven(runs):
    _, got = runs
    assert [len(r["reducescatter"]) for r in got] == [2, 2, 2, 1]


def test_subgroups_and_groups_of_one(runs):
    _, got = runs
    for rank, r in enumerate(got):
        assert r["solo_copy"]
        if rank >= WORLD - 2:
            np.testing.assert_array_equal(r["pair"], [2.0 + 3.0])
        else:
            assert "pair" not in r
        assert r["stats"]["members"] == list(range(WORLD))
        assert r["stats"]["calls"]["allreduce"] == 4


def test_bootstrap_needs_an_init_method_and_checks_ranks():
    with pytest.raises(ValueError, match="init_method"):
        rendezvous.bootstrap_torch_distributed(2, 0, backend_name="gloo")
    with pytest.raises(ValueError, match="out of range"):
        rendezvous.bootstrap_torch_distributed(
            2, 5, backend_name="gloo", init_method="file:///nonexistent")
    rendezvous.clear_rendezvous("never-bootstrapped")   # a no-op
