"""Sharded checkpoints of the port (``train/checkpoint.py``) on a gloo
gang of 4 ranks: the ``debug`` state from ``init_sharded_state`` under
``auto_mesh(4, tp=4)`` is saved with each rank writing only its own
blocks, then restored bit-equal into the same placements, into
(fsdp 2, tp 2), and whole into this one process: the counterpart of
``tests/test_train.py:183-215``, where fsdp and tp are swapped. An async
save snapshots the blocks before the step loop changes them in place.
The gang holds itself to ``LIMIT_S``."""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _torch_gang as gang
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.train.checkpoint import Checkpoint

LIMIT_S = 180


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    ranks = gang.start("checkpoint", 4, tmp, LIMIT_S, preset="debug",
                       dir=str(tmp / "ckpt")).result()
    return ranks, Checkpoint(str(tmp / "ckpt"))


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_restore_into_the_same_placements(run):
    ranks, _ = run
    full = ranks[0]["full"]
    for r in ranks:
        assert r["same_placements"] == r["saved_placements"]
        _equal(r["same_full"], full)


def test_restore_into_another_layout(run):
    """Saved under (tp 4), restored under (fsdp 2, tp 2): the rules'
    placements there, bit-equal."""
    class Mesh:
        mesh_dim_names = ("fsdp", "tp")

    ranks, _ = run
    rules = tllama.sharding_rules()
    for r in ranks:
        for name, places in r["other_placements"].items():
            assert places == sharding.placements(rules.spec_for(name),
                                                 Mesh()), name
        _equal(r["other_full"], ranks[0]["full"])
    assert ranks[0]["saved_placements"]["layers/wq"] == (Shard(2),)
    assert ranks[0]["other_placements"]["layers/wq"] == (Shard(1), Shard(2))


def test_restore_whole_in_one_process(run):
    ranks, ckpt = run
    back = ckpt.load_pytree("params", device="cpu")
    flat = {**{k: v for k, v in back.items() if k != "layers"},
            **{f"layers/{k}": v for k, v in back["layers"].items()}}
    _equal({k: v.numpy() for k, v in flat.items()}, ranks[0]["full"])


def test_async_save_keeps_the_values_at_the_snapshot(run):
    ranks, ckpt = run
    for r in ranks:
        _equal(r["async_full"], ranks[0]["full"])
        assert r["async_placements"] == r["saved_placements"]
        assert r["async_count"] == 0
        # the moments had no shardings given: they came back whole
        assert r["async_mu_whole"]
    state = ckpt.load_pytree("state", device="cpu")
    assert float(state["mu"]["embed"].abs().max()) == 0.0


def test_no_rank_writes_or_holds_the_whole_tree(run):
    """Each rank wrote only its own blocks (a replicated leaf once, by the
    ranks at coordinate 0 of its replicated dims), the blocks add up to
    the tree, and no rank's blocks, saved or restored, are the whole."""
    ranks, _ = run
    total = ranks[0]["total_numel"]
    written = [r["written"] for r in ranks]
    assert sum(written) == 4 * total
    for r in ranks:
        assert r["written"] < 4 * total
        for key, n in r["local_numel"].items():
            assert n < total, key
