"""ray_tpu_torch's replay buffers and off-policy estimators against the
JAX package's (``ray_tpu/rl/replay_buffer.py``, ``ray_tpu/rl/ope.py``).

Both are numpy on the host in both packages, so fed the same batches and
TD errors the buffers hold the same rows and priorities, sample the same
indices with the same importance weights, and leave their generators in
the same state: held to equality. The estimators are held within 1e-12
relative on seeded episodes (float64 on both sides).
"""

import numpy as np
import pytest

from ray_tpu.rl import ope as jope
from ray_tpu.rl.replay_buffer import PrioritizedReplayBuffer as JPrioritized
from ray_tpu.rl.replay_buffer import ReplayBuffer as JReplay
from ray_tpu_torch.rl import ope as tope
from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer


def _batches(seed, n_batches, rows):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield {"obs": rng.normal(size=(rows, 3)).astype(np.float32),
               "actions": rng.integers(0, 2, rows).astype(np.int32),
               "rewards": rng.normal(size=rows).astype(np.float32),
               "dones": rng.random(rows) < 0.1}


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("capacity", [37, 64])
def test_ring_buffer_matches_jax(capacity):
    """Wraps around (6 batches of 13 rows into 37 or 64 slots)."""
    tb, jb = ReplayBuffer(capacity, seed=3), JReplay(capacity, seed=3)
    for batch in _batches(0, 6, 13):
        tb.add_batch(batch)
        jb.add_batch(batch)
        assert len(tb) == len(jb)
        assert (tb._next, tb._size) == (jb._next, jb._size)
        _assert_same(tb.sample(9), jb.sample(9))
    _assert_same(tb._storage, jb._storage)
    assert tb._rng.bit_generator.state == jb._rng.bit_generator.state


@pytest.mark.parametrize("capacity,alpha,beta", [(50, 0.6, 0.4),
                                                 (128, 1.0, 1.0)])
def test_prioritized_buffer_matches_jax(capacity, alpha, beta):
    """Indices, weights and the sum-tree after each priority refresh."""
    tb = PrioritizedReplayBuffer(capacity, alpha=alpha, beta=beta, seed=7)
    jb = JPrioritized(capacity, alpha=alpha, beta=beta, seed=7)
    rng = np.random.default_rng(11)
    for batch in _batches(1, 8, 17):
        tb.add_batch(batch)
        jb.add_batch(batch)
        (t_rows, t_idx, t_w), (j_rows, j_idx, j_w) = tb.sample(16), \
            jb.sample(16)
        _assert_same(t_rows, j_rows)
        np.testing.assert_array_equal(t_idx, j_idx)
        np.testing.assert_array_equal(t_w, j_w)
        assert t_w.dtype == j_w.dtype == np.float32
        td = rng.normal(scale=2.0, size=16).astype(np.float32)
        tb.update_priorities(t_idx, td)
        jb.update_priorities(j_idx, td)
        np.testing.assert_array_equal(tb._tree, jb._tree)
        assert tb._max_priority == jb._max_priority
    assert tb._rng.bit_generator.state == jb._rng.bit_generator.state


def _episodes(seed, n=6, num_actions=3):
    rng = np.random.default_rng(seed)
    eps = []
    for _ in range(n):
        t = int(rng.integers(3, 9))
        probs = rng.dirichlet(np.ones(num_actions), size=t)
        acts = rng.integers(0, num_actions, t)
        eps.append({
            "rewards": rng.normal(size=t), "actions": acts,
            "behavior_logp": np.log(rng.uniform(0.2, 0.6, t)),
            "target_logp": np.log(probs[np.arange(t), acts]),
            "q_values": rng.normal(size=(t, num_actions)),
            "target_probs": probs})
    return eps


@pytest.mark.parametrize("method,kwargs", [
    ("is", {}), ("is", {"gamma": 0.9, "weight_clip": 2.0}),
    ("wis", {}), ("wis", {"gamma": 0.95, "weight_clip": 1.5}),
    ("dm", {"gamma": 0.9}), ("dr", {}), ("dr", {"gamma": 0.9,
                                               "weight_clip": 3.0})])
def test_ope_estimators_match_jax(method, kwargs):
    eps = _episodes(4)
    got = tope.estimate(method, eps, **kwargs)
    want = jope.estimate(method, eps, **kwargs)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    with pytest.raises(ValueError, match="unknown estimator"):
        tope.estimate("nope", eps)


@pytest.mark.parametrize("num_envs", [1, 4])
def test_episodes_from_batch_matches_jax(num_envs):
    rng = np.random.default_rng(2)
    n = 48
    batch = {"rewards": rng.normal(size=n), "dones": rng.random(n) < 0.15,
             "actions": rng.integers(0, 3, n)}
    got = tope.episodes_from_batch(batch, num_envs=num_envs)
    want = jope.episodes_from_batch(batch, num_envs=num_envs)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert tope.episodes_from_batch(
        {"rewards": np.array([]), "dones": np.array([], bool)}) == []
    with pytest.raises(ValueError, match="not divisible"):
        tope.episodes_from_batch(batch, num_envs=5)
