"""ray_tpu_torch's device feed (``data/iterator.py``) against the JAX
package's ``DataIterator.iter_jax_batches``.

The JAX side reads in-memory blocks of uneven sizes: its ``_blocks``
takes a block without a ``hex`` attribute as is, so no cluster is needed.
The port's side gets the batches those blocks re-chunk into (rows in
order, ``batch_size`` at a time, a short last batch unless
``drop_last``), as any ``iter_batches`` hands them on. The groups must
be equal leaf for leaf in shape, dtype and value: stacking, the flush
before a ragged-B batch, the ragged tail, the dtype cast. Then:
``prefetched`` raises an upstream error after the items before it and
unwinds when abandoned, and the ingest/compute report of
``DeviceBatchIterator`` equals ``JaxBatchIterator``'s on one scripted
clock.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.data import iterator as jiter
from ray_tpu_torch.data import iterator as titer

ROWS, WIDTH = 30, 5
BLOCK_ROWS = (3, 7, 5, 1, 9, 5)


def _blocks():
    rows = np.arange(ROWS * WIDTH, dtype=np.int32).reshape(ROWS, WIDTH)
    out, at = [], 0
    for n in BLOCK_ROWS:
        out.append({"tokens": rows[at:at + n],
                    "mask": (rows[at:at + n] % 3 == 0).astype(np.float32)})
        at += n
    return out


def _host_batches(batch_size, drop_last):
    """The blocks' rows re-chunked ``batch_size`` at a time."""
    merged = {k: np.concatenate([b[k] for b in _blocks()])
              for k in ("tokens", "mask")}
    for at in range(0, ROWS, batch_size):
        if drop_last and at + batch_size > ROWS:
            return
        yield {k: v[at:at + batch_size] for k, v in merged.items()}


@pytest.mark.parametrize("stack,drop_last,dtype", [
    (1, False, None),
    (3, False, None),           # [3], [3], flush [1] before [1, 2 rows]
    (4, True, None),            # 7 full batches: [4] and a [3] tail
    (4, False, np.float32),     # cast, and the ragged batch alone
    (2, True, np.int32),
])
def test_groups_match_iter_jax_batches(stack, drop_last, dtype):
    ref = list(jiter.DataIterator(lambda: iter(_blocks())).iter_jax_batches(
        batch_size=4, drop_last=drop_last, dtype=dtype, stack=stack))
    feed = titer.iter_device_batches(_host_batches(4, drop_last),
                                     stack=stack, dtype=dtype, device="cpu")
    assert feed.stack == stack
    got = list(feed)
    assert len(got) == len(ref) and feed.batches == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            want = np.asarray(r[k])
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert tuple(g[k].shape) == want.shape
            assert g[k].numpy().dtype == want.dtype
            np.testing.assert_array_equal(g[k].numpy(), want)


def test_group_shapes_for_a_ragged_batch():
    """The groups iter_jax_batches' docstring specifies, spelled out."""
    shapes = [tuple(g["tokens"].shape) for g in titer.iter_device_batches(
        _host_batches(4, False), stack=3, device="cpu")]
    assert shapes == [(3, 4, WIDTH), (3, 4, WIDTH), (1, 4, WIDTH),
                      (1, 2, WIDTH)]


def test_prefetched_raises_upstream_errors_in_order():
    def upstream():
        yield 1
        yield 2
        raise RuntimeError("loader broke")

    for it in (titer.prefetched(upstream(), 2), jiter.prefetched(upstream(),
                                                                  2)):
        got = []
        with pytest.raises(RuntimeError, match="loader broke"):
            for x in it:
                got.append(x)
        assert got == [1, 2]
    feed = titer.iter_device_batches(
        ({"tokens": np.zeros((2, 3), np.int32)} if i < 2 else 1 / 0
         for i in range(4)), device="cpu")
    with pytest.raises(ZeroDivisionError):
        list(feed)


def test_prefetched_unwinds_when_abandoned():
    produced = []

    def upstream():
        for i in range(1000):
            produced.append(i)
            yield i

    before = {t for t in threading.enumerate() if t.name == "rtt-prefetch"}
    it = titer.prefetched(upstream(), 2)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and any(
            t.is_alive() and t not in before for t in threading.enumerate()
            if t.name == "rtt-prefetch"):
        time.sleep(0.01)
    alive = [t for t in threading.enumerate()
             if t.name == "rtt-prefetch" and t not in before]
    assert not any(t.is_alive() for t in alive)
    assert len(produced) <= 5     # the lookahead, not the whole stream


def test_report_matches_jax_batch_iterator(monkeypatch):
    """One scripted clock: each pull costs 2 ms (the first 40 ms, the
    cold start), each consumer step 10 ms. Both iterators book the same
    ingest, compute and cold start, and say compute-limited."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])

    def inner(wrap):
        for i in range(5):
            clock[0] += 0.040 if i == 0 else 0.002
            yield wrap({"x": np.full(3, i)})

    its = (jiter.JaxBatchIterator(inner(lambda b: b), stack=2),
           titer.DeviceBatchIterator(inner(
               lambda b: ({"x": torch.from_numpy(b["x"])}, None)), stack=2))
    reports = []
    for it in its:
        clock[0] = 100.0
        for _ in it:
            clock[0] += 0.010
        reports.append((it.report(), it.verdict(), it.stack))
    assert reports[0] == reports[1]
    rep = reports[1][0]
    assert rep["verdict"] == "compute-limited" and rep["batches"] == 5
    assert rep["cold_start_s"] == pytest.approx(0.040)
    assert rep["ingest_s"] == pytest.approx(0.008)


def test_feed_default_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        titer.iter_device_batches(iter([]))
