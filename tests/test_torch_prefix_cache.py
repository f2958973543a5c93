"""ray_tpu_torch's prefix KV cache against the JAX package's.

``util/prefix_hash.py``: keys and digests byte-identical to JAX's (the
serve router hashes prompts with the JAX module). ``PrefixKVCache``: the
same sequence of insert/lookup/cached_len/clear calls on both caches gives
equal return values, pages, ``stats()`` and ``digests()``. The ports of
the cache-level cases of tests/test_zz_kv_cache.py: suffix-only restore,
LRU under a tight budget, oversize rejection, superset coalescing,
eviction repointing."""

import numpy as np
import pytest
import torch

from ray_tpu.models import serving as JS
from ray_tpu.util import prefix_hash as JPH
from ray_tpu_torch.models import serving as TS
from ray_tpu_torch.util import prefix_hash as TPH

PREFIX = list(range(1, 49))  # 48 tokens = 3 chunks at chunk=16


# ---------------------------------------------------------------------------
# prefix_hash
# ---------------------------------------------------------------------------


def test_prefix_hash_constants_match():
    assert (TPH._DEFAULT_CHUNK, TPH.MAX_PROBE_CHUNKS, TPH.TOKEN_WIDTH) == (
        JPH._DEFAULT_CHUNK, JPH.MAX_PROBE_CHUNKS, JPH.TOKEN_WIDTH) == (
        16, 32, 4)


@pytest.mark.parametrize("seed,n,chunk", [(0, 0, 16), (1, 15, 16),
                                          (2, 16, 16), (3, 97, 16),
                                          (4, 700, 16), (5, 130, 7),
                                          (6, 64, 1)])
def test_prefix_hash_byte_identical(seed, n, chunk):
    rng = np.random.default_rng(seed)
    # the full int32 range, negatives included
    toks = rng.integers(-2**31, 2**31, size=n, dtype=np.int64)
    for m in {0, n // 2, n}:
        assert TPH.token_key(toks, m) == JPH.token_key(toks, m)
        assert TPH.prefix_digest(toks, m) == JPH.prefix_digest(toks, m)
        assert TPH.aligned_len(m, chunk) == JPH.aligned_len(m, chunk)
    key = JPH.token_key(toks, n)
    assert TPH.chunked_digests(key, chunk) == JPH.chunked_digests(key, chunk)
    for max_chunks in (32, 5):
        assert (TPH.prompt_digests(toks, chunk, max_chunks)
                == JPH.prompt_digests(toks, chunk, max_chunks))
    body = {"tokens": [int(t) for t in toks]}
    assert (TPH.request_prefix_digests((body,), {})
            == JPH.request_prefix_digests((body,), {}))


def test_chunk_size_env_matches(monkeypatch):
    for val in ("8", "0", "junk"):
        monkeypatch.setenv("RT_KV_CHUNK", val)
        assert TPH.chunk_size() == JPH.chunk_size()
    monkeypatch.delenv("RT_KV_CHUNK")
    assert TPH.chunk_size() == JPH.chunk_size() == 16


# ---------------------------------------------------------------------------
# PrefixKVCache: one scripted sequence through both caches
# ---------------------------------------------------------------------------


class _Pair:
    """A JAX cache and a port cache driven by the same calls; every call
    returns the JAX result after checking the port's equals it."""

    def __init__(self, max_bytes, chunk=16, seed=0):
        self.j = JS.PrefixKVCache(chunk=chunk, max_bytes=max_bytes,
                                  label="pair")
        self.t = TS.PrefixKVCache(chunk=chunk, max_bytes=max_bytes,
                                  label="pair")
        self.rng = np.random.default_rng(seed)

    def check(self):
        assert self.t.stats() == self.j.stats()
        assert self.t.digests() == self.j.digests()
        assert self.t.digests(limit=3) == self.j.digests(limit=3)

    def insert(self, tokens, n=None):
        toks = np.asarray(tokens, np.int32)
        n = len(toks) if n is None else n
        k, v = (self.rng.standard_normal((2, n, 2, 4)).astype(np.float32)
                for _ in range(2))
        got = self.t.insert(toks.astype(np.int64), torch.from_numpy(k),
                            torch.from_numpy(v))
        want = self.j.insert(toks, k, v)
        assert got == want
        self.check()
        return want

    def lookup(self, tokens):
        toks = np.asarray(tokens, np.int32)
        got = self.t.lookup(toks.astype(np.int64))
        want = self.j.lookup(toks)
        if want is None:
            assert got is None
        else:
            assert got is not None and got[0] == want[0]
            np.testing.assert_array_equal(got[1].numpy(), want[1])
            np.testing.assert_array_equal(got[2].numpy(), want[2])
        self.check()
        return None if want is None else want[0]

    def cached_len(self, tokens):
        toks = np.asarray(tokens, np.int32)
        want = self.j.cached_len(toks)
        assert self.t.cached_len(toks.astype(np.int64)) == want
        self.check()
        return want

    def clear(self):
        want = self.j.clear()
        assert self.t.clear() == want
        self.check()
        return want


def _entry_bytes(n):
    return 2 * 2 * n * 2 * 4 * 4   # k and v, [2, n, 2, 4] float32


def test_suffix_only_restore_ladder():
    """The restore length is the largest power-of-two chunk multiple
    below the prompt, capped at len - 1."""
    c = _Pair(1 << 20)
    assert c.lookup(PREFIX + [60]) is None          # miss on empty
    assert c.insert(PREFIX)                          # 48 tokens
    assert c.lookup(PREFIX + [60, 61, 62, 63]) == 32
    assert c.lookup(PREFIX) == 32                    # cap at len - 1
    assert c.lookup(PREFIX[:17]) == 16
    assert c.lookup(PREFIX[:16]) is None             # cap 15 < chunk
    assert c.lookup([99] + PREFIX) is None
    assert c.cached_len(PREFIX) == 48
    assert c.cached_len(PREFIX[:40]) == 32
    assert not c.insert(PREFIX)                      # already resident
    long = list(range(1, 161))                       # 160 tokens
    assert c.insert(long)                            # supersedes PREFIX
    assert c.lookup(long + [7]) == 128
    assert c.clear() == 1
    assert c.lookup(long + [7]) is None


def test_lru_eviction_under_tight_budget():
    c = _Pair(int(2.5 * _entry_bytes(32)))
    p1, p2, p3 = ([300 + i for i in range(32)], [400 + i for i in range(32)],
                  [500 + i for i in range(32)])
    assert c.insert(p1) and c.insert(p2)
    assert c.t.stats()["pages"] == 2
    assert c.lookup(p1 + [2]) == 32                  # p2 becomes LRU
    assert c.insert(p3)                              # evicts p2
    assert c.t.stats()["evictions"] == 1
    assert (c.cached_len(p1), c.cached_len(p2), c.cached_len(p3)) == (
        32, 0, 32)


def test_oversized_entry_rejected():
    c = _Pair(64)
    assert not c.insert(PREFIX)
    assert c.t.stats()["pages"] == 0 and c.t.stats()["bytes"] == 0
    # one entry that fits alone, then a second that pushes the pair over
    c2 = _Pair(_entry_bytes(32) + 8)
    assert c2.insert(list(range(1, 33)))
    assert c2.insert(list(range(100, 132)))          # evicts the first
    assert c2.t.stats()["pages"] == 1


def test_superset_insert_coalesces_covered_entry():
    c = _Pair(1 << 20)
    toks = list(range(1, 97))                        # 96 tokens
    assert c.insert(toks[:32])
    assert c.insert(toks)
    assert c.t.stats()["pages"] == 1
    assert c.t.stats()["bytes"] == _entry_bytes(96)
    assert c.lookup(toks[:32] + [999]) == 32


def test_eviction_repoints_shared_chunk_rows():
    shared = list(range(1, 17))
    a = shared + list(range(100, 116))
    b = shared + list(range(200, 216))
    other = list(range(300, 332))
    c = _Pair(int(2.5 * _entry_bytes(32)))
    assert c.insert(b) and c.insert(a)               # a owns the shared row
    assert c.lookup(b + [999]) == 32                 # a becomes LRU
    assert c.insert(other)
    assert c.t.stats()["evictions"] == 1
    assert c.cached_len(a) == 16                     # shared chunk survives
    assert c.lookup(shared + [999]) == 16


def test_digests_interleave_entries():
    """Many entries of different lengths: the report interleaves them in
    MRU order, bounded, the same on both sides."""
    c = _Pair(1 << 22)
    rng = np.random.default_rng(3)
    entries = [list(rng.integers(0, 1000, size=n))
               for n in (16, 160, 48, 96, 32)]
    for toks in entries:
        c.insert(toks)
    assert c.lookup(entries[1] + [1]) == 128         # the long one is MRU
    assert len(c.t.digests()) == min(2 * TPH.MAX_PROBE_CHUNKS,
                                     (16 + 160 + 48 + 96 + 32) // 16)


def test_live_kv_cache_stats_lists_port_caches():
    cache = TS.PrefixKVCache(chunk=16, max_bytes=1024, label="live-probe")
    labels = [s["label"] for s in TS.live_kv_cache_stats()]
    assert "live-probe" in labels
    del cache
