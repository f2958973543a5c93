"""The split arithmetic of the dec kernel (the bf16 split-KV decode
forward) against the JAX package, on the CPU.

``flash_decode_reference`` (the keys cut into chunks of whole 64-key
tiles, the plain forward on each, the partials merged in split order) is
held against JAX's ``flash_attention_with_lse`` in interpret mode, one
call per batch row as ``tests/test_torch_ops.py`` does for per-row
offsets; ``merge_partials`` against ``context._merge`` folded over the
same partials; ``decode_splits`` and ``decode_chunk`` for the rule the C
side applies. Everything is float32, tolerance 1e-5 absolute
(``tests/test_long_context.py:34``): both sides compute the same fp32
math and differ only in summation order. The kernel itself is tested on
the card (``tests/test_torch_flash_cuda.py``, ``chip_smoke.py``).
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import NEG_INF as JNEG_INF
from ray_tpu.ops.pallas import flash as jflash
from ray_tpu.parallel import context as jctx
from ray_tpu_torch.ops import flash as tflash

TOL = 1e-5
SK = 500                          # 8 key tiles of 64
OFFSETS = (-1, 0, 250, SK - 1)    # a dead row, the first key, the last key
# name: (hq, hkv, d)
DECODE_CASES = {"mha_d16": (4, 4, 16), "mha_d64": (4, 4, 64),
                "gqa4_d16": (8, 2, 16), "gqa4_d64": (8, 2, 64)}


def _max_err(port, ref):
    return float(np.abs(port.numpy() - np.asarray(ref, np.float32)).max())


@functools.lru_cache(maxsize=None)
def _decode_case(name):
    """(q, k, v) as numpy and JAX's (o, lse), one flash call per row."""
    hq, hkv, d = DECODE_CASES[name]
    rng = np.random.default_rng(11)
    b = len(OFFSETS)
    q = rng.standard_normal((b, 1, hq, d), np.float32)
    k = rng.standard_normal((b, SK, hkv, d), np.float32)
    v = rng.standard_normal((b, SK, hkv, d), np.float32)
    rows = [jflash.flash_attention_with_lse(
        jnp.asarray(q[r:r + 1]), jnp.asarray(k[r:r + 1]),
        jnp.asarray(v[r:r + 1]), q_offset=jnp.int32(off), block_q=32,
        block_k=512) for r, off in enumerate(OFFSETS)]
    o = np.concatenate([np.asarray(o) for o, _ in rows])
    lse = np.concatenate([np.asarray(lse) for _, lse in rows])
    return q, k, v, o, lse


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_reference_matches_jax_rows(name, splits):
    q, k, v, o_j, lse_j = _decode_case(name)
    offs = torch.tensor(OFFSETS, dtype=torch.int32)
    o_t, lse_t = tflash.flash_decode_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), offs,
        splits)
    assert o_t.dtype == torch.float32 and tuple(lse_t.shape) == lse_j.shape
    assert _max_err(o_t, o_j) < TOL
    assert _max_err(lse_t, lse_j) < TOL
    # the dead row (offset -1): o = 0, lse = NEG_INF, as the kernel's rule
    assert bool((o_t[0] == 0).all()) and bool((lse_t[0] == JNEG_INF).all())


def _partials(n, dead, seed):
    """n partials (o_i [b,s,h,d], lse_i [b,h,s]) with some dead: "none",
    "one" (partial 1 dead everywhere), or "rows" (row 0 dead in every
    partial, row 1 in all but the last)."""
    rng = np.random.default_rng(seed)
    b, s, h, d = 2, 3, 4, 16
    os = [rng.standard_normal((b, s, h, d), np.float32) for _ in range(n)]
    lses = [rng.uniform(-4.0, 6.0, (b, h, s)).astype(np.float32)
            for _ in range(n)]
    if dead == "one":
        os[1][:] = 0.0
        lses[1][:] = JNEG_INF
    elif dead == "rows":
        for i in range(n):
            lses[i][:, :, 0] = JNEG_INF
            os[i][:, 0] = 0.0
            if i < n - 1:
                lses[i][:, :, 1] = JNEG_INF
                os[i][:, 1] = 0.0
    return os, lses


@pytest.mark.parametrize("dead", ["none", "one", "rows"])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_merge_partials_matches_jax_merge_folded(n, dead):
    os, lses = _partials(n, dead, seed=n)
    o_t, lse_t = tflash.merge_partials([torch.from_numpy(o) for o in os],
                                       [torch.from_numpy(x) for x in lses])
    o_j, lse_j = jnp.asarray(os[0]), jnp.asarray(lses[0])
    for o, lse in zip(os[1:], lses[1:]):
        o_j, lse_j = jctx._merge(o_j, lse_j, jnp.asarray(o), jnp.asarray(lse))
    assert _max_err(o_t, o_j) < TOL
    assert _max_err(lse_t, lse_j) < TOL
    if dead == "rows":
        assert bool((o_t[:, 0] == 0).all())
        assert bool((lse_t[:, :, 0] == JNEG_INF).all())


@pytest.mark.parametrize("b,hkv,sk,sms", [
    (1, 32, 1024, 132),    # 7b decode at b 1
    (8, 32, 1024, 132),    # 7b decode at b 8
    (8, 4, 1024, 132),     # 1b decode: 4 kv heads
    (1, 32, 4096, 132),    # one long row
    (1, 1, 100, 132),      # fewer tiles than the grid wants
    (64, 32, 2048, 132),   # a grid that covers the card unsplit
    (1, 8, 1000, 114),     # another SM count
])
def test_decode_splits_cover_the_card_with_whole_tiles(b, hkv, sk, sms):
    splits, chunk = tflash.decode_splits(b, hkv, sk, sms)
    tiles = -(-sk // tflash.DEC_KEY_TILE)
    assert chunk % tflash.DEC_KEY_TILE == 0
    assert splits * chunk >= sk > (splits - 1) * chunk   # none empty
    assert tflash.decode_chunk(sk, splits) == chunk
    # the grid reaches the target, unless its chunks would fall below the
    # floor of whole tiles; then as many chunks as the floor allows
    target = tflash.DEC_BLOCKS_PER_SM * sms
    want = -(-target // (b * hkv))
    floor = tflash.DEC_MIN_CHUNK_TILES
    if tiles // want >= floor:
        assert b * hkv * splits >= target
    else:
        assert splits == -(-tiles // floor)
    if b * hkv >= target:
        assert splits == 1


def test_decode_splits_depend_on_shapes_and_card_only():
    """No position enters the rule: its arguments are the shapes and the
    SM count, so the launch a CUDA graph holds stays right as positions
    move."""
    params = list(inspect.signature(tflash.decode_splits).parameters)
    assert params == ["b", "hkv", "sk", "sms"]
    # one long row at b 1: 132 SMs want 5 chunks a kv head, chunks of 12
    # of its 64 tiles make 6, evened out to 11 tiles (704 keys) each
    assert tflash.decode_splits(1, 32, 4096, 132) == (6, 704)


@pytest.mark.parametrize("sk,splits", [(300, 6), (300, 0), (640, 6),
                                       (64, 2)])
def test_decode_chunk_refuses_what_the_kernel_refuses(sk, splits):
    with pytest.raises(ValueError, match="chunks of whole"):
        tflash.decode_chunk(sk, splits)
