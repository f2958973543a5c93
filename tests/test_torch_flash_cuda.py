"""The CUDA flash kernels (forward on the CUDA cores, on the bf16 tensor
cores and split-KV for bf16 decode; backward dq and dkv) against their
plain PyTorch versions,
on the card. Marked ``cuda``: each test skips where no CUDA device is present
(run on a GPU host with ``python -m pytest tests/test_torch_flash_cuda.py
-m cuda``). Imports no jax, so it runs where jax is not installed.

Tolerances: float32 inputs 1e-4 absolute (fp32 sums in another order);
bfloat16 2e-2 absolute + 2e-2 relative on ``o`` (the kernel rounds p to
bf16 against its running max, the plain version against the final max,
and both round o to bf16, one ulp of which is 1.6e-2 at |o| in [2, 4)),
and 1e-3 on the fp32 ``lse``. Backward: max |g - plain| over max |plain|
per gradient, 1e-4 in float32 (summation order) and 1e-2 in bfloat16: the
tensor-core kernels form p and ds in fp32 and round them to bf16 (2**-9 of
each term) as the operand of the dq, dk and dv products, which sum in
fp32, where the plain version keeps p and ds in fp32; each gradient is then
rounded to bf16 once, one ulp of which is 3.9e-3 of the element.
"""

import pytest
import torch

from ray_tpu_torch.ops import flash as tflash

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CASES = {
    # name: (b, sq, sk, hq, hkv, d, causal, offset)
    "d16_causal": (2, 96, 96, 4, 2, 16, True, 0),
    "d64_s77": (2, 77, 77, 4, 2, 64, True, 0),
    "d128_noncausal": (1, 40, 70, 4, 4, 128, False, 0),
    "d128_offset": (1, 17, 300, 8, 8, 128, True, 200),
    "decode_rows": (4, 1, 256, 8, 2, 128, True, None),
    # last query tiles of 10, 5 and 3 rows (idle warps, split keys)
    "ragged_s26": (1, 26, 26, 8, 8, 128, True, 0),
    "short_s5": (2, 5, 40, 8, 2, 64, True, 30),
    "short_s3": (3, 3, 64, 4, 4, 16, True, 50),
    "masked": (2, 96, 96, 4, 2, 16, True, -1000),
    # one short of and one past the bf16 tensor-core kernel's 64-row tiles
    "d64_s63": (2, 63, 63, 4, 2, 64, True, 0),
    "d64_s65": (2, 65, 65, 4, 2, 64, True, 0),
    "d128_s129": (1, 129, 129, 4, 2, 128, True, 0),
    "d128_gqa8": (1, 130, 130, 8, 1, 128, True, 0),
    "d128_per_row": (3, 100, 100, 8, 2, 128, True, [-30, 5, 64]),
    # every row's diagonal cuts key tile [128, 192)
    "d64_sq40_sk300_offset100": (2, 40, 300, 8, 2, 64, True, 100),
}


def _fwd_inputs(device, case, dtype, seed):
    b, sq, sk, hq, hkv, d, causal, off = case
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=device).to(dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    if off is None:   # per-row positions, as the engine's batched decode
        off = torch.randint(0, sk, (b,), generator=g, device=device,
                            dtype=torch.int32)
    elif isinstance(off, list):
        off = torch.tensor(off, dtype=torch.int32, device=device)
    return q, k, v, off, causal


def _check_fwd(q, k, v, off, causal, splits=None):
    """One launch on the kernel ``fwd_tiling`` names, held against the
    plain version."""
    kernel = tflash.fwd_tiling(q.dtype, q.shape[-1], q.shape[1],
                               q.shape[2] // k.shape[2])["kernel"]
    before = (tflash.flash_fwd.launches,
              tflash.flash_fwd.launches_by_kernel[kernel])
    o, lse = tflash.flash_fwd(q, k, v, off, causal=causal, splits=splits)
    torch.cuda.synchronize()
    assert (tflash.flash_fwd.launches,
            tflash.flash_fwd.launches_by_kernel[kernel]) == tuple(
                n + 1 for n in before)
    ref_o, ref_lse = tflash.flash_fwd_reference(q, k, v, off, causal=causal)
    if q.dtype == torch.float32:
        torch.testing.assert_close(o, ref_o, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(o.float(), ref_o.float(), atol=2e-2,
                                   rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    return kernel, o, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda, name, dtype):
    _check_fwd(*_fwd_inputs(cuda, CASES[name], dtype, seed=0))


def test_fwd_dispatch_threshold(cuda):
    """bf16 takes the tensor-core kernel from ``tc_min_sq`` query rows up
    and the split-KV decode kernel below; float32 always the CUDA-core
    one. Both sides of the threshold match the plain version (d 128, s_k
    1024, the rows at the end of the keys)."""
    tc_min = tflash.fwd_tiling(torch.bfloat16, 128, 1)["tc_min_sq"]
    for sq, dtype, want in ((tc_min - 1, torch.bfloat16, "dec"),
                            (tc_min, torch.bfloat16, "tcb"),
                            (tc_min, torch.float32, "simt")):
        if sq < 1:
            continue
        case = (2, sq, 1024, 8, 8, 128, True, 1024 - sq)
        assert _check_fwd(*_fwd_inputs(cuda, case, dtype, seed=5))[0] == want


DEC_CASES = {
    # name: (b, sq, sk, hq, hkv, d, causal, offset); all bf16 decode
    "d128_b8": (8, 1, 1024, 8, 8, 128, True, None),
    "d64_gqa8": (4, 1, 700, 32, 4, 64, True, None),
    "d16_gqa4": (3, 1, 300, 8, 2, 16, True, [299, 0, 150]),
    # a dead row; rows whose later chunks are all dead
    "d64_dead_first_chunk": (4, 1, 1024, 8, 2, 64, True, [-1, 0, 63, 1023]),
    "d128_noncausal": (2, 1, 333, 4, 2, 128, False, 0),
    # a group of 16 q heads fills the 16-row tile
    "d128_gqa16": (2, 1, 512, 16, 1, 128, True, None),
    "d128_s4096": (1, 1, 4096, 32, 32, 128, True, 4095),
}


def _dec_splits(case, which):
    """The split count of a DEC_CASES case: the default rule's, 1, or one
    chunk per 64-key tile."""
    sk = case[2]
    return {"default": None, "one": 1,
            "per_tile": -(-sk // tflash.DEC_KEY_TILE)}[which]


@pytest.mark.parametrize("which", ["default", "one", "per_tile"])
@pytest.mark.parametrize("name", sorted(DEC_CASES))
def test_decode_kernel_matches_plain(cuda, name, which):
    """dec against the plain forward and against the plain version of its
    split arithmetic with the same split count; dead rows o = 0, lse =
    NEG_INF."""
    q, k, v, off, causal = _fwd_inputs(cuda, DEC_CASES[name],
                                       torch.bfloat16, seed=6)
    splits = _dec_splits(DEC_CASES[name], which)
    kernel, o, lse = _check_fwd(q, k, v, off, causal, splits)
    assert kernel == "dec"
    b, _, sk, _, hkv, _, _, _ = DEC_CASES[name]
    n = splits or tflash.decode_splits(
        b, hkv, sk, torch.cuda.get_device_properties(0)
        .multi_processor_count)[0]
    so, slse = tflash.flash_decode_reference(q, k, v, off, n, causal=causal)
    # the same chunks merged in the same order: one bf16 ulp of o at most
    torch.testing.assert_close(o.float(), so.float(), atol=1e-3, rtol=8e-3)
    torch.testing.assert_close(lse, slse, atol=1e-4, rtol=0)
    offs = tflash._offsets(off, b, q.device)
    dead = offs < 0
    assert bool((o[dead] == 0).all()) and bool((lse[dead] < -1e9).all())


@pytest.mark.parametrize("which", ["default", "one", "per_tile"])
@pytest.mark.parametrize("name", ["d128_b8", "d64_gqa8", "d128_s4096"])
def test_decode_kernel_is_deterministic(cuda, name, which):
    """Each block sums its keys in a fixed order and the splits merge in
    split order: two launches give the same bits."""
    q, k, v, off, causal = _fwd_inputs(cuda, DEC_CASES[name],
                                       torch.bfloat16, seed=8)
    splits = _dec_splits(DEC_CASES[name], which)
    first = tflash.flash_fwd(q, k, v, off, causal=causal, splits=splits)
    second = tflash.flash_fwd(q, k, v, off, causal=causal, splits=splits)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_fwd_tiling_names_each_kernel(cuda):
    """bf16 decode whose GQA group fits 16 rows: dec, with its splits and
    chunk; a group of 32: tcb; float32: simt."""
    t = tflash.fwd_tiling(torch.bfloat16, 128, 1, 1, b=1, hkv=32, sk=1024)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert t["kernel"] == "dec" and t["block_rows"] == 16
    assert (t["splits"], t["chunk"]) == tflash.decode_splits(1, 32, 1024, sms)
    assert t["stages"] >= 2 and t["blocks_per_sm"] >= 1
    assert tflash.fwd_tiling(torch.bfloat16, 64, 1, 8)["kernel"] == "dec"
    assert tflash.fwd_tiling(torch.bfloat16, 64, 1, 32)["kernel"] == "tcb"
    assert tflash.fwd_tiling(torch.float32, 128, 1)["kernel"] == "simt"


def test_fwd_refuses_a_split_count_the_chunk_rule_does_not_allow(cuda):
    """More chunks than 64-key tiles, a count that leaves a chunk empty,
    and splits on a kernel that takes none: refused without a launch."""
    q, k, v, off, causal = _fwd_inputs(cuda, DEC_CASES["d16_gqa4"],
                                       torch.bfloat16, seed=1)
    before = dict(tflash.flash_fwd.launches_by_kernel)
    for bad in (6, 0):   # 300 keys are 5 tiles
        with pytest.raises(ValueError, match="chunks of whole"):
            tflash.flash_fwd(q, k, v, off, causal=causal, splits=bad)
    q2 = torch.zeros((1, 4, 2, 64), device=cuda, dtype=torch.bfloat16)
    k2 = torch.zeros((1, 640, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="chunks of whole"):
        # 10 tiles: chunks of 2 tiles make 5 chunks, not 6
        tflash.flash_fwd(q2[:, :1], k2, k2, splits=6)
    with pytest.raises(ValueError, match="takes no splits"):
        tflash.flash_fwd(q2, k2, k2, splits=2)
    assert tflash.flash_fwd.launches_by_kernel == before


def test_fwd_refuses_more_query_tiles_than_the_grid_holds(cuda):
    """The C side refuses, without launching, a call whose query tiles
    overflow grid.y; the wrapper raises and counts no launch."""
    rows = tflash.FWD_TILE_ROWS["simt"]
    sq = tflash.MAX_GRID_Y * rows + 1
    q = torch.zeros((1, sq, 1, 16), device=cuda)
    k = v = torch.zeros((1, 1, 1, 16), device=cuda)
    assert tflash.fwd_tiling(q.dtype, 16, sq)["block_rows"] == rows
    before = tflash.flash_fwd.launches
    with pytest.raises(ValueError, match="simt kernel takes at most"):
        tflash.flash_fwd(q, k, v)
    assert tflash.flash_fwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["d64_s65", "d128_gqa8", "d128_per_row",
                                  "decode_rows"])
def test_fwd_kernels_are_deterministic(cuda, name, dtype):
    """Each row is summed in a fixed order: two launches give the same
    bits."""
    q, k, v, off, causal = _fwd_inputs(cuda, CASES[name], dtype, seed=3)
    first = tflash.flash_fwd(q, k, v, off, causal=causal)
    second = tflash.flash_fwd(q, k, v, off, causal=causal)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


BWD_CASES = {
    # name: (b, sq, sk, hq, hkv, d, causal, offset)
    "d16_gqa": (2, 96, 96, 4, 2, 16, True, 0),
    "d64_s77": (2, 77, 77, 4, 2, 64, True, 0),
    "d64_gqa8": (1, 130, 130, 8, 1, 64, True, 0),
    "d128_noncausal": (1, 40, 70, 4, 4, 128, False, 0),
    "d128_offset": (1, 17, 300, 8, 8, 128, True, 200),
    "d64_offset40": (2, 96, 96, 4, 2, 64, True, 40),
    "per_row": (3, 64, 64, 8, 2, 64, True, [0, 17, -5]),
    "masked": (2, 96, 96, 4, 2, 16, True, -1000),
    # one past and one short of the bf16 kernels' 64-row tiles, and less
    # than one tile
    "d64_s65": (2, 65, 65, 4, 2, 64, True, 0),
    "d64_s63": (2, 63, 63, 4, 2, 64, True, 0),
    "d128_s129": (1, 129, 129, 4, 2, 128, True, 0),
    "d16_s127": (2, 127, 127, 4, 2, 16, True, 0),
    "d64_s20": (2, 20, 20, 4, 2, 64, True, 0),
    # every row's diagonal cuts key tile [128, 192)
    "d64_sq40_sk300_offset100": (2, 40, 300, 8, 2, 64, True, 100),
    "d128_gqa8": (1, 130, 130, 8, 1, 128, True, 0),
    "d128_per_row": (3, 100, 100, 8, 2, 128, True, [-30, 5, 64]),
    # the 1b train step's heads and head_dim, cut to b 1, s 512
    "train_1b_b1_s512": (1, 512, 512, 32, 4, 64, True, 0),
}


def _bwd_inputs(device, name, dtype, seed):
    b, sq, sk, hq, hkv, d, causal, off = BWD_CASES[name]
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=device).to(dtype)
                   for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                                 (b, sk, hkv, d), (b, sq, hq, d)))
    if isinstance(off, list):
        off = torch.tensor(off, dtype=torch.int32, device=device)
    return q, k, v, do, off, causal


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_bwd_kernels_match_plain(cuda, name, dtype):
    q, k, v, do, off, causal = _bwd_inputs(cuda, name, dtype, seed=1)
    o, lse = tflash.flash_fwd(q, k, v, off, causal=causal)
    before = (tflash.flash_dq.launches, tflash.flash_dkv.launches,
              tflash.flash_bwd.launches)
    got = tflash.flash_bwd(q, k, v, o, lse, do, off, causal=causal)
    torch.cuda.synchronize()
    assert (tflash.flash_dq.launches, tflash.flash_dkv.launches,
            tflash.flash_bwd.launches) == tuple(n + 1 for n in before)
    want = tflash.flash_bwd_reference(q, k, v, o, lse, do, off,
                                      causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for x, y in zip(got, want):
        assert x.dtype == dtype and x.shape == y.shape
        if name == "masked":
            assert bool((x == 0).all())
            continue
        err = float((x.float() - y.float()).abs().max() / y.float().abs().max())
        assert err <= tol, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["train_1b_b1_s512", "d128_gqa8",
                                  "d128_per_row"])
def test_bwd_kernels_are_deterministic(cuda, name, dtype):
    """Every output element is summed by one block in a fixed order (the
    GQA sum too, with no atomics): two launches give the same bits."""
    q, k, v, do, off, causal = _bwd_inputs(cuda, name, dtype, seed=3)
    o, lse = tflash.flash_fwd(q, k, v, off, causal=causal)
    first = tflash.flash_bwd(q, k, v, o, lse, do, off, causal=causal)
    second = tflash.flash_bwd(q, k, v, o, lse, do, off, causal=causal)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_flash_attention_grads_on_card(cuda):
    """flash_attention's autograd through the kernels, with a strided
    cotangent, equals the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).requires_grad_()
               for shape in ((2, 50, 4, 64), (2, 50, 2, 64), (2, 50, 2, 64)))
    w = torch.randn((2, 4, 50, 64), generator=g, device=cuda)
    do = w.transpose(1, 2)                      # not contiguous
    o = tflash.flash_attention(q, k, v)
    got = torch.autograd.grad(o, (q, k, v), do)
    qd, kd, vd = (x.detach() for x in (q, k, v))
    o_ref, lse = tflash.flash_fwd_reference(qd, kd, vd)
    want = tflash.flash_bwd_reference(qd, kd, vd, o_ref, lse, do)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=0)
