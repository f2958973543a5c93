"""The host-side helpers of the card runs, on the CPU: the build's ptxas
summary (``chip_smoke.py`` fails a run on any register spill in it),
``chip_smoke.py``'s model of the dkv grid's scheduling tail and its work
count of the forward, and the tuning scripts' variants, each of which must
still name text in ``csrc/flash_bwd.cu`` or ``csrc/flash_fwd.cu``."""

import importlib.util
import pathlib

import pytest

from ray_tpu_torch.ops import _build
from ray_tpu_torch.tools import tune_flash_bwd, tune_flash_fwd

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__9e8a1342_12_flash_bwd_cu_a7e0cad03tcb20flash_bwd_dkv_kernelILi128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__9e8a1342_12_flash_bwd_cu_a7e0cad03tcb20flash_bwd_dkv_kernelILi128EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 248 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__9e8a1342_12_flash_bwd_cu_a7e0cad04simt19flash_bwd_dq_kernelILi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__9e8a1342_12_flash_bwd_cu_a7e0cad04simt19flash_bwd_dq_kernelILi64EEEvNS_6ParamsE
    24 bytes stack frame, 28 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 168 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c_12_flash_fwd_cu_a7e0cad016flash_fwd_kernelI13__nv_bfloat16Li64EEEvNS_6ParamsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c_12_flash_fwd_cu_a7e0cad016flash_fwd_kernelIfLi128EEEvNS_6ParamsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c_12_flash_fwd_cu_b1f2c3d43tcb16flash_fwd_kernelILi64EEEvNS_6ParamsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c_12_flash_fwd_cu_b1f2c3d44simt16flash_fwd_kernelILi128EEEvNS_6ParamsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c_12_flash_fwd_cu_b1f2c3d44simt16flash_fwd_kernelILi16EEEvNS_6ParamsE' for 'sm_90a'
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c_12_flash_fwd_cu_b1f2c3d43dec16flash_fwd_kernelILi128EEEvNS_6ParamsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c_12_flash_fwd_cu_b1f2c3d43dec24flash_fwd_combine_kernelILi64EEEvNS_6ParamsE' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_summary_names_kernels_with_registers_and_spills():
    got = _build.ptxas_summary(PTXAS_LOG)
    assert got == {
        "tcb::flash_bwd_dkv_kernel<bf16,128>": {"registers": 248,
                                                "spill_bytes": 0},
        "simt::flash_bwd_dq_kernel<float,64>": {"registers": 168,
                                                "spill_bytes": 60},
        "flash_fwd_kernel<bf16,64>": {"registers": 80, "spill_bytes": 0},
        "flash_fwd_kernel<float,128>": {"registers": 80, "spill_bytes": 0},
        "tcb::flash_fwd_kernel<bf16,64>": {"registers": 154,
                                           "spill_bytes": 0},
        "simt::flash_fwd_kernel<float,128>": {"registers": 96,
                                              "spill_bytes": 0},
        "simt::flash_fwd_kernel<float,16>": {"registers": 40,
                                             "spill_bytes": 8},
        "dec::flash_fwd_kernel<bf16,128>": {"registers": 168,
                                            "spill_bytes": 0},
        "dec::flash_fwd_combine_kernel<bf16,64>": {"registers": 32,
                                                   "spill_bytes": 16},
    }


DKV_TILING = {"block_rows": 64, "stream_tile": 64, "blocks_per_sm": 2}


@pytest.mark.parametrize("case,want", [
    # the 1b train step: 16 (batch, kv head) x 32 key tiles, heaviest
    # first, fill 264 slots evenly
    ((4, 2048, 2048, 32, 4, True, [0] * 4),
     {"blocks": 512, "slots": 264, "makespan_tiles": 256,
      "tail_share": 0.0}),
    # cut to b 1, s 512: 32 blocks leave most of the card idle
    ((1, 512, 512, 32, 4, True, [0]),
     {"blocks": 32, "slots": 264, "makespan_tiles": 64,
      "tail_share": 1 - 32 * 36 / 264 / 64}),
    # every key masked: no block streams a tile
    ((2, 96, 96, 4, 2, True, [-1000, -1000]),
     {"blocks": 8, "slots": 264, "makespan_tiles": 0, "tail_share": 0.0}),
    # non-causal: every block streams all query tiles of its group
    ((2, 130, 200, 4, 2, False, [0, 0]),
     {"blocks": 16, "slots": 264, "makespan_tiles": 6,
      "tail_share": 1 - 16 * 6 / 264 / 6}),
])
def test_dkv_tail_model(case, want):
    b, sq, sk, hq, hkv, causal, offs = case
    got = _chip_smoke().dkv_tail(b, sq, sk, hq, hkv, causal, offs,
                                 DKV_TILING, sms=132)
    for key, value in want.items():
        assert got[key] == pytest.approx(value), key


@pytest.mark.parametrize("name", sorted(tune_flash_bwd.VARIANTS))
def test_tuning_variants_name_text_in_the_source(name):
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    for old in tune_flash_bwd.VARIANTS[name]:
        assert src.count(old) == 1, old


@pytest.mark.parametrize("name", sorted(tune_flash_fwd.VARIANTS))
def test_fwd_tuning_variants_name_text_in_the_source(name):
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    for old in tune_flash_fwd.VARIANTS[name]:
        assert src.count(old) == 1, old


def test_fwd_tuning_tile_variants_are_variants():
    assert set(tune_flash_fwd.TILE_VARIANTS) <= set(tune_flash_fwd.VARIANTS)


@pytest.mark.parametrize("tc_min_sq,want", [
    (2, {"sq1_below_threshold_d128": 1, "sq2_at_threshold_d128": 2}),
    (16, {"sq15_below_threshold_d128": 15, "sq16_at_threshold_d128": 16}),
    # no row count below one: only the case at the threshold
    (1, {"sq1_at_threshold_d128": 1}),
])
def test_threshold_cases_sit_at_the_dispatch_threshold(tc_min_sq, want):
    cs = _chip_smoke()
    got = cs.threshold_cases(tc_min_sq)
    assert {name: case[1] for name, case in got.items()} == want
    b, sk, hq, hkv, d = cs.THRESHOLD_SHAPE
    for b_, sq, sk_, hq_, hkv_, d_, causal, off, dt in got.values():
        # the rows sit at the end of the keys, as a decode chunk
        assert (b_, sk_, hq_, hkv_, d_, causal, dt) == (
            b, sk, hq, hkv, d, True, "bfloat16")
        assert off == sk - sq


@pytest.mark.parametrize("sq,sk,offs,causal", [
    (100, 100, [-30, 5, 64], True),   # per-row offsets, one row partly dead
    (40, 300, [100, 100], True),      # the diagonal inside the keys
    (96, 96, [-1000, -1000], True),   # every row dead
    (30, 70, [0, 0], False),
])
def test_forward_work_counts_visible_pairs(sq, sk, offs, causal):
    import torch

    hq, hkv, d = 8, 2, 64
    b = len(offs)
    flops, nbytes = _chip_smoke().work(
        torch, b, sq, sk, hq, hkv, d, causal,
        torch.tensor(offs, dtype=torch.int32), torch.bfloat16)
    pairs = sum(min(max(r + o + 1, 0), sk) if causal else sk
                for o in offs for r in range(sq)) * hq
    assert flops == 4.0 * d * pairs
    keys = sum(max((min(max(r + o + 1, 0), sk) if causal else sk)
                   for r in range(sq)) for o in offs)
    # q is read only for rows that see a key; o, lse and offsets always
    live = sum(1 for o in offs for r in range(sq)
               if not causal or r + o + 1 > 0)
    assert nbytes == ((live + b * sq) * hq * d * 2 + b * hq * sq * 4
                      + b * 4 + 2 * keys * hkv * d * 2)


@pytest.mark.parametrize("sq,sk,offs,causal", [
    (100, 100, [-30, 5, 64], True),   # per-row offsets, one row partly dead
    (40, 300, [100, 100], True),      # the diagonal inside the keys
    (96, 96, [-1000, -1000], True),   # every row dead
    (30, 70, [0, 0], False),
])
def test_backward_work_counts_visible_pairs(sq, sk, offs, causal):
    """dq reads o and do and writes dq and delta for every row, q and lse
    for rows that see a key; dkv and the whole backward read nothing of a
    row that sees no key and write dk and dv whole."""
    import torch

    hq, hkv, d = 8, 2, 64
    b = len(offs)
    pairs, nbytes = _chip_smoke().bwd_work(
        torch, b, sq, sk, hq, hkv, d, causal,
        torch.tensor(offs, dtype=torch.int32), torch.bfloat16)
    vis = [min(max(r + o + 1, 0), sk) if causal else sk
           for o in offs for r in range(sq)]
    assert pairs == sum(vis) * hq
    keys = sum(max(vis[i * sq:(i + 1) * sq]) for i in range(b))
    live = sum(1 for v in vis if v > 0)
    row, live_row = hq * d * 2, live * hq * d * 2     # bf16 [.., hq, d]
    kv, kv_out = keys * hkv * d * 2, b * sk * hkv * d * 2
    assert nbytes == {
        "dq": live_row + 3 * b * sq * row + 2 * kv + live * hq * 4
        + b * sq * hq * 4,
        "dkv": 2 * live_row + 2 * kv + 2 * live * hq * 4 + 2 * kv_out,
        "bwd": 3 * live_row + 2 * kv + live * hq * 4 + b * sq * row
        + 2 * kv_out,
    }


def test_forward_device_time_splits_by_kernel_namespace():
    per_kernel = {
        "void (anonymous namespace)::tcb::flash_fwd_kernel<64>((anonymous "
        "namespace)::Params)": 13.0,
        "void (anonymous namespace)::simt::flash_fwd_kernel<128>((anonymous "
        "namespace)::Params)": 1.25,
        "void (anonymous namespace)::tcb::flash_bwd_dq_kernel<64>((anonymous "
        "namespace)::Params)": 9.0,
        "void (anonymous namespace)::dec::flash_fwd_kernel<128>((anonymous "
        "namespace)::Params)": 0.5,
        "void (anonymous namespace)::dec::flash_fwd_combine_kernel<128>("
        "(anonymous namespace)::Params)": 0.125,
        "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT": 33.0,
    }
    assert _chip_smoke().fwd_ms_by_kernel(per_kernel) == {
        "tcb": 13.0, "dec": 0.625, "simt": 1.25}


def test_headline_cases_name_kernel_cases_of_their_kernel():
    """Each kernel's headline case is a case of the kernel phase whose
    shape that kernel takes: dec bf16 single rows, simt float32, tcb bf16
    from 2 rows."""
    cs = _chip_smoke()
    assert set(cs.HEADLINE_CASES) == {"tcb", "dec", "simt"}
    for kern, name in cs.HEADLINE_CASES.items():
        assert name in cs.KERNEL_CASES, name
        _, sq, _, _, _, _, _, _, dt = cs.KERNEL_CASES[name]
        assert (dt == "float32") == (kern == "simt")
        if kern != "simt":
            assert (sq == 1) == (kern == "dec")
