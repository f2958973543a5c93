"""The host-side helpers of the card runs, on the CPU: the build's ptxas
summary (``chip_smoke.py`` fails a run on any register spill in it),
``chip_smoke.py``'s model of the dkv grid's scheduling tail, and the tuning
script's variants, each of which must still name text in
``csrc/flash_bwd.cu``."""

import importlib.util
import pathlib

import pytest

from ray_tpu_torch.ops import _build
from ray_tpu_torch.tools import tune_flash_bwd

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
