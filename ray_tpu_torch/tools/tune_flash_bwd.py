"""Time tilings of the bf16 backward kernels on one GPU.

    python3 -m ray_tpu_torch.tools.tune_flash_bwd [--jsonl PATH]

Builds ``csrc/flash_bwd.cu`` once per variant, each a text substitution in
its ``tcb::Cfg`` tile sizes or launch bounds, all nvcc processes at once.
Then, at the 1b train shape (b 4, s 2048, 32/4 heads, d 64) and at 7b's
d 128 (b 1, s 2048, 32/32 heads), each variant's dq and dkv kernels are
checked against the plain versions (max |g - plain| / max |plain|) and
timed by CUDA-graph replay, in the order of the list and then reversed.
Prints one JSON line per variant build (registers, spills) and per timing.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import torch

from ray_tpu_torch.ops import flash
from ray_tpu_torch.tools._tune import (build_variants, device_ms, emitter,
                                       nvidia_smi)

# name: {text in csrc/flash_bwd.cu: replacement}
VARIANTS = {
    "shipped": {},
    "dq_rows128_d64": {
        "static constexpr int DQ_ROWS = 64;":
            "static constexpr int DQ_ROWS = D == 64 ? 128 : 64;"},
    "dq_keys32_4blocks_d64": {
        "static constexpr int DQ_KEYS = 64;":
            "static constexpr int DQ_KEYS = D == 64 ? 32 : 64;",
        "__launch_bounds__(Cfg<D>::DQ_THREADS)":
            "__launch_bounds__(Cfg<D>::DQ_THREADS, D == 64 ? 4 : 1)"},
    "dkv_keys128_d64": {
        "static constexpr int DKV_KEYS = 64;":
            "static constexpr int DKV_KEYS = D == 64 ? 128 : 64;"},
    "dkv_queries32_d64": {
        "static constexpr int DKV_QUERIES = D >= 128 ? 32 : 64;":
            "static constexpr int DKV_QUERIES = D == 16 ? 64 : 32;"},
    "dkv_3blocks_d64": {
        "__launch_bounds__(Cfg<D>::DKV_THREADS)":
            "__launch_bounds__(Cfg<D>::DKV_THREADS, D == 64 ? 3 : 1)"},
    "dq_keys32_d128": {
        "static constexpr int DQ_KEYS = 64;":
            "static constexpr int DQ_KEYS = D == 128 ? 32 : 64;"},
    "dkv_queries64_d128": {
        "static constexpr int DKV_QUERIES = D >= 128 ? 32 : 64;":
            "static constexpr int DKV_QUERIES = 64;"},
}
SHAPES = {"train_1b_d64_gqa": (4, 2048, 2048, 32, 4, 64),
          "train_7b_d128": (1, 2048, 2048, 32, 32, 128)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jsonl", type=Path, default=None,
                    help="also append every line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_flash_bwd: no CUDA device")
    emit = emitter(args.jsonl)
    emit({"nvidia_smi": nvidia_smi()})
    libs = build_variants("flash_bwd", VARIANTS, Path(tempfile.mkdtemp()))
    for name, (*_, regs) in libs.items():
        emit({"variant": name, "ptxas": regs})
    shipped = flash._kernel_fns("flash_bwd")
    g = torch.Generator(device="cuda").manual_seed(4321)
    try:
        for shape, (b, sq, sk, hq, hkv, d) in SHAPES.items():
            rnd = lambda *s: torch.randn(s, generator=g,
                                         device="cuda").to(torch.bfloat16)
            q, k, v = rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
            do = rnd(b, sq, hq, d)
            offs = torch.zeros((b,), dtype=torch.int32, device="cuda")
            o, lse = flash.flash_fwd(q, k, v, offs)
            rdq, rdelta = flash.flash_dq_reference(q, k, v, o, lse, do, offs)
            rdk, rdv = flash.flash_dkv_reference(q, k, v, lse, rdelta, do,
                                                 offs)
            order = list(VARIANTS)
            for rep, names in enumerate((order, order[::-1])):
                for name in names:
                    flash._fns["flash_bwd"] = libs[name][:3]
                    dq, delta = flash.flash_dq(q, k, v, o, lse, do, offs)
                    dk, dv = flash.flash_dkv(q, k, v, lse, delta, do, offs)
                    rel = {n: float((x.float() - y.float()).abs().max()
                                    / y.float().abs().max())
                           for n, x, y in (("dq", dq, rdq), ("dk", dk, rdk),
                                           ("dv", dv, rdv))}
                    emit({"shape": shape, "pass": rep, "variant": name,
                          "dq_ms": device_ms(lambda: flash.flash_dq(
                              q, k, v, o, lse, do, offs)),
                          "dkv_ms": device_ms(lambda: flash.flash_dkv(
                              q, k, v, lse, delta, do, offs)),
                          "rel_err": rel})
            del q, k, v, do, o, lse, rdq, rdk, rdv, dq, dk, dv, delta, rdelta
            torch.cuda.empty_cache()
    finally:
        flash._fns["flash_bwd"] = shipped
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
