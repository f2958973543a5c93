"""Time tilings of the bf16 forward kernels (tensor-core and split-KV
decode), and where each overtakes the others, on one GPU.

    python3 -m ray_tpu_torch.tools.tune_flash_fwd [--jsonl PATH]

Builds ``csrc/flash_fwd.cu`` once per variant, each a text substitution in
its ``tcb::Cfg`` tile sizes, dec's stage count or the dispatch, all nvcc
processes at once. Then:
- tiles: at the 1b train shape (b 4, s 2048, 32/4 heads, d 64), at 7b's
  d 128 (b 1, s 2048, 32/32 heads) and at 7b prefill (b 1, s 512), each
  tiling variant's forward is checked against the plain version (o, lse)
  and timed by CUDA-graph replay, in the order of the list and then
  reversed;
- decode: at the serve path's decode shapes (DECODE_SHAPES), dec's stage
  and launch variants at the shipped split rule, the split rules
  (SPLIT_RULES: blocks per SM aimed at, fewest tiles per chunk, no split;
  each rule's split count is passed to ``flash_fwd(splits=...)``) on the
  shipped build, and the tensor-core kernel ("all_tcb"), in order and then
  reversed;
- crossover: at bf16, d 128, 32/32 heads, b 8 and s_k 1024, with the query
  rows at the end of the keys (offset s_k - s_q, as a cached prefill or a
  decode chunk), "all_tcb" (every bf16 call to the tensor-core kernel) and
  "dec" (dec up to 16 rows, the evidence for DEC_MAX_SQ) are timed at s_q
  in CROSSOVER_SQ, in turns.
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

# name: {text in csrc/flash_fwd.cu: replacement}
VARIANTS = {
    "shipped": {},
    # 8 warps of 16 rows (at d 16 a 64-key tile has fewer 16-byte chunks
    # than 256 threads)
    "rows128": {"static constexpr int ROWS = 64;":
                "static constexpr int ROWS = D >= 64 ? 128 : 64;"},
    "keys128_d64": {"static constexpr int KEYS = 64;":
                    "static constexpr int KEYS = D == 64 ? 128 : 64;"},
    "keys32_d128": {"static constexpr int KEYS = 64;":
                    "static constexpr int KEYS = D == 128 ? 32 : 64;"},
    # 4 blocks an SM at d 64: at most 128 registers a thread
    "4blocks_d64": {"__launch_bounds__(Cfg<D>::THREADS)":
                    "__launch_bounds__(Cfg<D>::THREADS, D == 64 ? 4 : 1)"},
    # dec: K/V tiles in flight
    "dec_stages2": {"constexpr int STAGES = 3;": "constexpr int STAGES = 2;"},
    "dec_stages4": {"constexpr int STAGES = 3;": "constexpr int STAGES = 4;"},
    # dec's merge launched after the kernel drains, not as its dependent
    "dec_no_pdl": {"constexpr int PDL = 1;": "constexpr int PDL = 0;"},
    # the dispatch: every bf16 call to the tensor-core kernel, or dec up
    # to 16 rows
    "all_tcb": {"sq <= DEC_MAX_SQ && sq * group <= dec::ROWS": "false"},
    "dec": {"constexpr int DEC_MAX_SQ = 1;": "constexpr int DEC_MAX_SQ = 16;"},
}
TILE_VARIANTS = ("shipped", "rows128", "keys128_d64", "keys32_d128",
                 "4blocks_d64")
STAGE_VARIANTS = ("shipped", "dec_stages2", "dec_stages4", "dec_no_pdl")
# name: (b, sq, sk, hq, hkv, d, offsets); None: per-row positions drawn in
# [1, sk - 1], as chip_smoke.py's decode cases
DECODE_SHAPES = {"decode_7b_b1": (1, 1, 1024, 32, 32, 128, [700]),
                 "decode_7b_b8": (8, 1, 1024, 32, 32, 128, None),
                 "decode_1b_gqa_b8": (8, 1, 1024, 32, 4, 64, None),
                 "decode_7b_b1_s4096": (1, 1, 4096, 32, 32, 128, [4095])}
# the split rules beside flash.decode_splits ("shipped"): name: (blocks
# per SM aimed at, fewest whole key tiles per chunk), the two numbers
# decode_splits takes from DEC_BLOCKS_PER_SM and DEC_MIN_CHUNK_TILES;
# "unsplit" is one chunk
SPLIT_RULES = {"chunk2": (1, 2), "chunk3": (1, 3), "chunk8": (1, 8),
               "per_sm2_chunk1": (2, 1), "per_sm2": (2, 4), "unsplit": None}
SHAPES = {"train_1b_d64_gqa": (4, 2048, 2048, 32, 4, 64),
          "train_7b_d128": (1, 2048, 2048, 32, 32, 128),
          "prefill_7b": (1, 512, 512, 32, 32, 128)}
CROSSOVER_SQ = (1, 2, 4, 8, 16, 32, 64)
CROSSOVER_SHAPE = (8, 1024, 32, 32, 128)   # b, sk, hq, hkv, d


def _inputs(g, b, sq, sk, hq, hkv, d):
    rnd = lambda *s: torch.randn(s, generator=g,
                                 device="cuda").to(torch.bfloat16)
    return rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)


def _splits(b, hkv, sk, sms, rule):
    """The split count of a SPLIT_RULES rule, reckoned as
    flash.decode_splits reckons its own: enough chunks for the grid of
    b * hkv * splits blocks to reach the blocks aimed at on ``sms`` SMs,
    unless chunks would fall below the fewest tiles; none empty."""
    if rule is None:
        return 1
    per_sm, min_tiles = rule
    tiles = -(-sk // flash.DEC_KEY_TILE)
    want = -(-per_sm * sms // (b * hkv))
    splits = -(-tiles // max(1, min_tiles, tiles // want))
    flash.decode_chunk(sk, splits)   # raises for a count the kernel refuses
    return splits


def _errors(o, lse, ro, rlse):
    return {"o_max_abs": float((o.float() - ro.float()).abs().max()),
            "lse_max_abs": float((lse - rlse).abs().max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jsonl", type=Path, default=None,
                    help="also append every line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_flash_fwd: no CUDA device")
    emit = emitter(args.jsonl)
    emit({"nvidia_smi": nvidia_smi()})
    libs = build_variants("flash_fwd", VARIANTS, Path(tempfile.mkdtemp()))
    for name, (*_, regs) in libs.items():
        emit({"variant": name, "ptxas": regs})
    shipped = flash._kernel_fns("flash_fwd")
    g = torch.Generator(device="cuda").manual_seed(4321)

    def run(name, q, k, v, offs, splits=None):
        flash._fns["flash_fwd"] = libs[name][:3]
        return flash.flash_fwd(q, k, v, offs, splits=splits)

    try:
        for shape, (b, sq, sk, hq, hkv, d) in SHAPES.items():
            q, k, v = _inputs(g, b, sq, sk, hq, hkv, d)
            offs = torch.zeros((b,), dtype=torch.int32, device="cuda")
            ro, rlse = flash.flash_fwd_reference(q, k, v, offs)
            order = list(TILE_VARIANTS)
            for rep, names in enumerate((order, order[::-1])):
                for name in names:
                    o, lse = run(name, q, k, v, offs)
                    emit({"shape": shape, "pass": rep, "variant": name,
                          "ms": device_ms(lambda: run(name, q, k, v, offs)),
                          "err": _errors(o, lse, ro, rlse)})
            del q, k, v, ro, rlse, o, lse
            torch.cuda.empty_cache()

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for shape, (b, sq, sk, hq, hkv, d, off) in DECODE_SHAPES.items():
            q, k, v = _inputs(g, b, sq, sk, hq, hkv, d)
            offs = (torch.randint(1, sk, (b,), generator=g, device="cuda",
                                  dtype=torch.int32) if off is None else
                    torch.tensor(off, dtype=torch.int32, device="cuda"))
            ro, rlse = flash.flash_fwd_reference(q, k, v, offs)
            rules = {"shipped": flash.decode_splits(b, hkv, sk, sms)[0],
                     **{name: _splits(b, hkv, sk, sms, rule)
                        for name, rule in SPLIT_RULES.items()}}
            # (variant, split rule); the tensor-core kernel takes no splits
            runs = ([(name, "shipped") for name in STAGE_VARIANTS]
                    + [("shipped", rule) for rule in SPLIT_RULES]
                    + [("all_tcb", None)])
            for rep, order in enumerate((runs, runs[::-1])):
                for name, rule in order:
                    n = rules.get(rule)
                    o, lse = run(name, q, k, v, offs, n)
                    emit({"decode_shape": shape, "pass": rep,
                          "variant": name, "split_rule": rule,
                          "splits": n, "offsets": offs.tolist(),
                          "ms": device_ms(
                              lambda: run(name, q, k, v, offs, n), 20),
                          "err": _errors(o, lse, ro, rlse)})
            del q, k, v, ro, rlse, o, lse
            torch.cuda.empty_cache()

        b, sk, hq, hkv, d = CROSSOVER_SHAPE
        for sq in CROSSOVER_SQ:
            q, k, v = _inputs(g, b, sq, sk, hq, hkv, d)
            offs = torch.full((b,), sk - sq, dtype=torch.int32, device="cuda")
            ro, rlse = flash.flash_fwd_reference(q, k, v, offs)
            for rep, name in enumerate(("all_tcb", "dec", "dec", "all_tcb")):
                o, lse = run(name, q, k, v, offs)
                emit({"crossover_sq": sq, "pass": rep, "variant": name,
                      "shape": {"b": b, "sk": sk, "hq": hq, "hkv": hkv,
                                "d": d, "offset": sk - sq},
                      "ms": device_ms(lambda: run(name, q, k, v, offs), 20),
                      "err": _errors(o, lse, ro, rlse)})
    finally:
        flash._fns["flash_fwd"] = shipped
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
