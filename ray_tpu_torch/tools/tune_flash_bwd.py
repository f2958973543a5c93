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
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from ray_tpu_torch.ops import _build, flash

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


def device_ms(fn, iters=10):
    """Device time per call: ``iters`` calls in one CUDA graph, replayed
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def build_variants(out_dir: Path):
    """{name: (launch, error_string, ptxas summary)}, one library each."""
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    for header in _build.CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in flash_bwd.cu")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
               str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{err}")
        regs = {k: v for k, v in _build.ptxas_summary(err).items()
                if k.startswith("tcb::")}
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        launch = lib.rtt_flash_bwd
        launch.argtypes = flash._LAUNCH["flash_bwd"][1]
        launch.restype = ctypes.c_int
        lib.rtt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rtt_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = (launch, lib.rtt_cuda_error_string, regs)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jsonl", type=Path, default=None,
                    help="also append every line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_flash_bwd: no CUDA device")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.jsonl is not None:
            with args.jsonl.open("a") as f:
                f.write(line + "\n")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"nvidia_smi": smi})
    libs = build_variants(Path(tempfile.mkdtemp()))
    for name, (_, _, regs) in libs.items():
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
                    flash._fns["flash_bwd"] = libs[name][:2]
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
