"""``rt profile`` — run N steps of a preset under the step profiler (the
port's ``ray_tpu/scripts/profile.py``).

    python -m ray_tpu_torch.tools.profile --preset debug --mode train \\
        --steps 5 --batch 4 --seq 128 --device cpu
    python -m ray_tpu_torch.tools.profile --preset 7b --mode generate \\
        --new-tokens 32 --out trace.json --torch-trace traces/

Runs a few train, generate, speculative or stream steps of a Llama or MoE
preset (attention through the flash kernels; their plain versions on the
CPU) in this process with ``util/step_profiler.py`` enabled, and prints
the per-step table (wall / compile / dispatch / device sync, launches,
tokens/s, analytic MFU against the H100's bf16 peak, peak memory), the
steady-state summary and, for fused training, the launch amortization.
``--json`` writes the ``rt-profile-v1`` artifact with JAX's keys;
``--out`` the Perfetto timeline of the step records
(``util/timeline.py``); ``--torch-trace DIR`` a ``torch.profiler`` Chrome
trace (CPU and CUDA activities) of the run: the per-kernel device
timeline. The ``rt_step_*`` section prints the profiler's metric
observations and the ``rt_hbm_used_bytes`` gauges through a text sink.

JAX's tool runs under its cluster runtime (a probe task, the GCS event
store, the metrics registry), whose twins on the port's runtime are not
ported yet (ROADMAP item R5), so
``--address`` is refused, the profiler's state and the device's peak
memory are reset at the start of a run (as a fresh process would have
them), and the drain goes to sinks of this tool. The device is ``cuda`` unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch._device import resolve_device


def _find_preset(name: str):
    """Look the preset up across the model families (names are disjoint:
    llama 'debug'/'160m'/..., moe 'moe-debug'/'8x160m'/...), its attention
    through the flash kernels (``serve/llm.py`` builds presets so too;
    JAX's tool runs the presets' own plain attention)."""
    from ray_tpu_torch.models import llama, moe

    for presets in (llama.PRESETS, moe.PRESETS):
        if name in presets:
            return dataclasses.replace(presets[name], attn_impl="flash")
    known = sorted(list(llama.PRESETS) + list(moe.PRESETS))
    raise SystemExit(f"rt profile: unknown preset {name!r}; one of {known}")


def _fmt_table(records) -> str:
    head = (f"{'kind':<12} {'step':>4} {'wall ms':>9} {'compile ms':>11} "
            f"{'dispatch ms':>12} {'sync ms':>9} {'launches':>8} "
            f"{'st/ln':>6} {'tokens':>7} {'tok/s':>10} {'MFU':>7} "
            f"{'peak HBM MB':>12}")
    lines = [head, "-" * len(head)]
    for r in records:
        hbm = getattr(r, "hbm_peak_bytes", 0)
        hbm_col = f"{hbm / 1e6:>12.1f}" if hbm else f"{'-':>12}"
        spl = getattr(r, "steps", 1) / max(1, r.launches)
        lines.append(
            f"{r.kind:<12} {r.step:>4} {r.wall_s * 1e3:>9.2f} "
            f"{r.compile_s * 1e3:>11.2f} {r.dispatch_s * 1e3:>12.2f} "
            f"{r.execute_s * 1e3:>9.2f} {r.launches:>8} {spl:>6.1f} "
            f"{r.tokens:>7} {r.tokens_per_s:>10.1f} {r.mfu:>7.4f} {hbm_col}")
    return "\n".join(lines)


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _run_train(cfg, steps: int, batch: int, seq: int,
               steps_per_launch: int = 1, device=None) -> None:
    from ray_tpu_torch.parallel import train_step as ts

    device = resolve_device(device)
    optimizer = ts.default_optimizer(total_steps=max(steps, 101))
    params, opt_state = ts.init_state(cfg, optimizer,
                                      generator=_gen(device, 0),
                                      device=device)
    tokens = _gen(device, 1)
    if steps_per_launch > 1:
        # the product fast path: K steps fused per launch via StepDriver
        from ray_tpu_torch.train.driver import StepDriver

        driver = StepDriver(cfg, optimizer,
                            steps_per_launch=steps_per_launch,
                            device=device)
        batches = ({"tokens": torch.randint(
            0, cfg.vocab_size, (batch, seq + 1), generator=tokens,
            device=device)} for _ in range(steps))
        driver.run(params, opt_state, batches)
        return
    step = ts.make_train_step(cfg, optimizer, device=device)
    data = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                                    generator=tokens, device=device)}
    for _ in range(steps):
        params, opt_state, _ = step(params, opt_state, data)


def _run_generate(cfg, steps: int, batch: int, seq: int, new_tokens: int,
                  mode: str, device=None) -> None:
    from ray_tpu_torch.models import generate as G
    from ray_tpu_torch.parallel import train_step as ts

    device = resolve_device(device)
    fam = ts.model_family(cfg)
    params = fam.init_params(cfg, generator=_gen(device, 0), device=device)
    prompt = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=_gen(device, 1), device=device)
    if mode == "speculative":
        # draft = same family/vocab, half the layers: the stand-in for a
        # real small draft checkpoint
        draft_cfg = dataclasses.replace(
            cfg, n_layers=max(1, cfg.n_layers // 2))
        draft_params = fam.init_params(draft_cfg, generator=_gen(device, 2),
                                       device=device)
        for _ in range(steps):
            G.generate_speculative(params, draft_params, prompt, cfg,
                                   draft_cfg, max_new_tokens=new_tokens,
                                   device=device)
    elif mode == "stream":
        for _ in range(steps):
            for _tok in G.generate_stream(params, prompt, cfg,
                                          max_new_tokens=new_tokens,
                                          device=device):
                pass
    else:
        for _ in range(steps):
            G.generate(params, prompt, cfg, max_new_tokens=new_tokens,
                       device=device)


class TextMetrics:
    """A ``Sinks.metric`` that keeps each series by its tags and prints
    them in the Prometheus text form: a histogram's ``_count`` and
    ``_sum``, a counter's sum, a gauge's last value."""

    def __init__(self):
        self._series: Dict[tuple, Dict[str, float]] = {}

    def __call__(self, series: str, op: str, value: float,
                 tags: Dict[str, str]) -> None:
        key = (series, op, tuple(sorted(tags.items())))
        st = self._series.setdefault(key, {"count": 0, "sum": 0.0,
                                           "value": 0.0})
        st["count"] += 1
        st["sum"] += value
        st["value"] = value

    def lines(self) -> List[str]:
        out = []
        for (series, op, tags), st in sorted(self._series.items()):
            labels = ",".join(f'{k}="{v}"' for k, v in tags)
            if op == "observe":
                out.append(f"{series}_count{{{labels}}} {st['count']}")
                out.append(f"{series}_sum{{{labels}}} {st['sum']!r}")
            elif op == "inc":
                out.append(f"{series}{{{labels}}} {st['sum']!r}")
            else:
                out.append(f"{series}{{{labels}}} {st['value']!r}")
        return out


def _platform(device: torch.device) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"backend": "cuda", "devices": torch.cuda.device_count(),
                "name": torch.cuda.get_device_name(device)}
    return {"backend": device.type, "devices": 1, "name": device.type}


def _start_torch_trace(device: torch.device):
    """A started ``torch.profiler.profile`` with the CPU activity and, on
    a CUDA device, the CUDA one; None (and a message) if it cannot
    start."""
    try:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return prof
    except Exception as e:  # noqa: BLE001 — the analytic path still runs
        print(f"torch.profiler trace unavailable: {e!r}", file=sys.stderr)
        return None


def _stop_torch_trace(prof, trace_dir: str, name: str) -> Optional[str]:
    """Stop ``prof`` and export its Chrome trace into ``trace_dir``;
    returns the file's path, or None (and a message) on failure."""
    try:
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{name}.pt.trace.json")
        prof.export_chrome_trace(path)
        return path
    except Exception as e:  # noqa: BLE001 — the analytic path still ran
        print(f"torch.profiler trace not written: {e!r}", file=sys.stderr)
        return None


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="rt profile")
    parser.add_argument("--preset", default="debug",
                        help="model preset (llama or moe families)")
    parser.add_argument("--mode", default="train",
                        choices=("train", "generate", "speculative",
                                 "stream"))
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--steps-per-launch", type=int, default=1,
                        help="train mode: fuse K optimizer steps into one "
                             "launch (the product fast path)")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--new-tokens", type=int, default=16)
    parser.add_argument("--out", default=None,
                        help="write the Perfetto trace JSON here")
    parser.add_argument("--json", default=None, metavar="FILE",
                        help="write a machine-readable profile artifact "
                             "(records + summary + MFU/steps-per-launch) "
                             "here; '-' for stdout")
    parser.add_argument("--torch-trace", default=None, metavar="DIR",
                        help="also capture a torch.profiler trace (CPU "
                             "and CUDA activities) into DIR as a Chrome "
                             "trace: the per-kernel device timeline")
    parser.add_argument("--address", default=None,
                        help="attach to a running cluster (refused: "
                             "ROADMAP item R5)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without "
                             "a GPU unless 'cpu' is asked for)")
    parser.add_argument("--no-metrics", action="store_true",
                        help="skip the rt_step_* metrics section")
    args = parser.parse_args(argv)
    if args.address:
        raise SystemExit(
            "rt profile: --address attaches to a cluster, which needs the "
            "runtime's tooling the port has not ported yet (ROADMAP item "
            "R5); run without it to profile in this process")

    from ray_tpu_torch.util import step_profiler
    from ray_tpu_torch.util.memory import publish_hbm_gauges
    from ray_tpu_torch.util.recorder_core import Sinks
    from ray_tpu_torch.util.timeline import step_timeline

    device = resolve_device(args.device)
    cfg = _find_preset(args.preset)
    platform = _platform(device)
    # the records' peak-memory column is this run's
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step_profiler.reset()
    step_profiler.enable()
    try:
        prof = (_start_torch_trace(device) if args.torch_trace
                else None)
        try:
            if args.mode == "train":
                _run_train(cfg, args.steps, args.batch, args.seq,
                           args.steps_per_launch, device)
            else:
                _run_generate(cfg, args.steps, args.batch, args.seq,
                              args.new_tokens, args.mode, device)
        finally:
            if prof is not None:
                path = _stop_torch_trace(
                    prof, args.torch_trace,
                    f"rt-profile-{args.preset}-{args.mode}")
                if path:
                    print(f"torch.profiler device trace in {path}")

        records = step_profiler.records()
        events: List[Dict[str, Any]] = []
        metrics = TextMetrics()
        drained = step_profiler.drain(Sinks(
            metric=None if args.no_metrics else metrics,
            events=events.extend))
        print(f"# rt profile — preset={args.preset} mode={args.mode} "
              f"steps={args.steps} batch={args.batch} seq={args.seq} "
              f"platform={platform['backend']}x{platform['devices']}")
        print(_fmt_table(records))
        summ = step_profiler.summary()
        if summ:
            print(f"\nsteady-state: wall {summ['mean_wall_s'] * 1e3:.2f} ms"
                  f"/record, dispatch {summ['mean_dispatch_s'] * 1e3:.2f} ms, "
                  f"device sync {summ['mean_execute_s'] * 1e3:.2f} ms, "
                  f"compile total {summ['compile_s']:.2f} s, "
                  f"{summ['tokens_per_s']:.1f} tok/s, "
                  f"MFU {summ['mean_mfu']:.4f}")
            spl = summ.get("mean_steps_per_launch", 1.0)
            if spl > 1.0:
                # the launch-amortization line, reproduced from the
                # profile so the trace reads without the JSON
                print(f"launch amortization: {spl:.1f} steps/launch — "
                      f"per-launch dispatch "
                      f"{summ['mean_dispatch_s'] * 1e3:.2f} ms amortizes to "
                      f"{summ['mean_dispatch_s'] / spl * 1e3:.2f} ms/step; "
                      f"true per-step wall "
                      f"{summ['per_step_wall_s'] * 1e3:.2f} ms")
        print(f"drained {drained} step record(s) into the timeline")

        if args.json:
            payload = {
                "schema": "rt-profile-v1",
                "t": time.time(),
                "config": {"preset": args.preset, "mode": args.mode,
                           "steps": args.steps, "batch": args.batch,
                           "seq": args.seq, "new_tokens": args.new_tokens,
                           "steps_per_launch": args.steps_per_launch},
                "platform": platform,
                "records": [r.to_dict() for r in records],
                "summary": summ or {},
            }
            if args.json == "-":
                print(json.dumps(payload, indent=2, sort_keys=True))
            else:
                with open(args.json, "w") as f:
                    json.dump(payload, f, indent=2, sort_keys=True)
                    f.write("\n")
                print(f"wrote {args.json}: {len(records)} record(s) + "
                      f"summary")
        if args.out:
            trace = step_timeline(events, args.out)
            cats = sorted({t.get("cat") for t in trace})
            print(f"wrote {args.out}: {len(trace)} events, "
                  f"categories {cats}")
        if not args.no_metrics:
            publish_hbm_gauges(metrics)
            print("\n# rt_step_* metrics\n" + "\n".join(metrics.lines()))
        return 0
    finally:
        step_profiler.disable()


if __name__ == "__main__":
    sys.exit(main())
