"""The spread of the pixel-PPO learning gate over runs and seeds.

    python3 -m ray_tpu_torch.tools.rl_gate_spread [--runs SEED:DET ...]
        [--iterations N] [--device cuda|cpu] [--jsonl PATH]

Trains PPO on ``CatchPixels-v0`` with JAX's test config
(``tests/test_rl_extras.py:73-98``, ``chip_smoke.py``'s pixel gate) once
per ``SEED:DET`` (``DET`` 1 sets ``torch.backends.cudnn.deterministic``
for that run) and prints one JSON line per run: the first iteration whose
windowed return reaches 0.2, the last return and the seconds. A last line
says, for each (seed, det) run twice, whether its returns repeated.
TF32 is off, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ray_tpu_torch.tools._tune import emitter, nvidia_smi

GATE = {"env": "CatchPixels-v0", "env_config": {"size": 12},
        "num_env_runners": 1, "num_envs_per_runner": 32,
        "rollout_fragment_length": 22, "lr": 2e-3, "num_epochs": 4,
        "minibatch_size": 176, "entropy_coeff": 0.02}
THRESHOLD = 0.2


def run_gate(seed: int, deterministic: bool, iterations: int,
             device: str) -> dict:
    from ray_tpu_torch.rl import train as rltrain

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        algo = rltrain.get_algorithm_config("PPO").update_from_dict(
            dict(GATE, seed=seed)).build(device=device)
        t0 = time.perf_counter()
        returns = [algo.train().get("episode_return_mean")
                   for _ in range(iterations)]
        seconds = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = before
    first = next((i + 1 for i, r in enumerate(returns)
                  if r is not None and r >= THRESHOLD), None)
    return {"seed": seed, "deterministic": deterministic, "device": device,
            "first_at_threshold": first, "last_return": returns[-1],
            "seconds": seconds, "returns": returns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", nargs="+", default=["0:0", "0:0", "0:1",
                                                   "0:1", "1:0", "2:0"])
    ap.add_argument("--iterations", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jsonl", type=Path, default=None,
                    help="also append every line to this file")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rl_gate_spread: no CUDA device")
    emit = emitter(args.jsonl)
    emit({"device": (nvidia_smi() if args.device == "cuda"
                     else "cpu")})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seen, repeats = {}, {}
    for spec in args.runs:
        seed, det = (int(x) for x in spec.split(":"))
        rec = run_gate(seed, bool(det), args.iterations, args.device)
        emit(rec)
        key = f"{seed}:{det}"
        if key in seen:
            repeats[key] = rec["returns"] == seen[key]
        seen[key] = rec["returns"]
    emit({"repeated": repeats})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
