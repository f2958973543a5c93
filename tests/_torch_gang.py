"""A gang of gloo ranks on the CPU for the port's sharded tests.

``start(case, world, tmp_path, limit_s, **args)`` launches one process
(this file as a script) that imports torch and the port once and forks
``world`` ranks. Each rank runs on one thread, joins a gloo group through
a ``file://`` store under ``tmp_path`` (no fixed port) with a timeout,
runs ``CASES[case](rank, world, args)`` and saves what it returns to
``tmp_path/rank<r>.pt``. The ranks run at a lower priority (nice 5),
so a gang yields cores to the other tests of a parallel run. A rank that
fails makes the launcher kill the others (they would wait in a
collective); ``Gang.result`` waits
``limit_s`` and then kills the whole process group. The ranks import
neither jax nor ``ray_tpu``: the tests compute the JAX side themselves,
while the gang runs.

The cases live in ``_torch_gang_cases.py``.
"""

from __future__ import annotations

import itertools
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
_SERIAL = itertools.count()


class Gang:
    def __init__(self, proc: subprocess.Popen, out: pathlib.Path,
                 world: int, limit_s: float):
        self.proc, self.out, self.world = proc, out, world
        self.deadline = time.monotonic() + limit_s
        self.limit_s = limit_s

    def result(self) -> list:
        """Each rank's returned value, by rank; raises (with the gang's
        output) if it failed or ran past its limit."""
        try:
            out, _ = self.proc.communicate(
                timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            out, _ = self.proc.communicate()
            raise AssertionError(f"gang passed its {self.limit_s} s limit:"
                                 f"\n{out[-4000:]}")
        if self.proc.returncode != 0:
            raise AssertionError(f"gang failed (rc {self.proc.returncode})"
                                 f":\n{out[-6000:]}")
        import torch

        return [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def start(case: str, world: int, tmp_path, limit_s: float = 90.0,
          **args) -> Gang:
    out = pathlib.Path(tmp_path) / f"gang-{case}-{world}-{next(_SERIAL)}"
    out.mkdir(parents=True)
    spec = {"case": case, "world": world, "out": str(out),
            "limit_s": limit_s, "args": args}
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         json.dumps(spec)], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    return Gang(proc, out, world, limit_s)


def _rank_main(rank: int, spec: dict) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    import _torch_gang_cases as cases

    torch.set_num_threads(1)
    store = pathlib.Path(spec["out"]) / "store"
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec["limit_s"]))
    try:
        got = cases.CASES[spec["case"]](rank, spec["world"], spec["args"])
        torch.save(got, pathlib.Path(spec["out"]) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _launch(spec: dict) -> int:
    """Fork the ranks from a process that has imported everything they
    need; return 0 when all of them succeed."""
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import torch
    # imported once, here, not by each rank
    import torch.distributed.tensor  # noqa: F401
    import torch.distributed.tensor.experimental  # noqa: F401

    import _torch_gang_cases  # noqa: F401

    torch.set_num_threads(1)
    # a gang is up to 8 busy processes: it yields cores to the other
    # tests of a parallel run
    os.nice(5)
    store = pathlib.Path(spec["out"]) / "store"
    if store.exists():
        store.unlink()
    pids = {}
    for rank in range(spec["world"]):
        pid = os.fork()
        if pid == 0:
            code = 0
            try:
                _rank_main(rank, spec)
            except BaseException:   # noqa: BLE001 — reported, then exit 1
                import traceback

                traceback.print_exc()
                code = 1
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
        pids[pid] = rank
    rc = 0
    while pids:
        pid, status = os.wait()
        rank = pids.pop(pid)
        if status != 0:
            print(f"rank {rank} exited with status {status}", flush=True)
            rc = 1
            for other in pids:
                os.kill(other, signal.SIGKILL)
    return rc


if __name__ == "__main__":
    sys.exit(_launch(json.loads(sys.argv[1])))
