"""Where the engine benches put their artifact: the path in their
``RT_*_BENCH_OUT`` knob, or stdout.

The JAX package's scripts write committed ``BENCH_*.json`` files by
default; the port's tools have no default path and refuse to write a file
of that name, so a run of a tool never rewrites one of the JAX-era
artifacts."""

from __future__ import annotations

import fnmatch
import json
import os
from typing import Any, Dict, Optional


def check_out(out: Optional[str], prog: str) -> None:
    """Refuse, before any work, an ``out`` named like ``BENCH_*.json``."""
    if out not in (None, "-") and fnmatch.fnmatch(os.path.basename(out),
                                                  "BENCH_*.json"):
        raise SystemExit(f"{prog}: refusing to write {out}: BENCH_*.json "
                         f"files are the JAX package's committed artifacts")


def write_artifact(artifact: Dict[str, Any], out: Optional[str],
                   prog: str) -> None:
    """``artifact`` as sorted JSON to ``out``, or to stdout when ``out`` is
    None or ``-``."""
    check_out(out, prog)
    text = json.dumps(artifact, indent=1, sort_keys=True)
    if out in (None, "-"):
        print(text, flush=True)
        return
    with open(out, "w", encoding="utf-8") as f:
        f.write(text + "\n")
    print(f"artifact -> {out}", flush=True)
