"""Live stack capture: the py-spy-equivalent observability surface.

Reference analog: ``dashboard/modules/reporter/profile_manager.py`` shells
out to py-spy for stack/flamegraph captures of worker processes. Redesign:
workers are cooperating Python processes with RPC servers already, so the
dashboard asks each worker to snapshot ``sys._current_frames()`` in-process
— no ptrace, no external binary, works in containers that forbid
SYS_PTRACE. The trade-off vs py-spy: a worker wedged in a C extension
without releasing the GIL can't respond; its entry reports unreachable
(the signal that you need SIGUSR1/faulthandler — which workers also
register — or a real profiler).
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Dict


def format_current_stacks() -> str:
    """All threads of THIS process, python-traceback formatted."""
    names: Dict[int, str] = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
    return "\n".join(out)
