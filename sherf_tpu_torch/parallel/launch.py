"""Start a world of ranks on this machine: ``run_local(fn, world, args)``
runs ``fn(rank, world, *args)`` in ``world`` fresh processes (the
``spawn`` start method: no state is inherited) and waits for them.

Each rank runs with ``LOCAL_RANK`` = its rank and ``LOCAL_WORLD_SIZE`` =
``world`` in its environment (every rank is on this host, which is what
``multihost.choose_backend`` and ``rank_device`` read).  Each rank is
expected to join the process group itself, e.g. through
``maybe_initialize_distributed(coordinator="file://<path>", ...)``: a
``file://`` store under a private directory needs no port.  A rank that
does not finish within ``timeout_s`` is killed with the others, so a hang
becomes a failure and no process is left behind.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import Callable, List, Sequence


def _rank_main(fn: Callable, rank: int, world: int, args: Sequence) -> None:
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    fn(rank, world, *args)


def run_local(fn: Callable, world: int, args: Sequence = (),
              timeout_s: float = 120.0) -> List[int]:
    """The ranks' exit codes (0 each on success; None for one killed at
    the timeout).  ``fn`` and ``args`` must pickle (a module-level
    function)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, rank, world, args),
                         daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
            if p.exitcode not in (None, 0):
                break           # a rank failed: do not wait out the rest
    finally:
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return codes
