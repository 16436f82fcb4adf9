"""The device work of a call, read from ``torch.profiler``: used by
``chip_smoke.py``, the card tests and ``ray_cluster_probe.py``."""

from __future__ import annotations

import time

import torch

# profiler windows taken before one that kept all of its events is given up
WINDOWS = 5
# seconds the host waits at the start of each profiler step, before the
# calls: a window that keeps only its last calls' events (2 of 20) was seen
# three times in a row in one process, as if the collection started late
SETTLE_S = 0.05


def device_work(fn, reps: int = 20) -> dict:
    """The device work of one call of ``fn``: per call, the device
    operations (kernels, memsets, copies) by name, each with its count and
    ms (no launch gaps), and their total count.  The profiler's first
    window is a warm-up (it can miss the first call's events) and only the
    second is read; each step starts after ``SETTLE_S`` of host sleep; a
    window that lost events (none at all, or a count that is not a whole
    number of calls) is taken again, up to ``WINDOWS`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(SETTLE_S)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ev = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]
        if ev and all(e.count % reps == 0 for e in ev):
            break
    ops = {e.key: {"per_call": e.count / reps,
                   "ms": e.self_device_time_total / 1e3 / reps} for e in ev}
    return {"ops": ops,
            "ops_per_call": sum(o["per_call"] for o in ops.values())}
