"""Training statistics (torch counterpart of ``sherf_tpu/train/stats.py``):
running means per metric since the last flush, written as one
``stats.jsonl`` line per flush.  TensorBoard is not wired up.
"""

from __future__ import annotations

import json
import os
import resource
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class StatsCollector:
    """``run_dir`` None keeps the means without writing them (the ranks
    other than 0 of a multi-process run)."""

    def __init__(self, run_dir: Optional[str]):
        self.run_dir = run_dir
        self._jsonl = None
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self._jsonl = open(os.path.join(run_dir, "stats.jsonl"), "a")
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self.start_time = time.time()

    @property
    def pending(self) -> bool:
        """True when values were reported since the last flush."""
        return bool(self._counts)

    def report(self, metrics: Dict, prefix: str = "") -> None:
        """Add one value per metric (numbers or scalar tensors) to the
        running means."""
        for k, v in metrics.items():
            self._sums[prefix + k] += float(v)
            self._counts[prefix + k] += 1

    def flush(self, step: int) -> Dict[str, float]:
        """Write the means since the last flush as one line and reset."""
        means = {k: self._sums[k] / max(self._counts[k], 1) for k in self._sums}
        rec = {"step": int(step), "time": time.time() - self.start_time, **means}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        self._sums.clear()
        self._counts.clear()
        return means

    def report_resources(self) -> None:
        """Host peak RSS and, on a GPU, device memory in use and its peak."""
        res = {"cpu_mem_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            res["device_mem_gb"] = torch.cuda.memory_allocated() / 2 ** 30
            res["device_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        self.report(res, prefix="Resources/")

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
