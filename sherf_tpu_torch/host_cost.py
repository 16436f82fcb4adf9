"""Host cost of the port's CUDA wrappers at the frame's shapes.

For each wrapper at the production frame's shapes (compact_mask at the
frame's six (n, cap, survivors) calls; ray_body_mask at 262,144 rays and
SMPL's 6,890 vertices; the public clustered wrappers nn_1_clustered and
nn_1_shortlist at the point-budget call's 417,792 queries, 111,899 of them
the budget's padding parked 1e6 m away, and ray_body_mask_clustered at the
frame's rays in the frame's layout: the origins a view at strides (1, N),
as the batch stores them), with inputs made from a seed:

* ``host_ms``: median host time for one call to return, started with the
  card idle.  This covers the wrapper's checks and allocations, the C entry
  point's queries, the memsets and the launches.
* ``back_to_back_ms``: time per call of calls issued back to back and
  synchronised once.  Where the device work is shorter than the host's,
  this is the host's rate.
* ``device_ops``: for the clustered wrappers, the device operations
  (kernels, memsets, copies) a call issues, from the profiler.

``--root DIR`` imports ``sherf_tpu_torch`` from the checkout at DIR, so two
versions of the wrappers can be timed on one card, one process each:

    python sherf_tpu_torch/host_cost.py --root .
    python sherf_tpu_torch/host_cost.py --root /path/to/other/checkout

Prints one JSON line. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# the frame's compact_mask calls at batch 1: (n, cap, survivors)
FRAME_COMPACT_CALLS = ((262_144, 24_576, 16_094), (1_179_648, 417_792, 305_893),
                       (417_792, 180_224, 157_000), (55_120, 21_248, 19_125),
                       (169_984, 13_568, 12_330), (108_544, 4_096, 3_564))
FRAME_RAYS, SMPL_VERTICES, ACTIVE_SHARE = 262_144, 6_890, 0.705
# the point-budget KNN: queries, of which the tail is the budget's padding
POINT_QUERIES, POINT_SURVIVORS = 417_792, 305_893


def times(fn, torch, reps):
    """(median host ms of one call with the card idle, ms per call back
    to back), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        fn()
        host.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return statistics.median(host), (time.perf_counter() - ts) * 1e3 / reps


def device_ops(fn, torch, reps=10):
    """Device operations a call of ``fn`` issues, from the profiler (the
    first window is a warm-up, the second is read)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return sum(e.count for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # run as a file, its own directory heads sys.path: import the package
    # from the root instead
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path = [os.path.abspath(args.root)] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("host_cost: needs a CUDA device")
    from sherf_tpu_torch.kernels import compaction, knn, knn_cluster

    dev = torch.device("cuda")
    rng = np.random.RandomState(args.seed)
    out = {"root": os.path.abspath(args.root),
           "package": os.path.dirname(compaction.__file__),
           "device": torch.cuda.get_device_name(0), "compact_mask": []}
    for n, cap, s in FRAME_COMPACT_CALLS:
        m = np.zeros(n, bool)
        m[rng.choice(n, s, replace=False)] = True
        mask = torch.from_numpy(m).to(dev)
        host_ms, b2b_ms = times(
            lambda: compaction.compact_mask_cuda(mask, cap), torch, args.reps)
        out["compact_mask"].append({"n": n, "cap": cap, "survivors": s,
                                    "host_ms": host_ms,
                                    "back_to_back_ms": b2b_ms})

    n = FRAME_RAYS
    v = (rng.randn(SMPL_VERTICES, 3) * [0.3, 0.6, 0.15]
         + [0.1, 0.2, 2.0]).astype(np.float32)
    o = np.tile(np.asarray([[0.1, 0.2, -1.0]], np.float32), (n, 1))
    d = (v[rng.randint(0, len(v), n)] + rng.randn(n, 3) * 0.2 - o)
    o_c, v_c = knn._centre(torch.from_numpy(o).to(dev),
                           torch.from_numpy(v).to(dev))
    d_t = torch.from_numpy(d.astype(np.float32)).to(dev)
    act = torch.zeros(n, dtype=torch.bool, device=dev)
    act[:int(n * ACTIVE_SHARE)] = True
    thr = (0.05 + 1e-3) ** 2
    host_ms, b2b_ms = times(
        lambda: knn.ray_body_mask_cuda(o_c, d_t, v_c, thr, act), torch,
        args.reps // 4)
    out["ray_body_mask"] = {"n": n, "vertices": SMPL_VERTICES,
                            "active": int(act.sum()), "host_ms": host_ms,
                            "back_to_back_ms": b2b_ms}

    v_t = torch.from_numpy(v).to(dev)
    o_t = torch.from_numpy(np.ascontiguousarray(o.T)).to(dev).t()
    q = np.full((POINT_QUERIES, 3), 1e6, np.float32)
    q[:POINT_SURVIVORS] = (v[rng.randint(0, len(v), POINT_SURVIVORS)]
                           + rng.randn(POINT_SURVIVORS, 3) * 0.03)
    q_t = torch.from_numpy(q).to(dev)
    thr = (0.05 + 1e-3) ** 2
    for key, fn in (
            ("nn_1_clustered", lambda: knn_cluster.nn_1_clustered(q_t, v_t)),
            ("nn_1_shortlist", lambda: knn_cluster.nn_1_shortlist(q_t, v_t)),
            ("ray_body_mask_clustered",
             lambda: knn_cluster.ray_body_mask_clustered(o_t, d_t, v_t, thr))):
        host_ms, b2b_ms = times(fn, torch, args.reps // 4)
        out[key] = {"host_ms": host_ms, "back_to_back_ms": b2b_ms,
                    "device_ops": device_ops(fn, torch)}
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["nvidia_smi"] = None
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
