"""Queries a lane of the clustered nearest-vertex kernels, swept on the
frame's point-budget KNN.

``nn_1_clustered`` and ``nn_1_shortlist`` (``csrc/knn_cluster.cu``) hold
``kQ`` queries in each lane, so a warp takes a unit of 32 * kQ queries and
takes its visit decisions for all of them.  This script builds the kernel
library once for each kQ in 1, 2, 4 (the source with that constant, into
``sherf_tpu_torch/_build/sweep/``), and on the production frame's
point-budget call (512x512x48, bf16, calibrated budgets, random weights
from seed 0, the knn shortlist on) reports for each:

* ``equal``: each kernel bit-equal to its plain version at the plain
  version's grain set to the same 32 * kQ;
* ``*_ms``: CUDA-event medians of each kernel on the call's queries
  (``x1``), and on its real queries (the budget's padding cut off)
  repeated 4 and 8 times, which gives the dynamic scheduler enough units
  to balance (``x4``, ``x8``);
* ``union_pairs``: the (query, vertex) pairs B5 scans at that grain, each
  unit's clusters times its queries (plain torch).

Needs a CUDA device and nvcc; prints one JSON line.

    python sherf_tpu_torch/cluster_sweep.py
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys

QS = (1, 2, 4)
MARGIN = 1.15


def cuda_ms(fn, torch, iters=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def frame_query(torch, dev):
    """The raw (query, ref) of the frame's point-budget nn_1_shortlist."""
    from sherf_tpu_torch.core.calibrate import (calibrate_budgets,
                                                calibrate_sparse_caps)
    from sherf_tpu_torch.core.config import ModelConfig, RenderConfig
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch
    from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
    from sherf_tpu_torch.kernels import knn_cluster as kc
    from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
    from sherf_tpu_torch.smpl import big_pose_params, smpl_forward, synthetic_smpl
    smpl = synthetic_smpl(0, device="cpu")
    bp = big_pose_params()
    with torch.no_grad():
        verts = smpl_forward(smpl, torch.from_numpy(bp["poses"]),
                             torch.from_numpy(bp["shapes"]))[0].numpy()
    cfg = ModelConfig(compute_dtype="bfloat16", render=RenderConfig(
        depth_resolution=48, density_noise=0.0))
    _, out_sh = prepare_voxel_volume(verts, voxel_size=cfg.voxel_size)
    cfg = dataclasses.replace(cfg, sparse_caps=calibrate_sparse_caps(
        [verts], cfg.voxel_size))
    batch = make_synthetic_batch(smpl, batch_size=1, H=512, W=512, seed=0,
                                 device=dev)
    fitted, _ = calibrate_budgets([batch], cfg, margin=MARGIN)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        fitted, knn_shortlist=8))
    model = SHERFGenerator(cfg, out_sh=out_sh, device=dev).eval()
    random_init_(model, torch.Generator().manual_seed(0))
    seen = []
    real = kc.nn_1_shortlist

    def spy(query, ref, s_cap=0):
        seen.append((query, ref))
        return real(query, ref, s_cap)
    kc.nn_1_shortlist, was = spy, kc.CLUSTERED
    kc.CLUSTERED = True
    try:
        with torch.inference_mode():
            model(batch, smpl.to(dev))
    finally:
        kc.nn_1_shortlist, kc.CLUSTERED = real, was
    return seen[0]


def build_variant(q: int):
    """The kernel library with kQ = q, loaded with the package's bindings."""
    from sherf_tpu_torch.kernels import _cuda
    src = (_cuda.CSRC / "knn_cluster.cu").read_text()
    line = "constexpr int kQ = "
    head, tail = src.split(line, 1)
    src = head + line + f"{q};" + tail.split(";", 1)[1]
    out = _cuda.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"knn_cluster_q{q}.cu", out / f"libsweep_q{q}.so"
    cu.write_text(src)
    others = [str(s) for s in _cuda._sources() if s.name != "knn_cluster.cu"]
    proc = subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS,
                           f"-I{_cuda.CSRC}", "-o", str(so), str(cu), *others],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for kQ = {q}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _cuda._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def union_pairs(q_c, cl, grain, kc, torch):
    """Pairs B5 scans when each group of ``grain`` queries visits the union
    of its queries' admitted clusters."""
    n, units = q_c.shape[0], -(-q_c.shape[0] // grain)
    dc = kc._centroid_dist(q_c, cl.cent)
    b = (((dc + cl.rad) * (dc + cl.rad)).amin(dim=1)
         * kc._f32(1.0 + 1e-5, q_c) + kc._f32(1e-12, q_c))
    total = 0
    for c in range(cl.cent.shape[0]):
        m = torch.clamp(dc[:, c] - cl.rad[c], min=0.0)
        want = torch.nn.functional.pad(m * m <= b, (0, units * grain - n))
        visit = want.reshape(units, grain).any(dim=1)
        total += int(visit.sum()) * grain * int(cl.rows[c])
        sel = torch.nonzero(visit.repeat_interleave(grain)[:n]).flatten()
        if sel.numel():
            j0 = c * cl.csize
            d2, _ = kc._scan(q_c[sel], cl.vs[j0:j0 + cl.csize])
            b[sel] = torch.minimum(d2, b[sel])
    return total


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path = [root] + [p for p in sys.path
                         if os.path.abspath(p or ".") != here]
    import torch
    if not torch.cuda.is_available():
        sys.exit("cluster_sweep: needs a CUDA device")
    from sherf_tpu_torch.kernels import _cuda
    from sherf_tpu_torch.kernels import knn_cluster as kc
    dev = torch.device("cuda")
    query, ref = frame_query(torch, dev)
    # the budget's padding is the call's last run of identical queries
    tail = int(torch.nonzero(kc.run_starts(query)).flatten()[-1])
    real = query[:tail]
    cl5 = kc.make_clusters(ref, kc.C_SIZE, sorted_mean=True)
    cl6 = kc.make_clusters(ref, kc.SL_CSIZE, sorted_mean=False)
    q5 = (query - cl5.ctr0).contiguous()
    q6 = (query - cl6.ctr0).contiguous()
    lists = kc.shortlist_tiles(q6, cl6)[:2]
    out = {"n": query.shape[0], "real": real.shape[0], "v": ref.shape[0],
           "device": torch.cuda.get_device_name(0)}
    grain, lib = kc.NN_GROUP, _cuda._LIB
    try:
        for q in QS:
            _cuda._LIB = build_variant(q)
            kc.NN_GROUP = 32 * q
            d2k, ik = kc.nn_1_clustered_cuda(query, cl5)
            d2p, ip, _ = kc.nn_1_clustered_plain(q5, cl5)
            d6k, i6k, _ = kc.nn_1_shortlist_cuda(query, cl6)
            d6p, i6p, _ = kc.nn_1_shortlist_plain(q6, cl6, *lists)
            r = {"equal": bool(torch.equal(ik, ip) and torch.equal(d2k, d2p)
                               and torch.equal(i6k, i6p)
                               and torch.equal(d6k, d6p)),
                 "union_pairs": union_pairs(q5, cl5, 32 * q, kc, torch)}
            for rep in (1, 4, 8):
                qq = query if rep == 1 else real.repeat(rep, 1).contiguous()
                r[f"nn_1_clustered_x{rep}_ms"] = cuda_ms(
                    lambda: kc.nn_1_clustered_cuda(qq, cl5), torch)
                r[f"nn_1_shortlist_x{rep}_ms"] = cuda_ms(
                    lambda: kc.nn_1_shortlist_cuda(qq, cl6), torch)
            out[f"q{q}"] = r
    finally:
        _cuda._LIB, kc.NN_GROUP = lib, grain
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
