#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port runs on a GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU (Hopper,
sm_90a):

    python3 chip_smoke.py

It builds the port's CUDA kernels with nvcc and drives four paths of
``sherf_tpu_torch`` at the production configuration (512x512 rays x 48
samples, bf16, calibrated budgets — the configuration of ``bench.py``),
with random weights drawn from a seeded ``torch.Generator``:

  * serving: one rendered frame (phases ``frame`` and ``profile``);
  * the clustered-KNN serving configurations on the same scene and weights:
    ``knn_cluster.CLUSTERED`` on (phase ``cluster_frame``), and on with
    ``render.knn_shortlist = 8`` (phase ``shortlist_frame``);
  * training: five steps of ``make_train_step`` at batch 1 (phases
    ``train`` and ``train_profile``), then a 2-step ``training_loop`` that
    writes stats.jsonl and a checkpoint (phase ``train_loop``).

For each path the launch counters are reset just before it and read just
after, and must be what the path launches (the frame: 2 nn_1, 1
ray_body_mask, 6 compact_mask; cluster_frame: 2 nn_1_clustered, 1
ray_body_mask_clustered, 6 compact_mask; shortlist_frame: 2 nn_1_shortlist,
1 ray_body_mask_clustered, 6 compact_mask; the train step, per step: 3
weighted_accumulate, 2 nn_1, 1 ray_body_mask, 6 compact_mask).  It checks
that each kernel agrees with its plain torch version on the inputs the
paths gave it (indices, masks and compactions equal; squared distances
bit-equal; the table gradient within the f32 reassociation bound), that
each clustered call agrees with the full-scan kernel on the same inputs,
that every frame is finite with every budget-overflow counter at zero and
the clustered frames within 45 dB of the default frame, that the train
steps have finite loss and gradient norm, zero overflow, move every
parameter the loss reaches and an EMA apart from them, and that the port's
GPU path agrees with its CPU path on a small input, forward
(``small_input_vs_cpu``) and gradients (``small_train_vs_cpu``).

Each phase prints one JSON line with its seconds.  The line before the last
two is {"kernels": [...]} (times from CUDA events, medians); then the
card's name and power limit as nvidia-smi reports them; the last line is
{"ok": true, "device": {...}}.  Any failed check exits non-zero; a hang is
turned into a failure by a watchdog.  Imports torch, numpy and the port
only.
"""

import faulthandler
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

WATCHDOG_S = 600
# device-side names of the port's own CUDA kernels (csrc/*.cu)
PORT_KERNELS = {"nn_1": ("nn1_kernel",),
                "ray_body_mask": ("ray_body_mask_kernel",),
                "compact_mask": ("cm_count", "cm_scan", "cm_scatter"),
                "weighted_accumulate": ("wa_kernel",),
                "nn_1_clustered": ("nn1_cluster_kernel",),
                "nn_1_shortlist": ("nn1_shortlist_kernel",),
                "ray_body_mask_clustered": ("ray_cluster_kernel",)}
NONE = dict.fromkeys(PORT_KERNELS, 0)
# launches per frame at batch 1: point + canonical KNN, one ray mask, ray /
# point / exact compaction + 3 sparse-conv downsamples
FRAME_LAUNCHES = {**NONE, "nn_1": 2, "ray_body_mask": 1, "compact_mask": 6}
CLUSTER_LAUNCHES = {**NONE, "nn_1_clustered": 2, "ray_body_mask_clustered": 1,
                    "compact_mask": 6}
SHORTLIST_LAUNCHES = {**NONE, "nn_1_shortlist": 2,
                      "ray_body_mask_clustered": 1, "compact_mask": 6}
# per train step: the frame's kernels + 3 readout scales (weighted_accumulate)
TRAIN_LAUNCHES = {**FRAME_LAUNCHES, "weighted_accumulate": 3}
KNN_SHORTLIST = 8        # any value > 0 switches the shortlist on
# raised on the decoder's density bias for the small GPU-vs-CPU render, so
# that random weights draw an opaque body (as tests/test_torch_e2e.py does)
DENSITY_BIAS = 5.0
H = W = 512
DEPTH = 48
MARGIN = 1.15
FRAME_ITERS = 5
TRAIN_STEPS = 5
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).  The f32
# rate counts an FMA as two operations; the knn kernels' distance code is
# never contracted to FMAs, so each of its operations takes one issue slot
# and the ceiling they can reach is twice the bound printed from this rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# f32 operations per (query, vertex) pair in csrc/knn.cu and knn_cluster.cu
NN1_OPS_PER_PAIR = 9     # 3 sub, 3 mul, 2 add, 1 compare
RBM_OPS_PER_PAIR = 17    # 3 sub, 3+3 mul, 2+2 add (a, b), 2 mul, 1 sub, 1 min
# queries farther than this from the vertex centroid are the padding that
# ray compaction parks at 1e6 m: f32 cluster bounds at that distance are
# looser than a body's size, so the full-scan comparison leaves them out
FAR_M = 1e3


class SmokeFailure(Exception):
    pass


def phase(name, t0, **kw):
    print(json.dumps({"phase": name, "seconds": round(time.perf_counter() - t0, 3),
                      **kw}), flush=True)


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def run(cmd):
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return p.stdout.strip() if p.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def cuda_ms(fn, iters, torch):
    """Median milliseconds of ``fn()`` over ``iters`` runs (CUDA events),
    after one warm-up run."""
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


def coop_queries(q_c, tile, torch):
    """Queries of an nn_1 call that the kernel scans cooperatively: those
    of every tile of ``tile`` queries whose entries are bit-identical (a
    partial last tile padded with copies of the last query)."""
    n = q_c.shape[0]
    if n == 0:
        return 0
    bits = q_c.contiguous().view(torch.int32)
    pad = -n % tile
    if pad:
        bits = torch.cat([bits, bits[-1:].expand(pad, 3)])
    t = bits.reshape(-1, tile, 3)
    same = (t == t[:, :1]).all(dim=2).all(dim=1)
    per_tile = torch.full_like(same, tile, dtype=torch.int64)
    per_tile[-1] = tile - pad
    return int((per_tile * same).sum())


def profiled(fn, torch):
    """Run ``fn`` once under torch.profiler: wall ms, device busy ms (sum of
    kernel times), idle share, the port's kernels and the top ops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - ts) * 1e3
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    # device-side events are the kernels; host-side ops carry the same time
    # again as the device time of the kernels they launched
    kernels = [e for e in ev if e.device_type != torch.autograd.DeviceType.CPU]
    ops = [e for e in ev if e.device_type == torch.autograd.DeviceType.CPU]
    check(kernels, "the profiler recorded no device kernel")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)
    port = {}
    for key, names in PORT_KERNELS.items():
        mine = [e for e in kernels if any(nm in e.key for nm in names)]
        port[key] = {"device_ms": sum(e.self_device_time_total
                                      for e in mine) / 1e3,
                     "kernels": sum(e.count for e in mine)}
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "port_kernels": port,
            "top_ops": [{"op": e.key[:60],
                         "device_ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in top[:15]]}


class Recorder:
    """Within ``with``: every call of the listed ``*_cuda`` functions
    appends its arguments to ``calls[key]`` (while ``on``) and goes on to
    the kernel."""

    def __init__(self, shims):
        self.shims = shims
        self.calls = {key: [] for _, _, key in shims}
        self.on = True
        self._orig = {}

    def __enter__(self):
        for mod, attr, key in self.shims:
            orig = getattr(mod, attr)
            self._orig[(mod, attr)] = orig

            def shim(*args, _orig=orig, _key=key):
                if self.on:
                    self.calls[_key].append(args)
                return _orig(*args)
            setattr(mod, attr, shim)
        return self

    def __exit__(self, *exc):
        for (mod, attr), orig in self._orig.items():
            setattr(mod, attr, orig)


def grad_rel_errors(model_a, model_b, floor=1e-8):
    """{name: relative L2 of b's gradient against a's} for every parameter
    whose gradient in ``model_a`` has a norm above ``floor``."""
    out = {}
    gb = dict(model_b.named_parameters())
    for name, pa in model_a.named_parameters():
        if pa.grad is None:
            continue
        ref = pa.grad.double().cpu()
        norm = float(ref.norm())
        if norm <= floor:
            continue
        got = gb[name].grad
        got = ref.new_zeros(ref.shape) if got is None else got.double().cpu()
        out[name] = float((got - ref).norm()) / norm
    return out


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_all = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a GPU",
              file=sys.stderr)
        return 2
    import dataclasses
    import tempfile

    import sherf_tpu_torch  # noqa: F401 — fails outside a checkout
    from sherf_tpu_torch.core.calibrate import (
        calibrate_budgets, calibrate_sparse_caps, measure_sparse_sites)
    from sherf_tpu_torch.core.config import (DataConfig, ModelConfig,
                                             RenderConfig, TrainConfig)
    from sherf_tpu_torch.core.diag import overflow_report
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch
    from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
    from sherf_tpu_torch.kernels import (_cuda, compaction, knn, knn_cluster,
                                         segment_accum)
    from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
    from sherf_tpu_torch.smpl import big_pose_params, smpl_forward, synthetic_smpl
    from sherf_tpu_torch.train import (create_train_state, make_train_step,
                                       reconstruction_loss, training_loop)
    from sherf_tpu_torch.train.checkpoint import latest_checkpoint

    # f32 paths run in full f32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- device -------------------------------------------------------
    t0 = time.perf_counter()
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    smi_line = smi.splitlines()[0].strip() if smi else "nvidia-smi unavailable"
    nvcc = _cuda.find_nvcc()
    nvcc_ver = run([nvcc, "--version"])
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError:
        triton_ver = None
    phase("device", t0, nvidia_smi=smi_line, gpu=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda,
          nvcc=(nvcc_ver.splitlines()[-1] if nvcc_ver else None),
          ninja=shutil.which("ninja"), triton=triton_ver,
          cutlass=os.path.isdir("/usr/local/cutlass/include"))

    # ---- build --------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    phase("build", t0, nvcc_seconds=_cuda.BUILD_INFO["seconds"],
          library=os.path.relpath(str(_cuda.library_path())))

    # ---- scene, budgets, model ------------------------------------------
    t0 = time.perf_counter()
    smpl = synthetic_smpl(0, device="cpu")
    bp = big_pose_params()
    with torch.no_grad():
        t_verts = smpl_forward(smpl, torch.from_numpy(bp["poses"]),
                               torch.from_numpy(bp["shapes"]))[0].numpy()
    cfg = ModelConfig(compute_dtype="bfloat16",
                      render=RenderConfig(depth_resolution=DEPTH,
                                          density_noise=0.0))
    _, out_sh = prepare_voxel_volume(t_verts, voxel_size=cfg.voxel_size)
    caps = calibrate_sparse_caps([t_verts], cfg.voxel_size)
    sites = measure_sparse_sites(t_verts, cfg.voxel_size)
    check(all(n <= c for n, c in zip(sites, caps)), f"sites {sites} > caps {caps}")
    cfg = dataclasses.replace(cfg, sparse_caps=caps)
    smpl_d = smpl.to(dev)
    batch = make_synthetic_batch(smpl, batch_size=1, H=H, W=W, seed=0, device=dev)
    fitted, worst = calibrate_budgets([batch], cfg, margin=MARGIN)
    cfg = dataclasses.replace(cfg, render=fitted)
    model = SHERFGenerator(cfg, out_sh=out_sh, device=dev).eval()
    random_init_(model, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    M = H * W * DEPTH
    phase("setup", t0, out_sh=out_sh, sparse_sites=sites, sparse_caps=caps,
          survivors=worst, ray_cap=int(H * W * fitted.ray_capacity_frac),
          point_cap=int(M * fitted.point_capacity_frac),
          exact_cap=int(M * fitted.exact_capacity_frac),
          prune_step_margin=fitted.prune_step_margin)

    shims = [(knn, "nn_1_cuda", "nn_1"),
             (knn, "ray_body_mask_cuda", "ray_body_mask"),
             (compaction, "compact_mask_cuda", "compact_mask"),
             (segment_accum, "weighted_accumulate_cuda", "weighted_accumulate")]
    launches = {}

    # ---- frame: the serving path, through the kernels --------------------
    t0 = time.perf_counter()
    with Recorder(shims) as rec_frame, torch.inference_mode():
        _cuda.reset_launches()
        out, diag = model(batch, smpl_d)
        torch.cuda.synchronize()
        launches["frame"] = dict(_cuda.LAUNCHES)
    first_s = time.perf_counter() - t0
    img = out["image_raw"]
    overflow = overflow_report(diag)
    check(tuple(img.shape) == (1, H, W, 3), f"image shape {tuple(img.shape)}")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          "non-finite frame output")
    check(all(v == 0 for v in overflow.values()), f"budget overflow {overflow}")
    check(launches["frame"] == FRAME_LAUNCHES,
          f"frame launches {launches['frame']}, expected {FRAME_LAUNCHES}")
    frame_ms = []
    with torch.inference_mode():
        for _ in range(FRAME_ITERS):
            ts = time.perf_counter()
            model(batch, smpl_d)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - ts) * 1e3)
    acc = out["weights_image"]
    phase("frame", t0, first_frame_s=round(first_s, 3),
          launches=launches["frame"], overflow=overflow,
          frame_ms_median=statistics.median(frame_ms), frame_ms=frame_ms,
          acc_mean=float(acc.mean()), acc_max=float(acc.max()),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))

    # ---- where one frame's device time goes (torch.profiler) -------------
    t0 = time.perf_counter()
    with torch.inference_mode():
        prof = profiled(lambda: model(batch, smpl_d), torch)
    phase("profile", t0, frame_wall_ms_profiled=prof.pop("wall_ms_profiled"),
          **prof)
    del out, diag, acc

    # ---- the clustered-KNN configurations of the same frame ---------------
    def survivors(calls):
        """ray, point and exact survivors: the masks of a frame's first
        three compactions."""
        return {k: int(m.sum()) for k, (m, _) in
                zip(("rays", "points", "exact"), calls["compact_mask"][:3])}

    frame_survivors = survivors(rec_frame.calls)
    cluster_shims = [(knn_cluster, "nn_1_clustered", "nn_1_clustered"),
                     (knn_cluster, "nn_1_shortlist", "nn_1_shortlist"),
                     (knn_cluster, "ray_body_mask_clustered",
                      "ray_body_mask_clustered"),
                     (compaction, "compact_mask_cuda", "compact_mask")]
    sl_model = SHERFGenerator(dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, knn_shortlist=KNN_SHORTLIST)), out_sh=out_sh,
        device=dev).eval()
    sl_model.load_state_dict(model.state_dict())
    rec_cluster = {}
    for name, mdl, expect in (("cluster_frame", model, CLUSTER_LAUNCHES),
                              ("shortlist_frame", sl_model, SHORTLIST_LAUNCHES)):
        t0 = time.perf_counter()
        knn_cluster.CLUSTERED = True
        with Recorder(cluster_shims) as rec, torch.inference_mode():
            _cuda.reset_launches()
            out_c, diag_c = mdl(batch, smpl_d)
            torch.cuda.synchronize()
            launches[name] = dict(_cuda.LAUNCHES)
        rec_cluster[name] = rec.calls
        img_c = out_c["image_raw"]
        overflow_c = overflow_report(diag_c)
        check(all(bool(torch.isfinite(v).all()) for v in out_c.values()),
              f"{name}: non-finite frame output")
        check(all(v == 0 for v in overflow_c.values()),
              f"{name}: budget overflow {overflow_c}")
        check((name == "shortlist_frame") == ("knn_shortlist_overflow"
                                              in overflow_c),
              f"{name}: overflow counters {sorted(overflow_c)}")
        check(launches[name] == expect,
              f"{name}: launches {launches[name]}, expected {expect}")
        a, b = (img.double() + 1) / 2, (img_c.double() + 1) / 2
        mse = float(((a - b) ** 2).mean())
        psnr = "inf" if mse == 0 else 10 * np.log10(1.0 / mse)
        check(mse == 0 or psnr >= 45.0,
              f"{name}: image vs the default frame at {psnr} dB < 45")
        with torch.inference_mode():
            prof = profiled(lambda: mdl(batch, smpl_d), torch)
        knn_cluster.CLUSTERED = False
        phase(name, t0, launches=launches[name], overflow=overflow_c,
              psnr_vs_frame_db=psnr,
              max_abs_diff_vs_frame=float((img_c.float() - img.float()).abs().max()),
              survivors=survivors(rec.calls), frame_survivors=frame_survivors,
              frame_wall_ms_profiled=prof.pop("wall_ms_profiled"),
              device_busy_ms=prof["device_busy_ms"],
              device_idle_share=prof["device_idle_share"],
              kernel_launches=prof["kernel_launches"],
              port_kernels=prof["port_kernels"])
        del out_c, diag_c, img_c

    # the three configurations' frame times, in turns within this run (host
    # times drift by tens of percent over a run; turns keep them comparable)
    t0 = time.perf_counter()
    modes = {"frame": (model, False), "cluster_frame": (model, True),
             "shortlist_frame": (sl_model, True)}
    turns = {k: [] for k in modes}
    with torch.inference_mode():
        for _ in range(2 * FRAME_ITERS):
            for key, (mdl, clustered) in modes.items():
                knn_cluster.CLUSTERED = clustered
                ts = time.perf_counter()
                mdl(batch, smpl_d)
                torch.cuda.synchronize()
                turns[key].append((time.perf_counter() - ts) * 1e3)
    knn_cluster.CLUSTERED = False
    phase("frame_turns", t0, frame_ms_median={
        k: statistics.median(v) for k, v in turns.items()}, frame_ms=turns)
    del sl_model, img, modes, mdl

    # ---- train: the production train step, 5 steps at batch 1 ------------
    t0 = time.perf_counter()
    train_cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, density_noise=RenderConfig().density_noise))
    tmodel = SHERFGenerator(train_cfg, out_sh=out_sh, device=dev)
    random_init_(tmodel, torch.Generator().manual_seed(0))
    tcfg = TrainConfig(batch_size=1)
    state = create_train_state(tmodel, tcfg)
    step_fn = make_train_step(tmodel, smpl_d, tcfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    step_ms, step_metrics, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    with Recorder(shims) as rec_train:
        _cuda.reset_launches()
        for i in range(TRAIN_STEPS):
            rec_train.on = i == 0          # keep the first step's inputs
            seen = dict(_cuda.LAUNCHES)
            ts = time.perf_counter()
            metrics = step_fn(state, batch, gen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            per_step.append({k: _cuda.LAUNCHES[k] - seen[k] for k in seen})
            step_metrics.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                reached = {n for n, p in tmodel.named_parameters()
                           if p.grad is not None}
                unreached = sorted(set(before) - reached)
                check(all(n.endswith("noise_strength") for n in unreached),
                      f"parameters the loss does not reach: {unreached}")
                still = [n for n in reached
                         if torch.equal(before[n], dict(
                             tmodel.named_parameters())[n].detach())]
                check(not still, f"step 1 left parameters unchanged: {still[:5]}")
        launches["train"] = dict(_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (m, n) in enumerate(zip(step_metrics, per_step)):
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"train step {i + 1}: loss {m['loss']} grad_norm {m['grad_norm']}")
        check(m["overflow"] == 0, f"train step {i + 1}: overflow {m['overflow']}")
        check(n == TRAIN_LAUNCHES, f"train step {i + 1}: launches {n}, "
              f"expected {TRAIN_LAUNCHES}")
    params = dict(tmodel.named_parameters())
    same_ema = [n for n in reached if torch.equal(state.ema[n], params[n])]
    check(not same_ema, f"EMA equals the parameters: {same_ema[:5]}")
    phase("train", t0, steps=TRAIN_STEPS, step_ms=step_ms,
          step_ms_median_2_5=statistics.median(step_ms[1:]),
          peak_mem_gb=round(peak_gb, 3), launches=launches["train"],
          launches_per_step=per_step[0], metrics=step_metrics,
          params_reached=len(reached), params_unreached=unreached)

    t0 = time.perf_counter()
    prof = profiled(lambda: step_fn(state, batch, gen), torch)
    phase("train_profile", t0, step_wall_ms_profiled=prof.pop("wall_ms_profiled"),
          **prof)
    del before

    # ---- kernels vs their plain versions on the paths' own inputs --------
    # (these direct *_cuda calls add to LAUNCHES, which was read above)
    t0 = time.perf_counter()
    rows, cases = [], []
    errs = {k: 0.0 for k in PORT_KERNELS}

    def note_err(key, a, b):
        e = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        errs[key] = max(errs[key], e)
        return e

    def bound(ops, nbytes):
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    def by_path(key):
        return {p: launches[p][key] for p in launches}

    recorded = {k: rec_frame.calls[k] + rec_train.calls[k]
                for k in ("nn_1", "ray_body_mask", "compact_mask")}
    nn1_tile, coop = _cuda.library().sherf_nn1_tile(), []
    # nn_1: every call of the frame and of one train step checked; the
    # frame's point-budget call timed
    for i, (q_c, v_c) in enumerate(recorded["nn_1"]):
        d2k, ik = knn.nn_1_cuda(q_c, v_c)
        d2p, ip = knn.nn_1_plain(q_c, v_c)
        torch.cuda.synchronize()
        err = note_err("nn_1", d2k, d2p)
        note_err("nn_1", ik, ip)
        check(torch.equal(ik, ip), f"nn_1 call {i}: indices differ")
        check(torch.equal(d2k, d2p), f"nn_1 call {i}: d2 not bit-equal "
              f"(max abs err {err})")
        coop.append(coop_queries(q_c, nn1_tile, torch))
        cases.append({"kernel": "nn_1", "call": i, "n": q_c.shape[0],
                      "v": v_c.shape[0], "equal": True,
                      "coop_queries": coop[-1]})
    q_c, v_c = recorded["nn_1"][0]
    n, nv = q_c.shape[0], v_c.shape[0]
    chunk = max(1, int(4e9 // (nv * 4)))  # cdist output <= 4 GB per call

    def nn1_library():
        for s in range(0, n, chunk):
            torch.cdist(q_c[s:s + chunk], v_c,
                        compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)
    b_ms, b_by = bound(n * nv * NN1_OPS_PER_PAIR, n * 12 + nv * 12 + n * 8)
    rows.append({
        "name": "nn_1", "route": "cuda", "source": "sherf_tpu_torch/csrc/knn.cu",
        # the kernel issues no FMA: one operation per issue slot, half the
        # FMA-counted peak
        "no_fma_ceiling_ms": n * nv * NN1_OPS_PER_PAIR / (PEAK_F32_FLOPS / 2)
        * 1e3,
        "coop_queries": coop[0], "tile": nn1_tile,
        "replaces": "sherf_tpu/kernels/knn_pallas.py:608",
        "launches": launches["frame"]["nn_1"], "launches_by_path": by_path("nn_1"),
        "max_abs_err": errs["nn_1"],
        "ms": cuda_ms(lambda: knn.nn_1_cuda(q_c, v_c), 5, torch),
        "plain_ms": cuda_ms(lambda: knn.nn_1_plain(q_c, v_c), 3, torch),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(nn1_library, 3, torch), "n": n, "v": nv})

    # ray_body_mask
    for i, (o_c, d, v_c, thr, act) in enumerate(recorded["ray_body_mask"]):
        mk = knn.ray_body_mask_cuda(o_c, d, v_c, thr, act)
        mp = knn.ray_body_mask_plain(o_c, d, v_c, thr, act)
        torch.cuda.synchronize()
        note_err("ray_body_mask", mk, mp)
        check(torch.equal(mk, mp), f"ray_body_mask call {i}: masks differ "
              f"({int((mk != mp).sum())} rays)")
        cases.append({"kernel": "ray_body_mask", "call": i, "n": o_c.shape[0],
                      "equal": True})
    o_c, d, v_c, thr, act = recorded["ray_body_mask"][0]
    n, nv = o_c.shape[0], v_c.shape[0]
    tile = knn.RAY_TILE
    act_t = torch.nn.functional.pad(act, (0, -n % tile)).reshape(-1, tile)
    n_scanned = int(act_t.any(dim=1).sum()) * tile
    b_ms, b_by = bound(n_scanned * nv * RBM_OPS_PER_PAIR,
                       n * (12 + 12 + 1 + 1) + nv * 12)
    rows.append({
        "name": "ray_body_mask", "route": "cuda",
        "source": "sherf_tpu_torch/csrc/knn.cu",
        "replaces": "sherf_tpu/kernels/knn_pallas.py:554",
        "launches": launches["frame"]["ray_body_mask"],
        "launches_by_path": by_path("ray_body_mask"),
        "max_abs_err": errs["ray_body_mask"],
        "ms": cuda_ms(lambda: knn.ray_body_mask_cuda(o_c, d, v_c, thr, act), 5,
                      torch),
        "plain_ms": cuda_ms(lambda: knn.ray_body_mask_plain(o_c, d, v_c, thr,
                                                            act), 3, torch),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "n": n,
        "rays_scanned": n_scanned})

    # compact_mask: every call of the frame and of one train step, plus the
    # frame's occupancy over all 512*512*48 samples (what the point
    # compaction reads without ray compaction) at the point budget
    from sherf_tpu_torch.kernels.occupancy import strided_occupancy
    from sherf_tpu_torch.nerf.renderer import linspace01
    with torch.no_grad():
        steps = linspace01(DEPTH, dev)
        dv = batch.near[0][:, None] + (batch.far[0] - batch.near[0])[:, None] * steps
        pts = batch.ray_o[0][:, None] + dv[..., None] * batch.ray_d[0][:, None]
        full_mask = strided_occupancy(
            pts, batch.vertices[0], radius=float(np.sqrt(fitted.prune_threshold_sq)),
            stride=fitted.prune_stride, step_margin=fitted.prune_step_margin)
        del pts, dv
    point_cap = recorded["compact_mask"][1][1]
    calls = recorded["compact_mask"] + [(full_mask, point_cap)]
    for i, (m, cap) in enumerate(calls):
        ik, vk = compaction.compact_mask_cuda(m, cap)
        ip, vp = compaction.compact_mask_plain(m, cap)
        torch.cuda.synchronize()
        note_err("compact_mask", ik, ip)
        note_err("compact_mask", vk, vp)
        check(torch.equal(ik, ip) and torch.equal(vk, vp),
              f"compact_mask call {i} (n={m.shape[0]}, cap={cap}): differs")
        cases.append({"kernel": "compact_mask", "call": i, "n": m.shape[0],
                      "cap": cap, "survivors": int(m.sum()), "equal": True})
    m, cap = full_mask, point_cap

    def compact_library():
        nz = torch.nonzero(m).flatten()[:cap].to(torch.int32)
        return torch.nn.functional.pad(nz, (0, cap - nz.shape[0]),
                                       value=m.shape[0])
    b_ms, b_by = bound(0, m.shape[0] + 5 * cap)
    rows.append({
        "name": "compact_mask", "route": "cuda",
        "source": "sherf_tpu_torch/csrc/compaction.cu",
        "replaces": "sherf_tpu/kernels/compaction.py:107",
        "launches": launches["frame"]["compact_mask"],
        "launches_by_path": by_path("compact_mask"),
        "max_abs_err": errs["compact_mask"],
        "ms": cuda_ms(lambda: compaction.compact_mask_cuda(m, cap), 5, torch),
        "plain_ms": cuda_ms(lambda: compaction.compact_mask_plain(m, cap), 3,
                            torch),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(compact_library, 5, torch), "n": m.shape[0],
        "cap": cap})
    del full_mask

    # weighted_accumulate: every call of the first train step, within the
    # f32 reassociation bound of the atomics' sum order
    wa_calls = rec_train.calls["weighted_accumulate"]
    check(len(wa_calls) == TRAIN_LAUNCHES["weighted_accumulate"],
          f"{len(wa_calls)} weighted_accumulate calls recorded in step 1")
    wa_by_call = []
    for i, (ids, w, g, n_rows) in enumerate(wa_calls):
        wa_by_call.append({
            "n": ids.shape[0], "k": ids.shape[1], "c": g.shape[1],
            "n_rows": n_rows,
            # taps on the zero row (every empty or out-of-volume corner)
            "id0_share": float((ids == 0).float().mean()),
            "tiling": segment_accum.weighted_accumulate_tiling(
                ids.shape[0], ids.shape[1], g.shape[1]),
            "ms": cuda_ms(lambda: segment_accum.weighted_accumulate_cuda(
                ids, w, g, n_rows), 5, torch)})
        got = segment_accum.weighted_accumulate_cuda(ids, w, g, n_rows)
        ref = segment_accum.weighted_accumulate_plain(ids, w, g, n_rows)
        mag = segment_accum.weighted_accumulate_plain(ids, w.abs(), g.abs(),
                                                      n_rows)
        # how much of the bound the kernel uses, and how much a second run of
        # the plain version (f32 index_add_, atomics) uses against the first:
        # on the zero row, whose sums run over ~10^5 products, the plain
        # version's own rounding spread is a large part of the bound
        ref2 = segment_accum.weighted_accumulate_plain(ids, w, g, n_rows)
        torch.cuda.synchronize()
        fin, bnd = torch.isfinite(ref), (1e-5 * mag).clamp(min=1e-30)
        wa_by_call[-1]["bound_use"] = float(((got - ref).abs() / bnd)[fin].max())
        wa_by_call[-1]["plain_spread"] = float(((ref2 - ref).abs()
                                                / bnd)[fin].max())
        e = note_err("weighted_accumulate", got, ref)
        excess = float(((got - ref).abs() - 1e-5 * mag).max())
        check(excess <= 1e-30, f"weighted_accumulate call {i}: |cuda - plain| "
              f"exceeds 1e-5 * plain(|w|, |g|) by {excess} (max abs err {e}; "
              f"{wa_by_call[-1]})")
        cases.append({"kernel": "weighted_accumulate", "call": i,
                      "n": ids.shape[0], "k": ids.shape[1], "c": g.shape[1],
                      "n_rows": n_rows, "max_abs_err": e,
                      "within_bound": True})
    ids, w, g, n_rows = max(wa_calls, key=lambda a: a[0].shape[0] * a[2].shape[1])
    n, k = ids.shape
    c = g.shape[1]
    upd = (segment_accum._dedup_weights(ids.long(), w).to(torch.bfloat16)
           .float()[:, :, None]
           * g.to(torch.bfloat16).float()[:, None, :]).reshape(-1, c)
    flat_ids = ids.reshape(-1).long()

    def wa_library():
        torch.zeros((n_rows, c), device=dev).index_add_(0, flat_ids, upd)
    b_ms, b_by = bound(2 * n * k * c, n * k * 8 + n * c * 4 + n_rows * c * 4)
    rows.append({
        "name": "weighted_accumulate", "route": "cuda",
        "source": "sherf_tpu_torch/csrc/segment_accum.cu",
        "replaces": "sherf_tpu/kernels/segment_accum.py:93",
        "launches": launches["train"]["weighted_accumulate"],
        "launches_by_path": by_path("weighted_accumulate"),
        "max_abs_err": errs["weighted_accumulate"],
        "ms": cuda_ms(lambda: segment_accum.weighted_accumulate_cuda(
            ids, w, g, n_rows), 5, torch),
        "plain_ms": cuda_ms(lambda: segment_accum.weighted_accumulate_plain(
            ids, w, g, n_rows), 3, torch),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(wa_library, 5, torch), "n": n, "k": k, "c": c,
        "n_rows": n_rows, "calls": wa_by_call})
    del upd, flat_ids, wa_calls

    # the clustered kernels: every call of cluster_frame and shortlist_frame
    # against its plain version (same prep, same visit rule: bit-equal) and
    # against the full-scan kernel on the same raw inputs.  The two centre
    # on f32 means that differ in the last bit, which moves each centred
    # coordinate by up to half an ulp (6e-8 m at 1 m) and d2 by up to about
    # 1e-4 relative or 1e-7 m^2; ties may go to another vertex at the same
    # distance, so the index is held to the f64 distance at the full scan's
    def knn_vs_full(key, i, query, ref, d2, idx):
        d_f, i_f = knn.nn_1_cuda(*knn._centre(query, ref))
        near = (query - ref.mean(0)).norm(dim=1) < FAR_M
        check(bool(torch.allclose(d2[near], d_f[near], rtol=1e-4, atol=1e-7)),
              f"{key} call {i}: d2 differs from the full scan")
        q64, v64 = query[near].double(), ref.double()
        at = ((q64 - v64[idx[near].long()]) ** 2).sum(-1)
        at_f = ((q64 - v64[i_f[near].long()]) ** 2).sum(-1)
        check(bool(torch.allclose(at, at_f, rtol=1e-4, atol=1e-7)),
              f"{key} call {i}: index is not a nearest vertex")
        thr = fitted.prune_threshold_sq
        flips = int(((d2 < thr) != (d_f < thr)).sum())
        return {"full_scan_idx_equal": int((idx == i_f)[near].sum()),
                "far_queries": int((~near).sum()), "prune_flips": flips}

    clus = {"nn_1_clustered": rec_cluster["cluster_frame"]["nn_1_clustered"],
            "nn_1_shortlist": rec_cluster["shortlist_frame"]["nn_1_shortlist"],
            "ray_body_mask_clustered": (
                rec_cluster["cluster_frame"]["ray_body_mask_clustered"]
                + rec_cluster["shortlist_frame"]["ray_body_mask_clustered"])}
    prep = {}
    for i, (query, ref) in enumerate(clus["nn_1_clustered"]):
        cl = knn_cluster.make_clusters(ref, knn_cluster.C_SIZE, sorted_mean=True)
        q_c = (query - cl.ctr0).contiguous()
        d2k, ik = knn_cluster.nn_1_clustered_cuda(q_c, cl)
        d2p, ip, visits = knn_cluster.nn_1_clustered_plain(q_c, cl)
        torch.cuda.synchronize()
        err = note_err("nn_1_clustered", d2k, d2p)
        note_err("nn_1_clustered", ik, ip)
        check(torch.equal(ik, ip), f"nn_1_clustered call {i}: indices differ")
        check(torch.equal(d2k, d2p), f"nn_1_clustered call {i}: d2 not "
              f"bit-equal (max abs err {err})")
        full = knn_vs_full("nn_1_clustered", i, query, ref, d2k,
                           cl.order[ik.long()])
        prep.setdefault("nn_1_clustered", (query, ref, cl, q_c, visits))
        cases.append({"kernel": "nn_1_clustered", "call": i,
                      "n": query.shape[0], "v": ref.shape[0], "equal": True,
                      "pairs": int(visits.sum()), **full})
    for i, (query, ref, _) in enumerate(clus["nn_1_shortlist"]):
        cl = knn_cluster.make_clusters(ref, knn_cluster.SL_CSIZE,
                                       sorted_mean=False)
        q_c = (query - cl.ctr0).contiguous()
        counts, ids, _, _ = knn_cluster.shortlist_tiles(q_c, cl)
        d2k, ik = knn_cluster.nn_1_shortlist_cuda(q_c, cl, counts, ids)
        d2p, ip, visits = knn_cluster.nn_1_shortlist_plain(q_c, cl, counts, ids)
        torch.cuda.synchronize()
        err = note_err("nn_1_shortlist", d2k, d2p)
        note_err("nn_1_shortlist", ik, ip)
        check(torch.equal(ik, ip), f"nn_1_shortlist call {i}: indices differ")
        check(torch.equal(d2k, d2p), f"nn_1_shortlist call {i}: d2 not "
              f"bit-equal (max abs err {err})")
        full = knn_vs_full("nn_1_shortlist", i, query, ref, d2k,
                           cl.order[ik.long()])
        prep.setdefault("nn_1_shortlist", (query, ref, cl, q_c, visits,
                                           counts, ids))
        cases.append({"kernel": "nn_1_shortlist", "call": i,
                      "n": query.shape[0], "v": ref.shape[0], "equal": True,
                      "pairs": int(visits.sum()),
                      "clusters_per_tile_mean": float(counts.float().mean()),
                      **full})
    for i, (ray_o, ray_d, verts, thr) in enumerate(
            clus["ray_body_mask_clustered"]):
        cl = knn_cluster.make_clusters(verts, knn_cluster.C_SIZE,
                                       sorted_mean=True)
        o_c = (ray_o - cl.ctr0).contiguous()
        ray_d = ray_d.contiguous()
        mk = knn_cluster.ray_body_mask_clustered_cuda(o_c, ray_d, cl, thr)
        mp, visits = knn_cluster.ray_body_mask_clustered_plain(o_c, ray_d, cl,
                                                               thr)
        o_f, v_f = knn._centre(ray_o, verts)
        mf = knn.ray_body_mask_cuda(o_f, ray_d, v_f, thr)
        torch.cuda.synchronize()
        note_err("ray_body_mask_clustered", mk, mp)
        check(torch.equal(mk, mp), f"ray_body_mask_clustered call {i}: masks "
              f"differ ({int((mk != mp).sum())} rays)")
        # rays where the full scan disagrees must sit on the f32 borderline:
        # a - b^2/|d|^2 cancels terms of ~10 m^2, good to ~1e-5 m^2
        off = torch.nonzero(mk != mf).flatten()
        w = verts.double()[None] - ray_o.double()[off][:, None]
        dd = ray_d.double()[off]
        b = (w * dd[:, None]).sum(-1)
        line = ((w * w).sum(-1) - b * b / (dd * dd).sum(-1)[:, None]).amin(1)
        check(bool(((line - thr).abs() <= 1e-5).all()),
              f"ray_body_mask_clustered call {i}: {off.numel()} rays differ "
              f"from the full scan off the borderline")
        prep.setdefault("ray_body_mask_clustered",
                        (ray_o, ray_d, verts, thr, cl, o_c, visits))
        cases.append({"kernel": "ray_body_mask_clustered", "call": i,
                      "n": ray_o.shape[0], "equal": True,
                      "full_scan_borderline_flips": off.numel(),
                      "pairs": int(visits.sum()), "hits": int(mk.sum())})

    def cdist_min(q, v):
        def run():
            for s in range(0, q.shape[0], chunk):
                torch.cdist(q[s:s + chunk], v,
                            compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)
        return run

    # B5 and B6 timed at the point-budget KNN (the first call of each
    # frame), B7 at the ray prune; bounds count the (query, vertex) pairs
    # that each query's own bound test admitted (B5, B7) or that its tile
    # visited (B6), as the plain versions report them.  full_scan_ms: the
    # full-scan kernel on the same inputs (for B7 also with the default
    # path's AABB tile skip); *wrapper_ms: the public function, prep and
    # index remap included, against the full scan's
    query, ref, cl, q_c, visits = prep["nn_1_clustered"]
    n, nv, nc = query.shape[0], ref.shape[0], cl.cent.shape[0]
    chunk = max(1, int(4e9 // (nv * 4)))
    q_f, v_f = knn._centre(query, ref)
    pairs = int(visits.sum())
    b_ms, b_by = bound(pairs * NN1_OPS_PER_PAIR, n * 20 + nv * 12 + nc * 16)
    rows.append({
        "name": "nn_1_clustered", "route": "cuda",
        "source": "sherf_tpu_torch/csrc/knn_cluster.cu",
        "replaces": "sherf_tpu/kernels/knn_pallas.py:207",
        "launches": launches["cluster_frame"]["nn_1_clustered"],
        "launches_by_path": by_path("nn_1_clustered"),
        "max_abs_err": errs["nn_1_clustered"],
        "ms": cuda_ms(lambda: knn_cluster.nn_1_clustered_cuda(q_c, cl), 5, torch),
        "plain_ms": cuda_ms(lambda: knn_cluster.nn_1_clustered_plain(q_c, cl),
                            3, torch),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(cdist_min(q_c, cl.vs), 3, torch),
        "full_scan_ms": cuda_ms(lambda: knn.nn_1_cuda(q_f, v_f), 5, torch),
        "wrapper_ms": cuda_ms(lambda: knn_cluster.nn_1_clustered(query, ref),
                              5, torch),
        "full_scan_wrapper_ms": cuda_ms(lambda: knn.nn_1(query, ref), 5, torch),
        "n": n, "v": nv, "clusters": nc, "pairs": pairs,
        "pairs_share": pairs / (n * nv)})

    query, ref, cl, q_c, visits, counts, ids = prep["nn_1_shortlist"]
    n, nv, nc = query.shape[0], ref.shape[0], cl.cent.shape[0]
    q_f, v_f = knn._centre(query, ref)
    pairs = int(visits.sum())
    b_ms, b_by = bound(pairs * NN1_OPS_PER_PAIR,
                       n * 20 + nv * 12 + counts.numel() * 4 + ids.numel() * 4)
    rows.append({
        "name": "nn_1_shortlist", "route": "cuda",
        "source": "sherf_tpu_torch/csrc/knn_cluster.cu",
        "replaces": "sherf_tpu/kernels/knn_pallas.py:318",
        "launches": launches["shortlist_frame"]["nn_1_shortlist"],
        "launches_by_path": by_path("nn_1_shortlist"),
        "max_abs_err": errs["nn_1_shortlist"],
        "ms": cuda_ms(lambda: knn_cluster.nn_1_shortlist_cuda(
            q_c, cl, counts, ids), 5, torch),
        "plain_ms": cuda_ms(lambda: knn_cluster.nn_1_shortlist_plain(
            q_c, cl, counts, ids), 3, torch),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(cdist_min(q_c, cl.vs), 3, torch),
        "full_scan_ms": cuda_ms(lambda: knn.nn_1_cuda(q_f, v_f), 5, torch),
        "wrapper_ms": cuda_ms(lambda: knn_cluster.nn_1_shortlist(query, ref),
                              5, torch),
        "full_scan_wrapper_ms": cuda_ms(lambda: knn.nn_1(query, ref), 5, torch),
        "n": n, "v": nv, "clusters": nc, "tiles": counts.numel(),
        "clusters_per_tile_mean": float(counts.float().mean()),
        "pairs": pairs, "pairs_share": pairs / (n * nv)})

    ray_o, ray_d, verts, thr, cl, o_c, visits = prep["ray_body_mask_clustered"]
    n, nv, nc = ray_o.shape[0], verts.shape[0], cl.cent.shape[0]
    o_f, v_f = knn._centre(ray_o, verts)
    act = recorded["ray_body_mask"][0][4]       # the default frame's AABB mask
    pairs = int(visits.sum())
    b_ms, b_by = bound(pairs * RBM_OPS_PER_PAIR, n * 25 + nv * 12 + nc * 16)
    rows.append({
        "name": "ray_body_mask_clustered", "route": "cuda",
        "source": "sherf_tpu_torch/csrc/knn_cluster.cu",
        "replaces": "sherf_tpu/kernels/knn_pallas.py:501",
        "launches": launches["cluster_frame"]["ray_body_mask_clustered"],
        "launches_by_path": by_path("ray_body_mask_clustered"),
        "max_abs_err": errs["ray_body_mask_clustered"],
        "ms": cuda_ms(lambda: knn_cluster.ray_body_mask_clustered_cuda(
            o_c, ray_d, cl, thr), 5, torch),
        "plain_ms": cuda_ms(lambda: knn_cluster.ray_body_mask_clustered_plain(
            o_c, ray_d, cl, thr), 3, torch),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "full_scan_ms": cuda_ms(lambda: knn.ray_body_mask_cuda(
            o_f, ray_d, v_f, thr), 5, torch),
        "full_scan_active_ms": cuda_ms(lambda: knn.ray_body_mask_cuda(
            o_f, ray_d, v_f, thr, act), 5, torch),
        "wrapper_ms": cuda_ms(lambda: knn_cluster.ray_body_mask_clustered(
            ray_o, ray_d, verts, thr), 5, torch),
        "full_scan_wrapper_ms": cuda_ms(lambda: knn.ray_body_mask(
            ray_o, ray_d, verts, thr, active=act), 5, torch),
        "n": n, "v": nv, "clusters": nc, "pairs": pairs,
        "pairs_share": pairs / (n * nv)})
    del prep, clus
    rec_frame.calls.clear()
    rec_train.calls.clear()
    rec_cluster.clear()
    phase("kernels", t0, cases=cases)

    # ---- a 2-step training_loop: stats.jsonl and a checkpoint -------------
    t0 = time.perf_counter()
    del state, tmodel, step_fn
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as run_dir:
        loop_cfg = TrainConfig(batch_size=1, total_kimg=0.002, report_imgs=1,
                               outdir=run_dir)
        _cuda.reset_launches()
        loop_state = training_loop(train_cfg, loop_cfg, DataConfig(), smpl_d,
                                   batch_source=lambda: batch, device=dev)
        torch.cuda.synchronize()
        loop_launches = dict(_cuda.LAUNCHES)
        with open(os.path.join(run_dir, "stats.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        ckpt = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
        ckpt_mb = os.path.getsize(ckpt) / 2 ** 20 if ckpt else 0.0
    loss_steps = [x["step"] for x in lines if "Loss/loss" in x]
    check(loop_state.step == 2, f"training_loop ran {loop_state.step} steps")
    check(loss_steps == [1, 2], f"stats.jsonl loss lines at steps {loss_steps}")
    check(all(np.isfinite(x["Loss/loss"]) and x["Loss/overflow"] == 0
              for x in lines if "Loss/loss" in x), "training_loop metrics")
    check(ckpt is not None and ckpt.endswith("snapshot-000002.pt"),
          f"training_loop checkpoint {ckpt}")
    check(all(loop_launches[k] == 2 * v for k, v in TRAIN_LAUNCHES.items()),
          f"training_loop launches {loop_launches}")
    phase("train_loop", t0, steps=loop_state.step, launches=loop_launches,
          stats_lines=len(lines), checkpoint_mb=round(ckpt_mb, 1))
    del loop_state
    torch.cuda.empty_cache()

    # ---- agreement with the CPU path on a small input --------------------
    t0 = time.perf_counter()
    small_cfg = dataclasses.replace(
        cfg, compute_dtype="float32",
        render=RenderConfig(depth_resolution=16, density_noise=0.0))
    small = SHERFGenerator(small_cfg, out_sh=out_sh, device="cpu")
    state_dict = model.state_dict()
    state_dict["renderer.decoder.alpha.bias"] = (
        state_dict["renderer.decoder.alpha.bias"] + DENSITY_BIAS)
    small.load_state_dict(state_dict)
    small_batch = make_synthetic_batch(smpl, batch_size=1, H=24, W=24, seed=1,
                                       device="cpu")
    with torch.no_grad():
        ref, _ = small.eval()(small_batch, smpl)
        got, _ = small.to(dev)(small_batch.to(dev), smpl_d)
    a = (ref["image_raw"].numpy() + 1) / 2
    b = (got["image_raw"].cpu().numpy() + 1) / 2
    mse = float(np.mean((a - b) ** 2))
    psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
    acc_max = float(ref["weights_image"].max())
    check(acc_max > 0.5, f"small render is nearly empty (acc max {acc_max})")
    check(psnr >= 45.0, f"GPU vs CPU path on a small input: {psnr:.1f} dB < 45")
    phase("small_input_vs_cpu", t0, psnr_db=psnr, acc_max=acc_max,
          acc_mean=float(ref["weights_image"].mean()))

    # ---- one train step's gradients: card against CPU ---------------------
    t0 = time.perf_counter()
    small_fit, _ = calibrate_budgets([small_batch], small_cfg, margin=MARGIN,
                                     round_to=128)
    grad_cfg = dataclasses.replace(small_cfg, render=small_fit)
    grad_models = {}
    for where, d_, b_, s_ in (("cpu", "cpu", small_batch, smpl),
                              ("cuda", dev, small_batch.to(dev), smpl_d)):
        mdl = SHERFGenerator(grad_cfg, out_sh=out_sh, device=d_)
        mdl.load_state_dict(state_dict)
        out_g, diag_g = mdl(b_, s_, train=True)
        check(all(int(v) == 0 for v in diag_g.values()),
              f"small train step overflow ({where}): {overflow_report(diag_g)}")
        loss_g, _ = reconstruction_loss(out_g, b_, TrainConfig(batch_size=1))
        loss_g.backward()
        grad_models[where] = (mdl, float(loss_g.detach()))
    rel = grad_rel_errors(grad_models["cpu"][0], grad_models["cuda"][0])
    worst_name = max(rel, key=rel.get)
    check(len(rel) > 50, f"only {len(rel)} parameters with a gradient")
    check(rel[worst_name] <= 1e-3, f"GPU vs CPU gradients: {worst_name} "
          f"relative L2 {rel[worst_name]} > 1e-3")
    phase("small_train_vs_cpu", t0, loss_cpu=grad_models["cpu"][1],
          loss_gpu=grad_models["cuda"][1], params_compared=len(rel),
          worst_param=worst_name, worst_rel_l2=rel[worst_name],
          ray_capacity_frac=small_fit.ray_capacity_frac,
          point_capacity_frac=small_fit.point_capacity_frac,
          exact_capacity_frac=small_fit.exact_capacity_frac)

    phase("total", t_all)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
