#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port runs on a GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU (Hopper,
sm_90a):

    python3 chip_smoke.py

It builds the port's CUDA kernels with nvcc, renders the production frame
(512x512 rays x 48 samples, bf16, calibrated budgets — the configuration of
``bench.py``) through ``sherf_tpu_torch`` with random weights drawn from a
seeded ``torch.Generator``, and checks:

  * every kernel of the frame was launched during the frame (launch counters
    reset just before it and read just after);
  * each kernel equals its plain torch version on the inputs the frame gave
    it (indices, masks and compactions equal; squared distances bit-equal);
  * the frame is finite, of the expected shape, with every budget-overflow
    counter at zero, and the port's GPU path agrees with its CPU path on a
    small input.

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
                "compact_mask": ("cm_count", "cm_scan", "cm_scatter")}
# raised on the decoder's density bias for the small GPU-vs-CPU render, so
# that random weights draw an opaque body (as tests/test_torch_e2e.py does)
DENSITY_BIAS = 5.0
H = W = 512
DEPTH = 48
MARGIN = 1.15
FRAME_ITERS = 5
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).  The f32
# rate counts an FMA as two operations; the knn kernels' distance code is
# never contracted to FMAs, so each of its operations takes one issue slot
# and the ceiling they can reach is twice the bound printed from this rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# f32 operations per (query, vertex) pair in csrc/knn.cu
NN1_OPS_PER_PAIR = 9     # 3 sub, 3 mul, 2 add, 1 compare
RBM_OPS_PER_PAIR = 17    # 3 sub, 3+3 mul, 2+2 add (a, b), 2 mul, 1 sub, 1 min


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

    import sherf_tpu_torch  # noqa: F401 — fails outside a checkout
    from sherf_tpu_torch.core.calibrate import (
        calibrate_budgets, calibrate_sparse_caps, measure_sparse_sites)
    from sherf_tpu_torch.core.config import ModelConfig, RenderConfig
    from sherf_tpu_torch.core.diag import overflow_report
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch
    from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
    from sherf_tpu_torch.kernels import _cuda, compaction, knn
    from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
    from sherf_tpu_torch.smpl import big_pose_params, smpl_forward, synthetic_smpl

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

    # ---- frame: the main path, through the kernels ----------------------
    t0 = time.perf_counter()
    recorded = {"nn_1": [], "ray_body_mask": [], "compact_mask": []}
    shims = [(knn, "nn_1_cuda", "nn_1"),
             (knn, "ray_body_mask_cuda", "ray_body_mask"),
             (compaction, "compact_mask_cuda", "compact_mask")]
    originals = {}
    for mod, attr, key in shims:
        orig = getattr(mod, attr)
        originals[(mod, attr)] = orig

        def shim(*args, _orig=orig, _key=key):
            recorded[_key].append(args)
            return _orig(*args)
        setattr(mod, attr, shim)
    _cuda.reset_launches()
    try:
        out, diag = model(batch, smpl_d)
        torch.cuda.synchronize()
    finally:
        for (mod, attr), orig in originals.items():
            setattr(mod, attr, orig)
    launches = dict(_cuda.LAUNCHES)
    first_s = time.perf_counter() - t0
    img = out["image_raw"]
    overflow = overflow_report(diag)
    check(tuple(img.shape) == (1, H, W, 3), f"image shape {tuple(img.shape)}")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          "non-finite frame output")
    check(all(v == 0 for v in overflow.values()), f"budget overflow {overflow}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel was not launched by the frame: {launches}")
    frame_ms = []
    for _ in range(FRAME_ITERS):
        ts = time.perf_counter()
        model(batch, smpl_d)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - ts) * 1e3)
    acc = out["weights_image"]
    phase("frame", t0, first_frame_s=round(first_s, 3), launches=launches,
          overflow=overflow, frame_ms_median=statistics.median(frame_ms),
          frame_ms=frame_ms, acc_mean=float(acc.mean()),
          acc_max=float(acc.max()), peak_mem_gb=round(
              torch.cuda.max_memory_allocated() / 2 ** 30, 2))

    # ---- where one frame's device time goes (torch.profiler) -------------
    t0 = time.perf_counter()
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ts = time.perf_counter()
            model(batch, smpl_d)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - ts) * 1e3
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        # device-side events are the kernels; host-side ops carry the same
        # time again as the device time of the kernels they launched
        kernels = [e for e in ev if e.device_type != torch.autograd.DeviceType.CPU]
        ops = [e for e in ev if e.device_type == torch.autograd.DeviceType.CPU]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)
        port = {}
        for key, names in PORT_KERNELS.items():
            mine = [e for e in kernels if any(nm in e.key for nm in names)]
            port[key] = {"device_ms": sum(e.self_device_time_total
                                          for e in mine) / 1e3,
                         "kernels": sum(e.count for e in mine)}
        phase("profile", t0, frame_wall_ms_profiled=wall_ms,
              device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
              kernel_launches=sum(e.count for e in kernels),
              port_kernels=port,
              top_ops=[{"op": e.key[:60], "device_ms": e.self_device_time_total / 1e3,
                        "calls": e.count} for e in top[:15]])
    except Exception as e:  # noqa: BLE001 — the profile is informative only
        phase("profile", t0, error=repr(e))

    # ---- kernels vs their plain versions on the frame's own inputs -------
    # (these direct *_cuda calls add to LAUNCHES, which was read above)
    t0 = time.perf_counter()
    rows, cases = [], []
    errs = {"nn_1": 0.0, "ray_body_mask": 0.0, "compact_mask": 0.0}

    def note_err(key, a, b):
        e = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        errs[key] = max(errs[key], e)
        return e

    def bound(ops, nbytes):
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    # nn_1: every call of the frame checked; the point-budget call timed
    for i, (q_c, v_c) in enumerate(recorded["nn_1"]):
        d2k, ik = knn.nn_1_cuda(q_c, v_c)
        d2p, ip = knn.nn_1_plain(q_c, v_c)
        torch.cuda.synchronize()
        err = note_err("nn_1", d2k, d2p)
        note_err("nn_1", ik, ip)
        check(torch.equal(ik, ip), f"nn_1 call {i}: indices differ")
        check(torch.equal(d2k, d2p), f"nn_1 call {i}: d2 not bit-equal "
              f"(max abs err {err})")
        cases.append({"kernel": "nn_1", "call": i, "n": q_c.shape[0],
                      "v": v_c.shape[0], "equal": True})
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
        "replaces": "sherf_tpu/kernels/knn_pallas.py:608",
        "launches": launches["nn_1"], "max_abs_err": errs["nn_1"],
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
        "launches": launches["ray_body_mask"],
        "max_abs_err": errs["ray_body_mask"],
        "ms": cuda_ms(lambda: knn.ray_body_mask_cuda(o_c, d, v_c, thr, act), 5,
                      torch),
        "plain_ms": cuda_ms(lambda: knn.ray_body_mask_plain(o_c, d, v_c, thr,
                                                            act), 3, torch),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "n": n,
        "rays_scanned": n_scanned})

    # compact_mask: every call of the frame, plus the frame's occupancy over
    # all 512*512*48 samples (what the point compaction reads without ray
    # compaction) at the point budget
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
        "launches": launches["compact_mask"],
        "max_abs_err": errs["compact_mask"],
        "ms": cuda_ms(lambda: compaction.compact_mask_cuda(m, cap), 5, torch),
        "plain_ms": cuda_ms(lambda: compaction.compact_mask_plain(m, cap), 3,
                            torch),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(compact_library, 5, torch), "n": m.shape[0],
        "cap": cap})
    phase("kernels", t0, cases=cases)

    # ---- agreement with the CPU path on a small input --------------------
    t0 = time.perf_counter()
    small_cfg = dataclasses.replace(
        cfg, compute_dtype="float32",
        render=RenderConfig(depth_resolution=16, density_noise=0.0))
    small = SHERFGenerator(small_cfg, out_sh=out_sh, device="cpu")
    state = model.state_dict()
    state["renderer.decoder.alpha.bias"] = (
        state["renderer.decoder.alpha.bias"] + DENSITY_BIAS)
    small.load_state_dict(state)
    small_batch = make_synthetic_batch(smpl, batch_size=1, H=24, W=24, seed=1,
                                       device="cpu")
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
