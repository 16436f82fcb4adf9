#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port runs on a GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU (Hopper,
sm_90a):

    python3 chip_smoke.py

It builds the port's CUDA kernels with nvcc and drives the paths of
``sherf_tpu_torch`` at the production configuration (512x512 rays x 48
samples, bf16, calibrated budgets — the configuration of ``bench.py``),
with random weights drawn from a seeded ``torch.Generator``:

  * serving: one rendered frame (phases ``frame`` and ``profile``);
  * the clustered-KNN serving configurations on the same scene and weights:
    ``knn_cluster.CLUSTERED`` on (phase ``cluster_frame``), and on with
    ``render.knn_shortlist = 8`` (phase ``shortlist_frame``);
  * training: five steps of ``make_train_step`` at batch 1 (phases
    ``train`` and ``train_profile``), then a 2-step ``training_loop`` that
    writes stats.jsonl, a checkpoint and a sample grid (phase
    ``train_loop``);
  * the train -> snapshot -> eval lifecycle at the CLIs' defaults (f32,
    synthetic_grid rig, phase ``lifecycle``): 4 ``training_loop`` steps
    through ``build_dataset`` with calibrated budgets, a snapshot, then
    ``sherf_tpu_torch.cli.eval.main`` on it (17 renders of subject100 with
    PNGs and psnr_ / ssim_*.npy), each render's launches counted and its
    item build, forward, metrics and PNG writes timed, one render profiled,
    one item re-rendered outside ``run_eval`` bit-equal to a model restored
    here from the snapshot's EMA, and each training subject and the
    held-out subject100 and subject101 voxelized into the eval grid at its
    caps against their own grid (sites cut off, overflow);
  * the file-backed loaders (phase ``loaders``): the committed JPEG
    fixtures (``tests/fixtures/jpeg``) decoded by the port bit-equal to
    PIL's stored decodes, each timed; then a HuMMan tree (1920x1080 PNGs,
    scaled 1/3 to 640x360) and a RenderPeople tree (512x512, every image a
    copy of the 512x512 JPEG fixture) written from the synthetic_grid
    rig's bodies and ring cameras, only the frames the runs read; on each,
    ``sherf_tpu_torch.cli.train.main`` for 3 steps at its defaults (batch
    4, f32, 48 samples, budgets calibrated at margin 1.5) and
    ``sherf_tpu_torch.cli.eval.main`` on the snapshot for the held-out
    subject (the protocol cut to one observation view and two poses),
    with a random LPIPS state dict through ``SHERF_LPIPS_WEIGHTS``: item
    build ms split into decode, resize, mask and rays, LPIPS ms in a step
    and a render, step and render ms, overflow 0, lpips_*.npy written,
    and the kernel calls of the first step (4 items) and the first render
    held against their plain versions;
  * the off-default model branches at the frame's configuration (phase
    ``branches``): the importance frame (48 + 48 samples, budgets
    calibrated with the pass on), the same with the cluster shortlist on
    (B6), 3 train steps with it (random u and density noise from the
    step's generator), the capsule-prune frame (its point budget from its
    own survivors; >= 45 dB from the default frame), the OSG-decoder frame
    and the SR frame (8XDC, 512 -> 128 -> 512): frame ms, caps,
    survivors, overflow 0, the fine pass's nn_1 and compact_mask calls
    timed, the capsule test and the SR head timed; then the four
    configurations at 24x24 rays in f32 on the card and on the CPU, each
    >= 45 dB apart;
  * the render-side entry points (phase ``render_clis``) at the CLIs'
    model (default widths, f32, point budget 0.25 uncalibrated):
    ``gen_videos`` (4 orbit frames at 512x512x48, an animated GIF),
    ``gen_samples --shapes`` (a frame, then ``query_canonical`` on 128^3
    canonical points in 32 chunks of 65,536, the .mrc volume and the
    host's marching tetrahedra), ``render_demo`` at 512, ``debug_project``
    on the loaders' HuMMan tree, and the visualizer served on an ephemeral
    localhost port (rgb, depth, cross-section, the layer list and a layer
    heatmap at 512, from a reference pickle at the production widths
    written here): frame, chunk and render ms, peak memory, launches per
    frame (2 nn_1, 4 compact_mask) and per chunk (1 nn_1, 3
    compact_mask), overflow 0, every file read back with the port's own
    readers; one orbit frame's and one chunk's kernel calls held against
    their plain versions; ``query_canonical`` card against CPU on 4,096
    points at a small configuration (within 1e-4 relative);
  * the adversarial training path (phase ``gan``): 3 rounds of
    ``train/gan.py``'s phases (G phase, Dmain, Dreg on rounds 1 and 3) at
    the train phase's configuration with a DualDiscriminator at 512
    (channel_base 32768, channel_max 512), adv_weight 0.1, d_reg_interval
    2: each phase's ms, peak memory, launches; D's inputs f32 in the bf16
    run; then one round at 24x24 in f32 on the card against the CPU (each
    phase's gradients from the same weights, relative L2 <= 1e-3); then
    ``sherf_tpu_torch.cli.train.main --adv_weight 0.1`` for 2 steps on the
    synthetic_grid rig (stats.jsonl with the D metrics, a snapshot);
  * the GAN metric suite (phase ``gan_metrics``):
    ``sherf_tpu_torch.cli.calc_metrics.main`` on the card with ``--resume``
    on that snapshot, FID / KID / PR / IS / PPL / EQ-T / EQ-R over 8 items
    at 128x128, with seeded random Inception and LPIPS state dicts written
    here; InceptionV3's ms per batch of 8 at 299, and its card features
    against the CPU's on 2 images of 320x320 (rtol / atol 1e-3).

  * the native host-ops library (phase ``native``, before the frame):
    ``sherf_tpu_torch/native`` built with this machine's g++, its rays
    against numpy's at 512x512 and 640x360 (the tests' bounds) and both
    timed, as rays and inside a loader item;
  * the image-folder dataset tool (phase ``dataset_tool``): a tree of
    PNG / JPEG / BMP written here packed at 256x256 center-crop and read
    back through ``ImageFolderDataset``;
  * StyleGAN3 and ADA (phase ``sg3_ada``, after ``dataset_tool``): an
    ``SG3Generator`` at StyleGAN3-T's published 512 widths (z / w 512, 14
    layers, channel_base 32768, channel_max 512, 2 mapping layers; random
    weights from seed 0, f32, TF32 off, batch 4): forward ms (median of
    5), peak memory, finiteness; card against CPU (relative L2 <= 1e-5) on
    the tests' small configuration whole and on layers L0, L13 and L14 of
    the 512 network, fed the inputs the card's forward gave them; the
    ``AugmentPipe`` at 512, batch 32, with the reference's ``bgc`` knobs
    plus ``imgfilter``, ``noise`` and ``cutout`` at p = 0.6: ms a batch
    (median of 10), card against CPU with the card's draws replayed (max
    abs <= 1e-4), p = 0 the identity without ``imgfilter`` (<= 1e-4; the
    JAX pipe's band filter is not the identity at p = 0), xflip alone exactly a
    mirror or the identity per image; ``dataset_tool`` packing an
    enlarging transform and the zip read back; an Adam7 PNG written here
    read equal to the non-interlaced file of the same pixels;
  * TF32 (phase ``tf32``): the CLIs' f32 model at the frame's scene run
    with PyTorch's TF32 default and with TF32 off (one render's PSNR, one
    train step's loss and gradients, InceptionV3 features), then every
    CLI's ``resolve_device`` must turn TF32 off;
  * multi-process training (phase ``parallel``, after ``gan_metrics``):
    two ranks on the card (gloo) at meshes (1, 2) and (2, 1), each running
    a sharded render, train step and GAN round at the production
    configuration on its shard, held by rank 0 to the one-process phases on
    the same items (``parallel/reference.py``), every rank's launches,
    overflow and parameters checked; each rank's step timed and profiled.

For each path the launch counters are reset just before it and read just
after, and must be what the path launches (the importance frame: 4 nn_1,
1 ray_body_mask, 9 compact_mask; with the shortlist: 4 nn_1_shortlist, 4
cluster_prep, 1 ray_body_mask, 9 compact_mask; its train step adds 6
weighted_accumulate; the capsule, OSG and SR frames: the frame's) (the frame: 2 nn_1, 1
ray_body_mask, 6 compact_mask; cluster_frame: 2 nn_1_clustered, 1
ray_body_mask_clustered, 3 cluster_prep, 6 compact_mask; shortlist_frame:
2 nn_1_shortlist, 1 ray_body_mask_clustered, 3 cluster_prep, 6
compact_mask; the train step, per step: 3 weighted_accumulate, 2 nn_1, 1
ray_body_mask, 6 compact_mask; each eval render of the lifecycle: the
frame's; each loaders train step: the train step's, once an item of its
batch of 4; each loaders render: the frame's; each GAN round: the train
step's in the G phase, the frame's in Dmain, none in Dreg).  It checks
that each kernel
agrees with its plain torch version
on the inputs the paths gave it (every call of the frames, of the first
train step, of the branches' frames and first importance train step, and
of the lifecycle's first train step and first eval render, and of the
first GAN round's G phase and Dmain:
indices, masks and compactions equal; squared distances bit-equal; the
cluster prep's order, rows, centre, centroids and radii bit-equal;
nn_1_shortlist's tile lists equal; the table gradient within the f32
reassociation bound of the same products summed in f64), that each public
clustered wrapper issues at most 3 device operations a call (profiler; B7
on the frame's strided rays), that each clustered call agrees with the full-scan kernel on the same inputs,
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
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

WATCHDOG_S = 1150
# device-side names of the port's own CUDA kernels (csrc/*.cu)
PORT_KERNELS = {"nn_1": ("nn1_kernel",),
                "ray_body_mask": ("ray_mask_tiles_kernel",),
                "compact_mask": ("compact_lookback_kernel",),
                "weighted_accumulate": ("wa_kernel",),
                "nn_1_clustered": ("nn1_cluster_kernel",),
                "nn_1_shortlist": ("nn1_shortlist_kernel",),
                "ray_body_mask_clustered": ("ray_mask_cluster_kernel",),
                "cluster_prep": ("cluster_prep_kernel",)}
NONE = dict.fromkeys(PORT_KERNELS, 0)
# launches per frame at batch 1: point + canonical KNN, one ray mask, ray /
# point / exact compaction + 3 sparse-conv downsamples
FRAME_LAUNCHES = {**NONE, "nn_1": 2, "ray_body_mask": 1, "compact_mask": 6}
# ... with the clustered KNNs: each clustered call also runs the prep kernel
CLUSTER_LAUNCHES = {**NONE, "nn_1_clustered": 2, "ray_body_mask_clustered": 1,
                    "cluster_prep": 3, "compact_mask": 6}
SHORTLIST_LAUNCHES = {**NONE, "nn_1_shortlist": 2,
                      "ray_body_mask_clustered": 1, "cluster_prep": 3,
                      "compact_mask": 6}
# device operations (kernels and memsets) a clustered wrapper may issue: the
# prep, a memset and its kernel
CLUSTER_WRAPPER_OPS = 3
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
# the lifecycle phase: train steps and the budget margin of
# tools/lifecycle_artifact.sh
LIFE_STEPS = 4
LIFE_MARGIN = 1.5
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).  The f32
# rate counts an FMA as two operations; the knn kernels' distance code is
# never contracted to FMAs, so each of its operations takes one issue slot
# and the ceiling they can reach is twice the bound printed from this rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# f32 operations per (query, vertex) pair in csrc/knn.cu and knn_cluster.cu
NN1_OPS_PER_PAIR = 9     # 3 sub, 3 mul, 2 add, 1 compare
RBM_OPS_PER_PAIR = 17    # 3 sub, 3+3 mul, 2+2 add (a, b), 2 mul, 1 sub, 1 min
# ... of which w = v - o and a = |w|^2 (3 sub, 3 mul, 2 add) depend on the
# ray's origin only: rays that share an origin share them
RBM_OPS_PER_ORIGIN = 8
# ray_body_mask_clustered's quick rejection of a (ray, cluster) is a pair's
# 17 operations against the centroid (8 of them the origin's); a (ray,
# cluster) that passes it takes the square-root test: clamp, sqrt, mul,
# sub, clamp, mul, compare
RBMC_EXACT_OPS = 7
# the quick rejection's margin (kRejectGrow in csrc/knn_cluster.cu)
RBMC_REJECT_GROW = 1.001
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


def warp_union_pairs(o_c, d, cl, thr, torch):
    """The (ray, vertex) pairs the first ray_body_mask_clustered kernel
    (one ray a thread) scanned, from the plain version's bound table: a
    warp of 32 consecutive rays entered cluster c where any of its rays had
    not hit and had lb < thr, and each of its rays that had not hit scanned
    the rows up to its first hit (all of them where none hit).  Returns
    (pairs, lane_slots): lane_slots counts 32 lanes for each row the
    warp's slowest lane scanned."""
    from sherf_tpu_torch.kernels import knn_cluster
    dd_inv, lb = knn_cluster.ray_cluster_bounds(o_c, d, cl)
    n, C = lb.shape
    t = torch.tensor(thr, dtype=torch.float32, device=o_c.device)
    rows = cl.rows
    hit = torch.zeros(n, dtype=torch.bool, device=o_c.device)
    pairs = slots = 0
    for c in range(C):
        want = ~hit & (lb[:, c] < t)
        warp_in = torch.nn.functional.pad(want, (0, -n % 32)).reshape(
            -1, 32).any(dim=1).repeat_interleave(32)[:n]
        sel = torch.nonzero(warp_in & ~hit).flatten()
        if sel.numel() == 0:
            continue
        j0 = c * cl.csize
        below = knn_cluster._line_terms(o_c[sel], d[sel], dd_inv[sel],
                                        cl.vs[j0:j0 + cl.csize]) < t
        any_b = below.any(dim=1)
        scanned = torch.where(any_b, below.int().argmax(dim=1) + 1, rows[c])
        pairs += int(scanned.sum())
        per_warp = torch.zeros(-(-n // 32), dtype=torch.int64,
                               device=o_c.device).scatter_reduce(
            0, sel // 32, scanned.long(), reduce="amax")
        slots += 32 * int(per_warp.sum())
        hit[sel] |= any_b
    return pairs, slots


def near_pairs(o_c, d, cl, thr, torch):
    """The (ray, cluster) pairs that pass ray_body_mask_clustered's quick
    rejection, dl2 < ((sqrt(thr) + r_c) 1.001)^2 in the kernel's f32
    operations, and so take its square-root test."""
    from sherf_tpu_torch.kernels import knn_cluster
    f32 = torch.float32
    dd_inv, _ = knn_cluster.ray_cluster_bounds(o_c, d, cl)
    dl2 = knn_cluster._line_terms(o_c, d, dd_inv, cl.cent)
    root = math.sqrt(float(torch.tensor(thr, dtype=f32)))
    rj = ((torch.tensor(root, dtype=f32, device=o_c.device) + cl.rad)
          * torch.tensor(RBMC_REJECT_GROW, dtype=f32, device=o_c.device))
    return int((dl2 < rj * rj).sum())


def rbmc_ops(n, nv, nc, pairs, origins, near):
    """The f32 operations ray_body_mask_clustered needs: each (ray, cluster)
    quick rejection and each admitted (ray, vertex) pair at 9, with w and a
    (8) once per origin and centroid or vertex, and the square-root test of
    the ``near`` pairs that pass the rejection."""
    shared = RBM_OPS_PER_PAIR - RBM_OPS_PER_ORIGIN
    return (shared * pairs + RBM_OPS_PER_ORIGIN * min(origins * nv, pairs)
            + shared * n * nc + RBM_OPS_PER_ORIGIN * min(origins, n) * nc
            + RBMC_EXACT_OPS * near)


def profiled(fn, torch, expect):
    """Run ``fn`` once under torch.profiler: wall ms, device busy ms (sum of
    kernel times), idle share, the port's kernels and the top ops.  Fails
    unless each port kernel that ``expect`` says ``fn`` launches shows that
    many device kernels with nonzero device time (a renamed kernel would
    otherwise drop out of the sum unseen)."""
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
        if expect[key]:
            check(port[key]["kernels"] == expect[key]
                  and port[key]["device_ms"] > 0,
                  f"profile: {key} shows {port[key]}, expected "
                  f"{expect[key]} kernels with device time")
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "port_kernels_ms": sum(v["device_ms"] for v in port.values()),
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


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def held_nn_1(torch, what, q_c, v_c):
    """nn_1 on one recorded call against its plain version: indices equal,
    d2 bit-equal.  Returns (case, max abs error)."""
    from sherf_tpu_torch.kernels import knn
    d2k, ik = knn.nn_1_cuda(q_c, v_c)
    d2p, ip = knn.nn_1_plain(q_c, v_c)
    torch.cuda.synchronize()
    err = max_abs(d2k, d2p)
    check(torch.equal(ik, ip), f"{what}: indices differ")
    check(torch.equal(d2k, d2p), f"{what}: d2 not bit-equal (max abs err "
          f"{err})")
    return ({"n": q_c.shape[0], "v": v_c.shape[0], "equal": True},
            max(err, max_abs(ik, ip)))


def held_ray_body_mask(torch, what, o_c, d, v_c, thr, act):
    """ray_body_mask on one recorded call against its plain version: masks
    equal."""
    from sherf_tpu_torch.kernels import knn
    mk = knn.ray_body_mask_cuda(o_c, d, v_c, thr, act)
    mp = knn.ray_body_mask_plain(o_c, d, v_c, thr, act)
    torch.cuda.synchronize()
    check(torch.equal(mk, mp), f"{what}: masks differ "
          f"({int((mk != mp).sum())} rays)")
    return ({"n": o_c.shape[0], "hits": int(mk.sum()), "equal": True},
            max_abs(mk, mp))


def held_compact_mask(torch, what, m, cap):
    """compact_mask on one recorded call against its plain version: indices
    and validity equal."""
    from sherf_tpu_torch.kernels import compaction
    ik, vk = compaction.compact_mask_cuda(m, cap)
    ip, vp = compaction.compact_mask_plain(m, cap)
    torch.cuda.synchronize()
    check(torch.equal(ik, ip) and torch.equal(vk, vp),
          f"{what} (n={m.shape[0]}, cap={cap}): differs")
    return ({"n": m.shape[0], "cap": cap, "survivors": int(m.sum()),
             "equal": True}, max(max_abs(ik, ip), max_abs(vk, vp)))


def held_weighted_accumulate(torch, what, ids, w, g, n_rows):
    """weighted_accumulate on one recorded call, within the f32
    reassociation bound of the atomics' sum order, held against the same
    deduplicated bf16 products summed in f64 (each product is exact in f32,
    so that sum is true to ~1e-16; the plain version's own f32 index_add_
    drifts by most of the bound on the zero row).  The case also says how
    much of the bound the kernel uses against the true sum (bound_use), how
    much the plain version uses (plain_use, its own f32 rounding, reported,
    not checked), and how far a second run of the plain version (f32
    atomics) lands from the first (plain_spread).  The error returned is
    against the plain version."""
    from sherf_tpu_torch.kernels import segment_accum as sa
    got = sa.weighted_accumulate_cuda(ids, w, g, n_rows)
    ref = sa.weighted_accumulate_plain(ids, w, g, n_rows)
    ref64 = sa.weighted_accumulate_plain(ids, w, g, n_rows,
                                         dtype=torch.float64)
    mag = sa.weighted_accumulate_plain(ids, w.abs(), g.abs(), n_rows)
    ref2 = sa.weighted_accumulate_plain(ids, w, g, n_rows)
    torch.cuda.synchronize()
    fin, bnd = torch.isfinite(ref64), (1e-5 * mag).clamp(min=1e-30)
    use = {"bound_use": float(((got - ref64).abs() / bnd)[fin].max()),
           "plain_use": float(((ref - ref64).abs() / bnd)[fin].max()),
           "plain_spread": float(((ref2 - ref).abs() / bnd)[fin].max())}
    e = max_abs(got, ref)
    for same in (torch.isnan, torch.isposinf, torch.isneginf):
        check(torch.equal(same(got), same(ref64)),
              f"{what}: {same.__name__} entries differ from the f64 "
              f"reference")
    excess = float(((got - ref64).abs() - 1e-5 * mag)[fin].max())
    check(excess <= 1e-30, f"{what}: |cuda - ref64| exceeds 1e-5 * "
          f"plain(|w|, |g|) by {excess} (max abs err vs plain {e}; {use})")
    return ({"n": ids.shape[0], "k": ids.shape[1], "c": g.shape[1],
             "n_rows": n_rows, "max_abs_err": e, "within_bound": True,
             **use}, e)


def kernel_shims():
    """The Recorder's list for the four kernels of the default path."""
    from sherf_tpu_torch.kernels import compaction, knn, segment_accum
    return [(knn, "nn_1_cuda", "nn_1"),
            (knn, "ray_body_mask_cuda", "ray_body_mask"),
            (compaction, "compact_mask_cuda", "compact_mask"),
            (segment_accum, "weighted_accumulate_cuda",
             "weighted_accumulate")]


HELD = {"nn_1": held_nn_1, "ray_body_mask": held_ray_body_mask,
        "compact_mask": held_compact_mask,
        "weighted_accumulate": held_weighted_accumulate}


def held_calls(torch, calls, path, errs):
    """Every call a Recorder kept (``calls``) held against its kernel's
    plain version (``HELD``); raises ``errs[kernel]`` to each call's max
    abs error and returns the cases."""
    cases = []
    for key, held in HELD.items():
        for i, args in enumerate(calls.get(key, ())):
            case, err = held(torch, f"{key} call {i} ({path})", *args)
            errs[key] = max(errs[key], err)
            cases.append({"kernel": key, "path": path, "call": i, **case})
    return cases


def grid_sites(torch, t_verts, shape, caps, voxel_size, dev):
    """A canonical body (numpy) voxelized as the generator voxelizes it,
    into a grid of ``shape``: its vertices inside the grid, and the
    occupied sites and overflow of each sparse downsample at ``caps``."""
    from sherf_tpu_torch.features.sparseconv import (
        _inbounds, downsample_sites, voxelize_coords)
    tv = torch.from_numpy(t_verts).to(dev)
    coords = voxelize_coords(tv, (tv.amin(dim=0) - 0.05)[[2, 1, 0]],
                             voxel_size)
    valid = _inbounds(coords, shape)
    inside = int(valid.sum())
    sites, over = [], []
    for cap in caps:
        coords, valid, shape, ovf = downsample_sites(coords, valid, shape, cap)
        over.append(int(ovf))
        sites.append(int(valid.sum()) + over[-1])
    return {"vertices_inside": inside, "sites": sites, "overflow": over}


class Timed:
    """Within ``with``: each listed (owner, attribute, key) callable is
    wrapped to append its wall ms, between CUDA synchronises (none with
    ``sync=False``: for host work in the loader's threads), to
    ``ms[key]``; ``ms`` keeps the calls in order."""

    def __init__(self, torch, targets, sync=True):
        self.torch, self.targets, self.sync = torch, targets, sync
        self.ms = {key: [] for _, _, key in targets}
        self._orig = []

    def __enter__(self):
        sync = self.torch.cuda.synchronize if self.sync else (lambda: None)
        for owner, attr, key in self.targets:
            orig = getattr(owner, attr)
            self._orig.append((owner, attr, orig))

            def timed(*args, _orig=orig, _key=key, **kwargs):
                sync()
                ts = time.perf_counter()
                out = _orig(*args, **kwargs)
                sync()
                self.ms[_key].append((time.perf_counter() - ts) * 1e3)
                return out
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._orig):
            setattr(owner, attr, orig)


def lifecycle(torch, np, dev, smpl_d, out_dir, shims):
    """The reference's central workflow (tools/lifecycle_artifact.sh) at the
    CLIs' defaults (512x512x48, f32, backbone 256, 5 mm voxels, 4
    sparse-conv layers, point budget 1/8) on the synthetic_grid rig:
    ``training_loop`` through ``build_dataset`` for LIFE_STEPS steps at
    batch 1 with budgets calibrated at margin 1.5, a snapshot, then
    ``sherf_tpu_torch.cli.eval.main`` on it (8 novel-view and 9 novel-pose
    renders of subject100).  Returns the phase's numbers, and the cases and
    max abs errors of the kernel calls of its first train step and first
    render, each held against its plain version (``held_calls``: these
    calls are f32, at budgets calibrated at margin 1.5).  Fails unless
    every PNG triple and metric file exists, every metric is finite, each
    render launches the frame's kernels, those calls agree with their
    plain versions, and one item re-rendered outside ``run_eval`` by the
    CLI's render function is bit-equal to the forward of a model this
    function restores from the snapshot's EMA itself.  Also reports each
    training subject and the held-out subject100 and subject101 in the
    eval grid and caps against their own grid."""
    import argparse
    import dataclasses
    import warnings

    from sherf_tpu_torch.cli import common as cli_common
    from sherf_tpu_torch.cli import eval as eval_cli
    from sherf_tpu_torch.cli.train import DATA_DEFAULTS
    from sherf_tpu_torch.core.config import DataConfig, TrainConfig
    from sherf_tpu_torch.data import collate
    from sherf_tpu_torch.data.synthetic import SyntheticHumanDataset
    from sherf_tpu_torch.eval import test_loop
    from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
    from sherf_tpu_torch.kernels import _cuda
    from sherf_tpu_torch.models.generator import SHERFGenerator
    from sherf_tpu_torch.train import loop as train_loop
    from sherf_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                  restore_checkpoint)
    from sherf_tpu_torch.train.train_state import create_train_state

    flags = argparse.ArgumentParser()
    cli_common.add_model_flags(flags)
    cfg = cli_common.model_config_from_args(flags.parse_args([]))
    check(cfg.compute_dtype == "float32" and cfg.backbone_resolution == 256
          and cfg.render.depth_resolution == 48, f"CLI defaults {cfg}")
    run_dir = os.path.join(out_dir, "run")
    dcfg = DataConfig(name="synthetic_grid", image_scaling=1.0,
                      **DATA_DEFAULTS["synthetic_grid"])
    tcfg = TrainConfig(total_kimg=LIFE_STEPS / 1000, batch_size=1, lr=1e-3,
                       snapshot_ticks=100, outdir=run_dir)

    # ---- train: each step timed and its launches counted, the first
    # step's kernel calls kept
    step_ms, step_launches = [], []
    orig_make = train_loop.make_train_step
    rec_train = Recorder(shims)
    rec_train.on = False

    def make_counted_step(*args, **kwargs):
        step = orig_make(*args, **kwargs)

        def counted(*sargs):
            seen = dict(_cuda.LAUNCHES)
            torch.cuda.synchronize()
            rec_train.on = not step_ms
            ts = time.perf_counter()
            out = step(*sargs)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            rec_train.on = False
            step_launches.append({k: _cuda.LAUNCHES[k] - seen[k] for k in seen})
            return out
        return counted

    t_train = time.perf_counter()
    train_loop.make_train_step = make_counted_step
    try:
        with rec_train:
            _cuda.reset_launches()
            state = train_loop.training_loop(cfg, tcfg, dcfg, smpl_d,
                                             calibrate=LIFE_MARGIN, device=dev)
            torch.cuda.synchronize()
            train_launches = dict(_cuda.LAUNCHES)
    finally:
        train_loop.make_train_step = orig_make
    train_s = time.perf_counter() - t_train
    snap = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    check(state.step == LIFE_STEPS and snap is not None
          and snap.endswith(f"snapshot-{LIFE_STEPS:06d}.pt"),
          f"lifecycle training: step {state.step}, snapshot {snap}")
    check(os.path.exists(os.path.join(run_dir, f"fakes{LIFE_STEPS:06d}.png")),
          "lifecycle training wrote no sample grid")
    check(all(n == TRAIN_LAUNCHES for n in step_launches),
          f"lifecycle train step launches {step_launches}")
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        loss = [json.loads(x) for x in f if "Loss/loss" in x]
    check(loss and all(np.isfinite(x["Loss/loss"]) and x["Loss/overflow"] == 0
                       for x in loss), f"lifecycle training metrics {loss}")
    train_out_sh = state.model.renderer.out_sh
    train_caps = state.model.cfg.sparse_caps
    train_budgets = dataclasses.asdict(state.model.cfg.render)
    del state
    torch.cuda.empty_cache()

    # ---- eval: the CLI on the snapshot, every render counted and timed,
    # the first render's kernel calls kept; the calibration sweep timed
    eval_dir = os.path.join(out_dir, "eval")
    seen = {}
    renders = []
    orig_run_eval, orig_build = test_loop.run_eval, eval_cli.build_model
    orig_calibrated = eval_cli.calibrated_config
    rec_eval = Recorder(shims)
    rec_eval.on = False

    def build_recorded(*args, **kwargs):
        seen["model"] = orig_build(*args, **kwargs)
        return seen["model"]

    def calibrated_timed(*args, **kwargs):
        items = len(timers.ms["item"])
        ts = time.perf_counter()
        out = orig_calibrated(*args, **kwargs)
        seen["calibration_s"] = time.perf_counter() - ts
        seen["calibration_items"] = len(timers.ms["item"]) - items
        return out

    def run_eval_counted(render_fn, make_dataset, *args, **kwargs):
        seen["render_fn"], seen["make_dataset"] = render_fn, make_dataset

        def render(batch):
            before = dict(_cuda.LAUNCHES)
            rec_eval.on = not renders
            out = render_fn(batch)
            rec_eval.on = False
            renders.append({k: _cuda.LAUNCHES[k] - before[k] for k in before})
            return out
        return orig_run_eval(render, make_dataset, *args, **kwargs)

    argv = ["--cfg", "synthetic_grid", "--data", "subject100",
            "--subjects", "subject100", "--resume", snap, "--outdir", eval_dir,
            "--calibrate_budgets", "true", "--calibrate_margin",
            str(LIFE_MARGIN)]
    timers = Timed(torch, [
        (SyntheticHumanDataset, "__getitem__", "item"),
        (test_loop, "collate", "collate"),
        (test_loop, "_render_item", "render"),
        (test_loop, "psnr_np", "psnr"), (test_loop, "crop_metrics", "ssim"),
        (test_loop, "write_png", "png")])
    t_eval = time.perf_counter()
    test_loop.run_eval, eval_cli.build_model = run_eval_counted, build_recorded
    eval_cli.calibrated_config = calibrated_timed
    try:
        with timers, rec_eval:
            _cuda.reset_launches()
            results = eval_cli.main(argv)
            torch.cuda.synchronize()
            eval_launches = dict(_cuda.LAUNCHES)
    finally:
        test_loop.run_eval, eval_cli.build_model = orig_run_eval, orig_build
        eval_cli.calibrated_config = orig_calibrated
    eval_s = time.perf_counter() - t_eval

    files = sorted(os.path.relpath(os.path.join(d, f), eval_dir)
                   for d, _, fs in os.walk(eval_dir) for f in fs)
    inputs = [f[:-len("_input.png")] for f in files if f.endswith("_input.png")]
    check(len(renders) == 17 and len(inputs) == 17,
          f"lifecycle eval: {len(renders)} renders, {len(inputs)} PNG triples")
    check(all(f"{t}.png" in files and f"{t}_gt.png" in files for t in inputs),
          "lifecycle eval: a PNG triple is incomplete")
    metric_files = [f for f in files if f.endswith(".npy")]
    for protocol in ("novel_view", "novel_pose"):
        for where in (protocol, f"{protocol}/obs_view_0/subject100"):
            for key in ("psnr", "ssim"):
                check(any(os.path.dirname(f) == where
                          and os.path.basename(f).startswith(key + "_")
                          for f in metric_files),
                      f"lifecycle eval: no {where}/{key}_*.npy")
        check(all(np.isfinite(results[protocol][k]) for k in ("psnr", "ssim")),
              f"lifecycle eval: {protocol} metrics {results[protocol]}")
    check(all(np.isfinite(np.load(os.path.join(eval_dir, f))).all()
              for f in metric_files), "lifecycle eval: a non-finite metric")
    check(all(r == FRAME_LAUNCHES for r in renders),
          f"lifecycle eval: launches per render {renders}")

    # ---- the kernel calls of the first train step and the first render,
    # each against its plain version
    for rec, expect, what in ((rec_train, TRAIN_LAUNCHES, "train step"),
                              (rec_eval, FRAME_LAUNCHES, "render")):
        kept = {k: len(v) for k, v in rec.calls.items()}
        check(kept == {k: expect[k] for k in kept},
              f"lifecycle: {kept} kernel calls kept from the first {what}")
    errs = dict.fromkeys(HELD, 0.0)
    cases = (held_calls(torch, rec_train.calls, "lifecycle_train", errs)
             + held_calls(torch, rec_eval.calls, "lifecycle_eval", errs))
    rec_train.calls.clear()
    rec_eval.calls.clear()

    # ---- one item re-rendered outside run_eval, against a model restored
    # here from the snapshot's EMA (deterministic index_add_ on both)
    _, eval_out_sh, eval_cfg = seen["model"]
    ds = seen["make_dataset"]("subject100", 0, 1, 4)
    ds.obs_view_index = 0
    batch = collate([ds[2]], dev)
    own = SHERFGenerator(eval_cfg, out_sh=eval_out_sh, device=dev)
    ema = restore_checkpoint(snap, create_train_state(own, TrainConfig())).ema
    with torch.no_grad():
        for name, p in own.named_parameters():
            p.copy_(ema[name])
    own.eval()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            via_cli = seen["render_fn"](batch)["image_raw"]
            with torch.inference_mode():
                mine, diag = own(batch, smpl_d)
        finally:
            torch.use_deterministic_algorithms(False)
    check(all(int(v) == 0 for v in diag.values()), "re-render overflow")
    check(torch.equal(via_cli, mine["image_raw"]),
          "the eval CLI's render is not bit-equal to the restored EMA "
          f"model's (max abs err "
          f"{float((via_cli - mine['image_raw']).abs().max())})")
    del own, ema, mine
    prof = profiled(lambda: seen["render_fn"](batch), torch, FRAME_LAUNCHES)

    # ---- does each subject fit the eval grid (sized from the default body,
    # as the JAX CLI does) and its sparse caps?  Each training subject and
    # the held-out subject100 and subject101, voxelized as the generator
    # does into the eval grid at the eval caps and into its own padded grid
    # (nothing cut off) at no cap
    bodies = [(f"subject{i}", tv) for i, tv in enumerate(
        train_loop.build_dataset(dcfg, smpl_d).subject_bodies())]
    bodies += [(name, seen["make_dataset"](name, 0, 1, 1).subject_bodies()[0])
               for name in ("subject100", "subject101")]
    vs = eval_cfg.voxel_size
    fit = {}
    for name, tv in bodies:
        own_sh = prepare_voxel_volume(tv, voxel_size=vs)[1]
        ev = grid_sites(torch, tv, tuple(eval_out_sh), eval_cfg.sparse_caps,
                        vs, dev)
        own = grid_sites(torch, tv, own_sh, (tv.shape[0] * 8,) * 3, vs, dev)
        fit[name] = {"own_grid": list(own_sh), "eval": ev,
                     "own_sites": own["sites"],
                     "sites_lost": [a - b for a, b in zip(own["sites"],
                                                          ev["sites"])]}
    ms = timers.ms
    # _render_item: collate, the forward, the outputs' copy to the host
    forward_ms = [r - c for r, c in zip(ms["render"], ms["collate"])]
    per_render = lambda key: statistics.median(ms[key]) if ms[key] else None
    return {
        "train_steps": LIFE_STEPS, "train_step_ms": step_ms,
        "train_step_ms_median_2_4": statistics.median(step_ms[1:]),
        "train_seconds": round(train_s, 3), "train_launches": train_launches,
        "train_budgets": {k: train_budgets[k] for k in (
            "ray_capacity_frac", "point_capacity_frac",
            "exact_capacity_frac", "prune_step_margin")},
        "eval_seconds": round(eval_s, 3), "eval_launches": eval_launches,
        "renders": len(renders), "launches_per_render": renders[0],
        "results": results, "metric_files": len(metric_files),
        "pngs": sum(f.endswith(".png") for f in files),
        "render_ms_median": {
            "item": per_render("item"), "collate": per_render("collate"),
            "forward_and_readback": statistics.median(forward_ms),
            "psnr": per_render("psnr"), "ssim": per_render("ssim"),
            "png_per_file": per_render("png")},
        "items_built": len(ms["item"]),
        "eval_budgets": {k: getattr(eval_cfg.render, k) for k in (
            "ray_capacity_frac", "point_capacity_frac",
            "exact_capacity_frac", "prune_step_margin")},
        "rerender_bit_equal": True,
        "forward_profiled": {k: prof[k] for k in (
            "wall_ms_profiled", "device_busy_ms", "device_idle_share",
            "kernel_launches", "port_kernels_ms")},
        "calibration_seconds": round(seen["calibration_s"], 3),
        "calibration_items_built": seen["calibration_items"],
        "grid_fit": {"eval_out_sh": list(eval_out_sh),
                     "train_out_sh": list(train_out_sh),
                     "eval_caps": list(eval_cfg.sparse_caps),
                     "train_caps": list(train_caps),
                     "vertices": bodies[0][1].shape[0],
                     "subjects_losing_sites": sorted(
                         n for n, f in fit.items() if any(f["sites_lost"])),
                     "subjects_overflowing": sorted(
                         n for n, f in fit.items() if any(f["eval"]["overflow"])),
                     "subjects": fit},
    }, cases, errs


# ---- the loaders phase: the file-backed datasets through the CLIs --------

# train steps a tree's train CLI run takes (at the CLI's default batch, 4)
LOADER_STEPS = 3
LOADER_BATCH = 4
# the eval protocols cut to one observation view and two poses a protocol
# (depth: the shipped protocols render 260 / 375 frames a subject)
LOADER_PROTOCOLS = {
    "renderpeople": dict(obs_views=(0,), nv_pose_start=0, np_pose_start=2,
                         pose_interval=2, pose_num=2),
    "humman": dict(obs_views=(0,), nv_pose_start=0, np_pose_start=0,
                   pose_interval=6, pose_num=2)}
LOADER_SIZES = {"renderpeople": (512, 512), "humman": (1080, 1920)}
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "jpeg")


def jpeg_fixtures(np):
    """Every committed JPEG fixture decoded by the port, held bit-equal to
    PIL's stored decode (a PNG, or the SHA-256 of the 1024x1024 one's
    bytes); the decode ms of each (median of 3)."""
    import glob
    import hashlib
    from sherf_tpu_torch.data.base import read_image
    out = {}
    names = sorted(glob.glob(os.path.join(FIXTURE_DIR, "*.jpg")))
    check(len(names) == 6, f"JPEG fixtures {names}")
    for path in names:
        ms = []
        for _ in range(3):
            ts = time.perf_counter()
            got = read_image(path)
            ms.append((time.perf_counter() - ts) * 1e3)
        stem = path[:-4]
        if os.path.exists(stem + ".decoded.png"):
            ok = np.array_equal(got, read_image(stem + ".decoded.png"))
        else:
            with open(stem + ".decoded.sha256") as f:
                ok = hashlib.sha256(got.tobytes()).hexdigest() == f.read().strip()
        check(ok, f"{path}: the port's decode is not PIL's")
        out[os.path.basename(path)] = {"shape": list(got.shape),
                                       "decode_ms": statistics.median(ms),
                                       "bit_equal": True}
    return out


def _frames_read(n_subjects, poses_num, interval, views, obs_view, batches):
    """(subject, pose file index, view) of every item the first
    ``batches`` batches of the training sampler read, with each item's
    observation view."""
    import itertools
    from sherf_tpu_torch.data.sampler import InfiniteSampler
    per = poses_num * views
    out = set()
    for k in itertools.islice(iter(InfiniteSampler(n_subjects * per, seed=0)),
                              LOADER_BATCH * batches):
        inst, pose = k // per, (k % per) // views * interval
        out.update({(inst, pose, k % views), (inst, pose, obs_view)})
    return out


def write_tree(np, name, root, smpl_cpu, train_cfg):
    """A RenderPeople- or HuMMan-layout tree under ``root``: training
    subjects 0 and 1 and held-out subject 2, bodies, poses and ring
    cameras of the synthetic_grid rig (``SyntheticHumanDataset``).  Only
    the frames the runs read are written: the training sampler's first
    batches (calibration, steps, the sample grid and the loader's
    read-ahead) and, for subject 2, every view of the protocol's poses.
    HuMMan: 1920x1080 PNGs of the splatted body; RenderPeople: 512x512, the
    masks drawn from the body but every image a copy of the committed
    512x512 JPEG fixture (the card has no JPEG encoder).  Returns the
    counts written."""
    import json as _json
    from sherf_tpu_torch.data.base import host_smpl_verts
    from sherf_tpu_torch.data.synthetic import (SyntheticDataset,
                                                SyntheticHumanDataset,
                                                _splat_image,
                                                fixed_ring_camera)
    from sherf_tpu_torch.data.sampler import PREFETCH
    from sherf_tpu_torch.eval.png import write_png

    H, W = LOADER_SIZES[name]
    rp = name == "renderpeople"
    views = 36 if rp else 10
    rig = SyntheticHumanDataset("subject0", smpl_cpu, resolution=64)
    proto = LOADER_PROTOCOLS[name]
    batches = 12 + LOADER_STEPS + 1 + PREFETCH + 2
    frames = _frames_read(2, train_cfg["poses_num"],
                          train_cfg["poses_interval"], views, 0, batches)
    eval_poses = sorted({proto[k] + i * proto["pose_interval"]
                         for k in ("nv_pose_start", "np_pose_start")
                         for i in range(proto["pose_num"])}
                        | {proto["np_pose_start"]})
    frames |= {(2, p, v) for p in eval_poses for v in range(views)}
    with open(os.path.join(FIXTURE_DIR, "person_512_420.jpg"), "rb") as f:
        jpeg = f.read()
    n_pose_files = max(p for _, p, _ in frames) + 1
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "human_list.txt"), "w") as f:
        f.write("".join(f"subject_{i}\n" for i in range(3)))
    cams = {}
    for v in range(views):
        K, R, T = fixed_ring_camera(H, W, v, views)
        cams[(f"camera{v:04d}" if rp else f"kinect_color_{v:03d}")] = {
            "K": K.tolist(), "R": R.tolist(), "T": T.reshape(3).tolist()}
    bodies = {}
    for sid in range(3):
        sub = os.path.join(root, f"subject_{sid}")
        os.makedirs(sub, exist_ok=True)
        with open(os.path.join(sub, "cameras.json"), "w") as f:
            _json.dump(cams, f)
        shape, phase = SyntheticDataset.subject_identity(sid)
        poses, transl = [], []
        for p in range(n_pose_files):
            pose, _, th = rig._pose_params(sid, p)
            poses.append(pose)
            transl.append(th)
            bodies[(sid, p)] = (pose, shape, th, phase)
        if rp:
            os.makedirs(os.path.join(sub, "outputs_re_fitting"), exist_ok=True)
            np.savez(os.path.join(sub, "outputs_re_fitting",
                                  "refit_smpl_2nd.npz"), smpl=dict(
                betas=shape, global_orient=np.stack(poses)[:, :3],
                body_pose=np.stack(poses)[:, 3:], transl=np.stack(transl)))
        else:
            os.makedirs(os.path.join(sub, "smpl_params"), exist_ok=True)
            for p in range(n_pose_files):
                np.savez(os.path.join(sub, "smpl_params", f"{p:06d}.npz"),
                         betas=shape[None], body_pose=poses[p][None, 3:],
                         global_orient=poses[p][None, :3],
                         transl=transl[p][None])
    posed = {}
    for sid, p, v in sorted(frames):
        pose, shape, th, phase = bodies[(sid, p)]
        if (sid, p) not in posed:
            posed[(sid, p)] = host_smpl_verts(smpl_cpu, pose, shape)[0] + th
        verts = posed[(sid, p)]
        K, R, T = fixed_ring_camera(H, W, v, views)
        img = _splat_image(H, W, K, R, T, verts, np.random.RandomState(0),
                           phase=phase)
        # the mask: each splatted vertex grown to a 9x9 square
        pix = (verts @ R.T + T[:, 0]) @ K.T
        xy = (pix[:, :2] / np.maximum(pix[:, 2:], 1e-5)).astype(np.int64)
        off = np.stack(np.meshgrid(np.arange(-4, 5), np.arange(-4, 5)),
                       -1).reshape(-1, 2)
        xy = (xy[:, None] + off[None]).reshape(-1, 2)
        xy = xy[(xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0)
                & (xy[:, 1] < H)]
        mask = np.zeros((H, W, 3), np.uint8)
        mask[xy[:, 1], xy[:, 0]] = 255
        sub = os.path.join(root, f"subject_{sid}")
        if rp:
            img_path = os.path.join(sub, "img", f"camera{v:04d}", f"{p:04d}.jpg")
            msk_path = os.path.join(sub, "mask", f"camera{v:04d}",
                                    f"{p:04d}.png")
        else:
            img_path = os.path.join(sub, "kinect_color", f"kinect_{v:03d}",
                                    f"{p:06d}.png")
            msk_path = os.path.join(sub, "kinect_mask", f"kinect_{v:03d}",
                                    f"{p:06d}.png")
        os.makedirs(os.path.dirname(img_path), exist_ok=True)
        os.makedirs(os.path.dirname(msk_path), exist_ok=True)
        if rp:
            with open(img_path, "wb") as f:
                f.write(jpeg)
        else:
            write_png(img_path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        write_png(msk_path, mask)
    return {"subjects": 3, "views": views, "pose_files": n_pose_files,
            "frames_written": len(frames),
            "train_frames": sum(1 for s, _, _ in frames if s < 2),
            "eval_frames": sum(1 for s, _, _ in frames if s == 2),
            "image": f"{W}x{H}"}


def loader_run(torch, np, dev, name, root, out_dir, shims):
    """The train CLI on ``name``'s tree (training subjects 0 and 1, the
    CLI's defaults: batch 4, f32, 512 / 640x360 x 48, budgets calibrated
    at margin 1.5) for LOADER_STEPS steps, then the eval CLI on the
    snapshot for held-out subject 2 (the protocol of LOADER_PROTOCOLS),
    with LPIPS in the loss and the metrics.  Each step and render counted
    and timed; the kernel calls of the first step and the first render
    held against their plain versions.  Returns (numbers, cases, errs)."""
    import dataclasses
    from sherf_tpu_torch.cli import eval as eval_cli
    from sherf_tpu_torch.cli import train as train_cli
    from sherf_tpu_torch.data import base as data_base
    from sherf_tpu_torch.eval import test_loop
    from sherf_tpu_torch.kernels import _cuda
    from sherf_tpu_torch.train import loop as train_loop
    from sherf_tpu_torch.train import lpips as t_lpips
    from sherf_tpu_torch.train.checkpoint import latest_checkpoint

    run_dir = os.path.join(out_dir, "run")
    eval_dir = os.path.join(out_dir, "eval")
    step_ms, step_launches, step_metrics, renders = [], [], [], []
    rec_train, rec_eval = Recorder(shims), Recorder(shims)
    rec_train.on = rec_eval.on = False
    orig = {"make": train_loop.make_train_step, "loop": train_loop.training_loop,
            "run_eval": test_loop.run_eval,
            "protocol": dict(eval_cli.EVAL_DEFAULTS),
            "lpips": t_lpips.LPIPS.forward}
    lpips_ms = []

    def lpips_timed(self, *args):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = orig["lpips"](self, *args)
        torch.cuda.synchronize()
        lpips_ms.append((time.perf_counter() - ts) * 1e3)
        return out

    def make_counted_step(*args, **kwargs):
        check(kwargs.get("lpips_fn") is not None,
              f"{name}: training_loop built no lpips_fn with weights present")
        step = orig["make"](*args, **kwargs)

        def counted(*sargs):
            seen = dict(_cuda.LAUNCHES)
            torch.cuda.synchronize()
            rec_train.on = not step_ms
            ts = time.perf_counter()
            out = step(*sargs)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            rec_train.on = False
            step_launches.append({k: _cuda.LAUNCHES[k] - seen[k] for k in seen})
            step_metrics.append({k: float(v) for k, v in out.items()})
            return out
        return counted

    def few_steps(cfg, tcfg, *args, **kwargs):
        tcfg = dataclasses.replace(
            tcfg, total_kimg=LOADER_STEPS * tcfg.batch_size / 1000,
            snapshot_ticks=100)
        return orig["loop"](cfg, tcfg, *args, **kwargs)

    def run_eval_counted(render_fn, *args, **kwargs):
        def render(batch):
            before = dict(_cuda.LAUNCHES)
            rec_eval.on = not renders
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = render_fn(batch)
            torch.cuda.synchronize()
            rec_eval.on = False
            renders.append(({k: _cuda.LAUNCHES[k] - before[k] for k in before},
                            (time.perf_counter() - ts) * 1e3))
            return out
        return orig["run_eval"](render, *args, **kwargs)

    item_timers = Timed(torch, [
        (eval_cli.DATASETS[name], "__getitem__", "item"),
        (data_base, "decode_jpeg", "decode_jpeg"),
        (data_base, "decode_png", "decode_png"),
        (data_base, "resize_area", "resize"),
        (data_base, "resize_nearest", "resize"),
        (data_base, "get_bound_2d_mask", "mask"),
        (data_base, "get_rays_np", "rays"),
        (data_base, "near_far_aabb_np", "rays")], sync=False)
    data = (os.path.join(root, "subject_0"))
    common = ["--cfg", name, "--data", data, "--calibrate_budgets", "true",
              "--calibrate_margin", str(LIFE_MARGIN)]
    t_train = time.perf_counter()
    train_loop.make_train_step = make_counted_step
    train_loop.training_loop = few_steps
    t_lpips.LPIPS.forward = lpips_timed
    try:
        with rec_train, item_timers:
            _cuda.reset_launches()
            train_cli.main(["--outdir", run_dir, "--num_instance", "2"]
                           + common)
            torch.cuda.synchronize()
            train_launches = dict(_cuda.LAUNCHES)
    finally:
        train_loop.make_train_step = orig["make"]
        train_loop.training_loop = orig["loop"]
        t_lpips.LPIPS.forward = orig["lpips"]
    train_s = time.perf_counter() - t_train
    train_lpips_ms = list(lpips_ms)
    train_items = {k: list(v) for k, v in item_timers.ms.items()}
    snap = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    check(len(step_ms) == LOADER_STEPS and snap is not None,
          f"{name} training: {len(step_ms)} steps, snapshot {snap}")
    # the generator runs its kernels once for each item of a batch
    step_expect = {k: v * LOADER_BATCH for k, v in TRAIN_LAUNCHES.items()}
    check(all(n == step_expect for n in step_launches),
          f"{name} train step launches {step_launches}")
    check(all(m["overflow"] == 0 and np.isfinite(m["loss"]) and m["lpips"] > 0
              for m in step_metrics), f"{name} train metrics {step_metrics}")
    torch.cuda.empty_cache()

    # ---- eval: the CLI on the snapshot for held-out subject 2
    lpips_ms.clear()
    held = os.path.join(root, "subject_2")
    t_eval = time.perf_counter()
    test_loop.run_eval = run_eval_counted
    eval_cli.EVAL_DEFAULTS[name] = LOADER_PROTOCOLS[name]
    t_lpips.LPIPS.forward = lpips_timed
    eval_items = Timed(torch, item_timers.targets, sync=False)
    try:
        with rec_eval, eval_items:
            _cuda.reset_launches()
            results = eval_cli.main(common[:2] + ["--data", held, "--subjects",
                                                  held, "--resume", snap,
                                                  "--outdir", eval_dir]
                                    + common[4:])
            torch.cuda.synchronize()
    finally:
        test_loop.run_eval = orig["run_eval"]
        eval_cli.EVAL_DEFAULTS.update(orig["protocol"])
        t_lpips.LPIPS.forward = orig["lpips"]
    eval_s = time.perf_counter() - t_eval
    files = sorted(os.path.relpath(os.path.join(d, f), eval_dir)
                   for d, _, fs in os.walk(eval_dir) for f in fs)
    inputs = [f for f in files if f.endswith("_input.png")]
    check(renders and len(inputs) == len(renders),
          f"{name} eval: {len(renders)} renders, {len(inputs)} PNG triples")
    for protocol in ("novel_view", "novel_pose"):
        for key in ("psnr", "ssim", "lpips"):
            check(any(os.path.dirname(f) == protocol
                      and os.path.basename(f).startswith(key + "_")
                      for f in files), f"{name} eval: no {protocol}/{key}_*.npy")
            check(np.isfinite(results[protocol][key]),
                  f"{name} eval: {protocol} {results[protocol]}")
    check(all(r == FRAME_LAUNCHES for r, _ in renders),
          f"{name} eval: launches per render {[r for r, _ in renders]}")

    for rec, expect, what in ((rec_train, step_expect, "train step"),
                              (rec_eval, FRAME_LAUNCHES, "render")):
        kept = {k: len(v) for k, v in rec.calls.items()}
        check(kept == {k: expect[k] for k in kept},
              f"{name}: {kept} kernel calls kept from the first {what}")
    errs = dict.fromkeys(HELD, 0.0)
    cases = (held_calls(torch, rec_train.calls, f"loaders_{name}_train", errs)
             + held_calls(torch, rec_eval.calls, f"loaders_{name}_eval", errs))
    rec_train.calls.clear()
    rec_eval.calls.clear()
    med = lambda xs: statistics.median(xs) if xs else None
    split = lambda ms: {k: {"median_ms": med(v), "calls": len(v)}
                        for k, v in ms.items()}
    return {
        "train_steps": len(step_ms), "batch": LOADER_BATCH,
        "train_step_ms": step_ms,
        "train_seconds": round(train_s, 3), "train_launches": train_launches,
        "launches_per_step": step_launches[0],
        "overflow": [m["overflow"] for m in step_metrics],
        "lpips_loss": [m["lpips"] for m in step_metrics],
        "lpips_ms_in_step": med(train_lpips_ms),
        "train_item_build": split(train_items),
        "eval_seconds": round(eval_s, 3), "renders": len(renders),
        "launches_per_render": renders[0][0],
        "render_ms_median": med([ms for _, ms in renders]),
        "lpips_ms_in_render": med(lpips_ms),
        "eval_item_build": split(eval_items.ms),
        "results": results, "files": len(files),
    }, cases, errs


def loaders(torch, np, dev, out_dir, shims):
    """Phase ``loaders``: the JPEG fixtures, then a HuMMan and a
    RenderPeople tree each through the train and eval CLIs with a random
    LPIPS state dict (``SHERF_LPIPS_WEIGHTS``)."""
    from sherf_tpu_torch.cli.train import DATA_DEFAULTS
    from sherf_tpu_torch.eval import metrics as t_metrics
    from sherf_tpu_torch.smpl import synthetic_smpl
    from sherf_tpu_torch.train import lpips as t_lpips

    out = {"jpeg_fixtures": jpeg_fixtures(np)}
    g = torch.Generator().manual_seed(11)
    sd = {}
    for k, v in t_lpips.LPIPS().state_dict().items():
        if k.startswith("scaling_layer."):
            sd[k] = v.clone()
        elif k.startswith("lins."):
            sd[k] = torch.rand(v.shape, generator=g) * 0.1
        elif v.dim() == 4:
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.05
    weights = os.path.join(out_dir, "lpips_vgg.pt")
    torch.save(sd, weights)
    before = os.environ.get("SHERF_LPIPS_WEIGHTS")
    os.environ["SHERF_LPIPS_WEIGHTS"] = weights
    t_lpips._TRIED, t_lpips._LPIPS_PARAMS = False, None
    t_metrics._LPIPS.clear()
    smpl_cpu = synthetic_smpl(0, device="cpu")
    cases, errs = [], dict.fromkeys(HELD, 0.0)
    try:
        for name in ("humman", "renderpeople"):
            ts = time.perf_counter()
            root = os.path.join(out_dir, name)
            tree = write_tree(np, name, root, smpl_cpu, DATA_DEFAULTS[name])
            tree["write_seconds"] = round(time.perf_counter() - ts, 3)
            run, c, e = loader_run(torch, np, dev, name, root,
                                   os.path.join(out_dir, name + "_out"), shims)
            out[name] = {"tree": tree, **run}
            cases += c
            for k in errs:
                errs[k] = max(errs[k], e[k])
            torch.cuda.empty_cache()
    finally:
        if before is None:
            os.environ.pop("SHERF_LPIPS_WEIGHTS", None)
        else:
            os.environ["SHERF_LPIPS_WEIGHTS"] = before
        t_lpips._TRIED, t_lpips._LPIPS_PARAMS = False, None
        t_metrics._LPIPS.clear()
    return out, cases, errs


# ---- the render_clis phase: the render-side entry points at full width ----

RC_SIZE = 512
RC_DEPTH = 48
RC_FRAMES = 4
RC_SHAPE_RES = 128
RC_CHUNK = 65536
# launches per orbit frame at batch 1 with the CLIs' uncalibrated budget
# (point_capacity_frac 0.25, no ray budget: no ray prune): the point and
# canonical KNNs, the point compaction and the 3 sparse-conv downsamples;
# per query_canonical chunk: the canonical KNN and the 3 downsamples
ORBIT_LAUNCHES = {**NONE, "nn_1": 2, "compact_mask": 4}
CHUNK_LAUNCHES = {**NONE, "nn_1": 1, "compact_mask": 3}
# the visualizer's render types, each one frame through the HTTP app
VIZ_RENDERS = ("rgb", "depth", "crosssection")


def reference_state_dict(np, seed, backbone_resolution=256,
                         channel_base=32768, channel_max=512):
    """A reference (PyTorch SHERF) TriPlaneGenerator ``state_dict`` of random
    numpy weights at the given backbone widths (the key naming of
    ``compat/legacy_import``; ``tests/test_torch_render_clis.py`` builds the
    same); the decoder's density bias raised by DENSITY_BIAS, so that the
    frames are not empty."""
    r = np.random.RandomState(seed)
    sd = {}

    def add(k, *shape):
        sd[k] = np.asarray(r.standard_normal(shape) * 0.05, np.float32)

    def bn(k, c):
        add(k + ".weight", c)
        add(k + ".bias", c)
        add(k + ".running_mean", c)
        sd[k + ".running_var"] = np.ones(c, np.float32)

    for pre in ("encoder_2d.backbone.", "encoder_2d_feature.backbone."):
        add(pre + "conv1.weight", 64, 3, 7, 7)
        bn(pre + "bn1", 64)
        chans = [64, 128, 256, 512]
        for i in range(1, 5):
            for b in range(2):
                cout = chans[i - 1]
                c_in = chans[max(i - 2, 0)] if b == 0 else cout
                blk = f"{pre}layer{i}.{b}"
                add(blk + ".conv1.weight", cout, c_in, 3, 3)
                add(blk + ".conv2.weight", cout, cout, 3, 3)
                bn(blk + ".bn1", cout)
                bn(blk + ".bn2", cout)
                if b == 0 and i > 1:
                    add(blk + ".downsample.0.weight", cout, c_in, 1, 1)
                    bn(blk + ".downsample.1", cout)
    add("conv1d_projection.weight", 32, 96, 1)
    add("conv1d_projection.bias", 32)
    for i in range(2):
        add(f"backbone.mapping.fc{i}.weight", 512, 512)
        add(f"backbone.mapping.fc{i}.bias", 512)
    add("backbone.mapping.w_avg", 512)
    res_list = [2 ** i for i in range(2, int(math.log2(backbone_resolution)) + 1)]
    chans = {res: min(channel_base // res, channel_max) for res in res_list}

    def synth(k, cin, cout, kernel, res=None):
        add(k + ".weight", cout, cin, kernel, kernel)
        add(k + ".bias", cout)
        add(k + ".affine.weight", cin, 512)
        add(k + ".affine.bias", cin)
        if res:
            add(k + ".noise_strength")
            add(k + ".noise_const", res, res)

    for res in res_list:
        c, b = chans[res], f"backbone.synthesis.b{res}"
        if res == 4:
            add(b + ".const", c, 4, 4)
        else:
            synth(b + ".conv0", chans[res // 2], c, 3, res)
        synth(b + ".conv1", c, c, 3, res)
        synth(b + ".torgb", c, 96, 1)
    add("renderer.conv1d_projection.weight", 96, 192, 1)
    add("renderer.conv1d_projection.bias", 96)
    add("renderer.conv1d_reprojection.weight", 32, 96, 1)
    add("renderer.conv1d_reprojection.bias", 32)
    t = "renderer.transformer.layers.0"
    for k, shape in ((".0.fn.norm.weight", (32,)), (".0.fn.norm.bias", (32,)),
                     (".0.fn.fn.to_qkv.weight", (144, 32)),
                     (".0.fn.fn.to_out.0.weight", (32, 48)),
                     (".0.fn.fn.to_out.0.bias", (32,)),
                     (".1.fn.norm.weight", (32,)), (".1.fn.norm.bias", (32,)),
                     (".1.fn.fn.net.0.weight", (32, 32)),
                     (".1.fn.fn.net.0.bias", (32,)),
                     (".1.fn.fn.net.3.weight", (32, 32)),
                     (".1.fn.fn.net.3.bias", (32,))):
        add(t + k, *shape)
    for i, din in enumerate([71] + [128] * 4 + [199] + [128] * 2):
        add(f"decoder.pts_linears.{i}.weight", 128, din)
        add(f"decoder.pts_linears.{i}.bias", 128)
    for k, o, i in (("alpha", 1, 128), ("feature", 128, 128),
                    ("views", 64, 187), ("rgb", 3, 64)):
        add(f"decoder.{k}_linear.weight", o, i)
        add(f"decoder.{k}_linear.bias", o)
    sd["decoder.alpha_linear.bias"] += DENSITY_BIAS
    for name, cin, cout, n in (("conv0", 32, 32, 2), ("down0", 32, 32, 1),
                               ("conv1", 32, 32, 2), ("down1", 32, 64, 1),
                               ("conv2", 64, 64, 3), ("down2", 64, 96, 1),
                               ("conv3", 96, 96, 3)):
        for i in range(n):
            add(f"renderer.encoder_3d.{name}.{3 * i}.weight", cout, 3, 3, 3,
                cin if i == 0 else cout)
            bn(f"renderer.encoder_3d.{name}.{3 * i + 1}", cout)
    return sd


def write_reference_pickle(torch, np, path, sd):
    """``sd`` pickled as the reference's networks dict {'G_ema': module}."""
    import pickle
    root = torch.nn.Module()
    for key, arr in sd.items():
        *mods, leaf = key.split(".")
        node = root
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, torch.nn.Module())
            node = getattr(node, m)
        node.register_buffer(leaf, torch.from_numpy(arr))
    with open(path, "wb") as f:
        pickle.dump({"G_ema": root}, f)


def render_clis(torch, np, dev, out_dir, humman_root, shims):
    """Phase ``render_clis``: the render-side entry points on the card at the
    production model (``cli/common.render_cli_config``: default widths, f32,
    point budget 0.25 uncalibrated): ``gen_videos`` (RC_FRAMES orbit frames
    at RC_SIZE x RC_DEPTH), ``gen_samples --shapes`` (a frame and the
    canonical density on RC_SHAPE_RES^3 points in RC_CHUNK chunks, then the
    host's marching tetrahedra), ``render_demo``, ``debug_project`` on the
    loaders phase's HuMMan tree, and the visualizer served on an ephemeral
    localhost port with a reference pickle at the production widths.  One
    orbit frame's and one chunk's kernel calls are held against their
    plain versions; query_canonical on the card against the CPU at a small
    configuration."""
    import dataclasses
    import json as _json
    import urllib.request
    from sherf_tpu_torch.cli import (debug_project, gen_samples, gen_videos,
                                     render_demo)
    from sherf_tpu_torch.cli.common import build_model, render_cli_config
    from sherf_tpu_torch.data.png_read import decode_png
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch
    from sherf_tpu_torch.geometry.shape import (marching_tetrahedra, read_mrc,
                                                read_ply)
    from sherf_tpu_torch.kernels import _cuda, knn
    from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
    from sherf_tpu_torch.smpl import synthetic_smpl
    from sherf_tpu_torch.viz.server import VisualizerApp, serve

    out, cases, errs = {}, [], dict.fromkeys(HELD, 0.0)
    launches = {}

    def zero(overflows):
        return all(v == 0 for ov in overflows for v in ov.values())

    # ---- gen_videos: the orbit, one frame's kernel calls held ------------
    timers = [(SHERFGenerator, "forward", "frame"),
              (SHERFGenerator, "query_canonical", "chunk")]
    gif = os.path.join(out_dir, "orbit.gif")
    torch.cuda.reset_peak_memory_stats()
    with Recorder(shims) as rec, Timed(torch, timers) as tm:
        _cuda.reset_launches()
        res = gen_videos.main(["--out", gif, "--frames", str(RC_FRAMES),
                               "--size", str(RC_SIZE), "--depth",
                               str(RC_DEPTH), "--device", "cuda"])
        torch.cuda.synchronize()
        launches["orbit"] = dict(_cuda.LAUNCHES)
    check(zero(res["overflow"]), f"gen_videos overflow {res['overflow']}")
    check(all(launches["orbit"][k] == RC_FRAMES * v
              for k, v in ORBIT_LAUNCHES.items()),
          f"gen_videos launches {launches['orbit']}, expected "
          f"{RC_FRAMES} x {ORBIT_LAUNCHES}")
    frames = res["frames"]
    check(len(frames) == RC_FRAMES and all(
        f.shape == (RC_SIZE, RC_SIZE, 3) for f in frames), "gen_videos frames")
    check(all(f.std() > 0 for f in frames), "gen_videos: a flat frame")
    # the GIF: its header, a graphic control block a frame, its trailer
    data = open(gif, "rb").read()
    check(data[:6] == b"GIF89a" and data[-1:] == b"\x3b"
          and data.count(b"\x21\xf9\x04") == RC_FRAMES, "gen_videos: GIF")
    first = {k: rec.calls[k][:n] for k, n in ORBIT_LAUNCHES.items() if n}
    q0, v0 = first["nn_1"][0]
    survivors = int(first["compact_mask"][0][0].sum())
    nn1_orbit_ms = cuda_ms(lambda: knn.nn_1_cuda(q0, v0), 5, torch)
    cases += held_calls(torch, first, "orbit_frame", errs)
    out["gen_videos"] = {
        "frame_ms": [round(x, 3) for x in tm.ms["frame"]],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_frame": {k: v // RC_FRAMES for k, v in
                               launches["orbit"].items()},
        "overflow": res["overflow"], "gif_bytes": len(data),
        # the bound counts the queries the data needs (the compaction's
        # survivors; the rest of the budget is padding), as the kernel
        # table does for the importance frame's fine pass
        "nn_1_point_call": {"n": q0.shape[0], "v": v0.shape[0],
                            "needed": survivors, "ms": nn1_orbit_ms,
                            "bound_ms": survivors * v0.shape[0]
                            * NN1_OPS_PER_PAIR / PEAK_F32_FLOPS * 1e3,
                            "bound_all_queries_ms": q0.shape[0] * v0.shape[0]
                            * NN1_OPS_PER_PAIR / PEAK_F32_FLOPS * 1e3},
        "compact_mask_point_call": {
            "n": first["compact_mask"][0][0].shape[0],
            "cap": first["compact_mask"][0][1], "survivors": survivors}}
    del rec, first, q0, v0
    torch.cuda.empty_cache()

    # ---- gen_samples --shapes: one chunk's kernel calls held -------------
    sdir = os.path.join(out_dir, "samples")
    torch.cuda.reset_peak_memory_stats()
    with Recorder(shims) as rec, Timed(torch, timers) as tm:
        _cuda.reset_launches()
        res = gen_samples.main(["--outdir", sdir, "--seeds", "0", "--size",
                                str(RC_SIZE), "--depth", str(RC_DEPTH),
                                "--shapes", "--shape_res", str(RC_SHAPE_RES),
                                "--device", "cuda"])[0]
        torch.cuda.synchronize()
        launches["samples"] = dict(_cuda.LAUNCHES)
    n_chunks = -(-RC_SHAPE_RES ** 3 // RC_CHUNK)
    check(len(res["chunk_overflow"]) == n_chunks, "gen_samples chunks")
    check(zero([res["overflow"]] + res["chunk_overflow"]),
          f"gen_samples overflow {res['overflow']} {res['chunk_overflow']}")
    check(all(launches["samples"][k] == ORBIT_LAUNCHES[k]
              + n_chunks * CHUNK_LAUNCHES[k] for k in NONE),
          f"gen_samples launches {launches['samples']}")
    chunk = {k: rec.calls[k][ORBIT_LAUNCHES[k]:ORBIT_LAUNCHES[k] + n]
             for k, n in CHUNK_LAUNCHES.items() if n}
    qc, vc = chunk["nn_1"][0]
    check(qc.shape[0] == RC_CHUNK, f"chunk nn_1 queries {qc.shape}")
    nn1_chunk_ms = cuda_ms(lambda: knn.nn_1_cuda(qc, vc), 20, torch)
    cases += held_calls(torch, chunk, "query_chunk", errs)
    del rec, chunk
    png = decode_png(open(os.path.join(sdir, "seed0000.png"), "rb").read())
    check(png.shape == (RC_SIZE, RC_SIZE, 3), f"gen_samples png {png.shape}")
    sigma = read_mrc(os.path.join(sdir, "seed0000.mrc"))
    check(sigma.shape == (RC_SHAPE_RES,) * 3 and np.isfinite(sigma).all(),
          "gen_samples: density volume")
    verts, faces = read_ply(os.path.join(sdir, "seed0000.ply"))
    # the CLI meshes at its default level; the host's marching tetrahedra
    # timed again at a level the field crosses (its median)
    level = float(np.median(sigma))
    ts = time.perf_counter()
    mv, mf = marching_tetrahedra(sigma, level=level)
    mt_s = time.perf_counter() - ts
    check(len(mf) > 0 and np.isfinite(mv).all(), "marching tetrahedra")
    out["gen_samples"] = {
        "frame_ms": round(tm.ms["frame"][0], 3),
        "chunk_ms": [round(x, 3) for x in tm.ms["chunk"]],
        "chunk_ms_median": statistics.median(tm.ms["chunk"]),
        "chunks": n_chunks, "grid_s": round(res["grid_s"], 3),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches["samples"],
        "launches_per_chunk": {k: (launches["samples"][k] - ORBIT_LAUNCHES[k])
                               // n_chunks for k in NONE},
        "cli_mesh_s": round(res["mesh_s"], 3), "cli_mesh_faces": len(faces),
        "cli_mesh_level": 10.0, "sigma_range": [float(sigma.min()),
                                                float(sigma.max())],
        "marching_tetrahedra_s": round(mt_s, 3), "median_level": level,
        "median_level_faces": len(mf), "median_level_verts": len(mv),
        "nn_1_chunk_call": {"n": qc.shape[0], "v": vc.shape[0],
                            "ms": nn1_chunk_ms,
                            "bound_ms": qc.shape[0] * vc.shape[0]
                            * NN1_OPS_PER_PAIR / PEAK_F32_FLOPS * 1e3}}
    del qc, vc
    torch.cuda.empty_cache()

    # ---- render_demo and debug_project ------------------------------------
    # at the production depth, then at the CLI's default (24 samples:
    # recorded, not checked; the uncalibrated prune stride's step margin)
    demo = os.path.join(out_dir, "demo.png")
    with Timed(torch, timers) as tm:
        res = render_demo.main(["--out", demo, "--size", str(RC_SIZE),
                                "--depth", str(RC_DEPTH), "--device", "cuda"])
    check(zero([res["overflow"]]), f"render_demo overflow {res['overflow']}")
    panel = decode_png(open(demo, "rb").read())
    check(panel.shape == (RC_SIZE, 3 * RC_SIZE, 3)
          and np.array_equal(panel, res["panel"]), "render_demo png")
    default = render_demo.main(["--out", demo, "--size", str(RC_SIZE),
                                "--device", "cuda"])
    out["render_demo"] = {"frame_ms": round(tm.ms["frame"][0], 3),
                          "depth": RC_DEPTH, "overflow": res["overflow"],
                          "default_depth_overflow": default["overflow"]}
    subject = os.path.join(humman_root, "subject_2")
    proj = os.path.join(out_dir, "proj.png")
    ts = time.perf_counter()
    res = debug_project.main(["--cfg", "humman", "--data", subject,
                              "--out", proj, "--device", "cuda"])
    img = decode_png(open(proj, "rb").read())
    check(np.array_equal(img, res["image"]) and res["in_frame"] > 1000
          and (img == [255, 0, 0]).all(-1).sum() > 100,
          f"debug_project: {res['in_frame']} vertices in frame")
    out["debug_project"] = {"seconds": round(time.perf_counter() - ts, 3),
                            "image": list(img.shape),
                            "in_frame": res["in_frame"]}

    # ---- the visualizer over HTTP, a reference pickle at full width -------
    pkl = os.path.join(out_dir, "reference.pkl")
    write_reference_pickle(torch, np, pkl, reference_state_dict(np, 21))
    app = VisualizerApp(ckpt=pkl, resolution=RC_SIZE,
                        depth_resolution=RC_DEPTH, device=dev)
    app.capture.out_dir = os.path.join(out_dir, "captures")
    server = serve(app, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    viz = {}
    try:
        def get(path):
            return urllib.request.urlopen(base + path, timeout=300).read()

        def post(path, body):
            req = urllib.request.Request(base + path, method="POST",
                                         data=_json.dumps(body).encode())
            return urllib.request.urlopen(req, timeout=300).read()

        check(b"sherf_tpu_torch visualizer" in get("/"), "visualizer page")
        for rt in VIZ_RENDERS + ("layers",):
            post("/api/update", {"render_type": "rgb" if rt == "layers" else rt,
                                 "yaw": 2.5, "list_layers": rt == "layers"})
            frame = decode_png(get("/api/frame.png"))
            st = _json.loads(get("/api/state"))
            check(st["error"] is None, f"visualizer {rt}: {st['error']}")
            check(st["overflow"] and not any(st["overflow"].values()),
                  f"visualizer {rt}: overflow {st['overflow']}")
            check(frame.shape == (RC_SIZE, RC_SIZE, 3) and frame.std() > 0,
                  f"visualizer {rt}: frame {frame.shape}")
            viz[rt] = {"ms": st["perf"]["last_render_time"] * 1e3}
        names = [x["name"] for x in st["layers"]["layers"]]
        check(len(names) > 100, f"visualizer: {len(names)} layers")
        layer = "backbone.synthesis.b256.torgb"
        post("/api/update", {"list_layers": False, "layer_name": layer})
        heat = decode_png(get("/api/frame.png"))
        st = _json.loads(get("/api/state"))
        check(st["error"] is None and heat.shape == (256, 256, 3),
              f"visualizer layer {layer}: {st['error']} {heat.shape}")
        viz["layer"] = {"name": layer, "ms": st["perf"]["last_render_time"]
                        * 1e3, "layers_listed": len(names)}
        cap = _json.loads(post("/api/capture", {}))
        check(os.path.exists(cap["path"]), "visualizer capture")
    finally:
        server.shutdown()
        server.server_close()
    out["visualizer"] = viz
    del app
    torch.cuda.empty_cache()

    # ---- query_canonical, card against CPU, small configuration -----------
    smpl = synthetic_smpl(0, device="cpu")
    cfg = dataclasses.replace(render_cli_config(16), backbone_resolution=64,
                              channel_base=1024, channel_max=32,
                              voxel_size=0.02)
    small, _, cfg = build_model(cfg, smpl, device="cpu")
    random_init_(small, torch.Generator().manual_seed(5))
    with torch.no_grad():
        small.renderer.decoder.alpha.bias += DENSITY_BIAS
    b = make_synthetic_batch(smpl, batch_size=1, H=24, W=24, seed=1,
                             device="cpu")
    lo, hi = b.t_bounds[0, 0], b.t_bounds[0, 1]
    g = torch.linspace(0, 1, 16)
    grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = (lo + grid * (hi - lo))[None]
    with torch.inference_mode():
        ref, _ = small.eval().query_canonical(b, smpl, pts)
        got, d_gpu = small.to(dev).query_canonical(b.to(dev), smpl.to(dev),
                                                   pts.to(dev))
    rel = {k: max_abs(got[k].cpu(), ref[k]) / float(ref[k].abs().max())
           for k in ("rgb", "sigma")}
    check(all(v <= 1e-4 for v in rel.values()),
          f"query_canonical card vs CPU: {rel}")
    check(not any(int(v) for v in d_gpu.values()), "query_canonical overflow")
    out["query_canonical_vs_cpu"] = {"points": pts.shape[1], **{
        f"{k}_rel_err": v for k, v in rel.items()}}
    return out, cases, errs, launches


# ---- the branches phase: the off-default model branches at full width ----

# EG3D's importance setting: 48 stratified + 48 importance samples
IMP_DEPTH = 48
# per importance frame at batch 1: the point and canonical KNNs of each
# pass; the ray compaction, each pass's point compaction and the 3
# sparse-conv downsamples of each pass's decode
IMP_LAUNCHES = {**NONE, "nn_1": 4, "ray_body_mask": 1, "compact_mask": 9}
# ... with the shortlist on: both passes' KNNs take B6, each with its prep
IMP_SHORTLIST_LAUNCHES = {**NONE, "nn_1_shortlist": 4, "cluster_prep": 4,
                          "ray_body_mask": 1, "compact_mask": 9}
# ... in a train step: each pass's 3-scale readout adds its table gradients
IMP_TRAIN_LAUNCHES = {**IMP_LAUNCHES, "weighted_accumulate": 6}
IMP_TRAIN_STEPS = 3
# the small GPU-vs-CPU renders of the four configurations
SMALL_HW, SMALL_D, SMALL_DI = 24, 16, 8


def held_nn_1_shortlist(torch, what, query, ref, s_cap):
    """nn_1_shortlist (B6) on one recorded wrapper call against its plain
    version: the prep bit-equal to the plain prep, the tile lists equal to
    ``shortlist_tiles``, indices equal, d2 bit-equal."""
    from sherf_tpu_torch.kernels import knn_cluster as kc
    ck = kc.make_clusters_cuda(ref, kc.SL_CSIZE, False)
    cp = kc.make_clusters_plain(ref, kc.SL_CSIZE, False)
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    for f in ("order", "vs", "ctr0", "cent", "rad"):
        check(torch.equal(bits(getattr(ck, f)), bits(getattr(cp, f))),
              f"{what}: the prep's {f} differs from the plain prep")
    q_c = (query - ck.ctr0).contiguous()
    counts, ids, _, _ = kc.shortlist_tiles(q_c, ck)
    lists = (torch.empty_like(counts), torch.empty_like(ids))
    d2k, ik, over = kc.nn_1_shortlist_cuda(query, ck, lists=lists)
    d2p, ip, visits = kc.nn_1_shortlist_plain(q_c, ck, counts, ids)
    torch.cuda.synchronize()
    check(torch.equal(lists[0], counts) and torch.equal(lists[1], ids),
          f"{what}: the kernel's tile lists differ from shortlist_tiles")
    check(int(over) == 0, f"{what}: overflow {int(over)}")
    err = max_abs(d2k, d2p)
    check(torch.equal(ik, ip), f"{what}: indices differ")
    check(torch.equal(bits(d2k), bits(d2p)), f"{what}: d2 not bit-equal "
          f"(max abs err {err})")
    return ({"n": query.shape[0], "v": ref.shape[0], "equal": True,
             "prep_equal": True, "lists_equal": True,
             "pairs_admitted": int(visits.sum())}, err)


def psnr_db(np, a, b):
    """PSNR of two images in (-1, 1), as the tests compute it ("inf" when
    equal)."""
    a = (a.double().cpu().numpy() + 1) / 2
    b = (b.double().cpu().numpy() + 1) / 2
    mse = float(np.mean((a - b) ** 2))
    return "inf" if mse == 0 else float(10 * np.log10(1.0 / mse))


def branches(torch, np, dev, cfg, out_sh, model, batch, smpl, smpl_d, shims,
             launches, voxel_survivors):
    """The four off-default branches at the frame's configuration (512x512
    x 48, bf16, budgets calibrated at MARGIN, seed 0): the importance frame
    (48 + 48 samples) and 3 train steps with it, the importance frame with
    the cluster shortlist on (B6), the capsule-prune frame (point budget
    from its own survivors, reported beside the default frame's
    ``voxel_survivors``), the OSG-decoder frame and the SR frame (8XDC,
    512 -> 128 -> 512); then the same four at a small shape on the card
    and on the CPU.  Each path's launches are counted
    into ``launches`` and each of its kernel calls held against the
    kernel's plain version.  Returns (numbers, cases, errs)."""
    import dataclasses

    from sherf_tpu_torch.core.calibrate import calibrate_budgets
    from sherf_tpu_torch.core.config import RenderConfig, TrainConfig
    from sherf_tpu_torch.core.diag import overflow_report
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch
    from sherf_tpu_torch.kernels import _cuda, compaction, knn, knn_cluster
    from sherf_tpu_torch.kernels import capsules
    from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
    from sherf_tpu_torch.nerf import renderer as renderer_mod
    from sherf_tpu_torch.train import create_train_state, make_train_step

    out, cases = {}, []
    errs = dict.fromkeys(PORT_KERNELS, 0.0)
    all_shims = shims + [(knn_cluster, "nn_1_shortlist", "nn_1_shortlist")]
    held = dict(HELD, nn_1_shortlist=held_nn_1_shortlist)
    base = model.state_dict()

    def build(c, where=dev, strict=True):
        """The generator for config ``c`` with the frame model's weights (a
        branch's own modules drawn by random_init_)."""
        m = SHERFGenerator(c, out_sh=out_sh, device=where)
        random_init_(m, torch.Generator().manual_seed(0))
        m.load_state_dict(base, strict=strict)
        return m

    def hold(path, calls):
        for key, fn in held.items():
            for i, args in enumerate(calls.get(key, ())):
                case, err = fn(torch, f"{key} call {i} ({path})", *args)
                errs[key] = max(errs[key], err)
                cases.append({"kernel": key, "path": path, "call": i, **case})

    def frame(path, m, expect):
        """One counted, recorded frame of ``m``, checked; its median ms."""
        with Recorder(all_shims) as rec, torch.inference_mode():
            _cuda.reset_launches()
            o, diag = m(batch, smpl_d)
            torch.cuda.synchronize()
            launches[path] = dict(_cuda.LAUNCHES)
        ov = overflow_report(diag)
        check(all(bool(torch.isfinite(v).all()) for v in o.values()),
              f"{path}: non-finite output")
        check(tuple(o["image_raw"].shape) == (1, H, W, 3),
              f"{path}: image_raw {tuple(o['image_raw'].shape)}")
        check(all(v == 0 for v in ov.values()), f"{path}: overflow {ov}")
        check(launches[path] == expect,
              f"{path}: launches {launches[path]}, expected {expect}")
        ms = []
        with torch.inference_mode():
            for _ in range(FRAME_ITERS):
                ts = time.perf_counter()
                m(batch, smpl_d)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - ts) * 1e3)
        hold(path, rec.calls)
        res = {"launches": launches[path], "overflow": ov,
               "frame_ms_median": statistics.median(ms), "frame_ms": ms,
               "acc_max": float(o["weights_image"].max())}
        return o, res, rec.calls

    def capsule_budget(c, b, s_, where):
        """``c`` with the capsule prune and its point budget: the capsule
        test of a first frame (at c's budget) counts its survivors, and the
        budget is that count at MARGIN.  Returns (config, survivors, the
        prune_mask calls of that frame)."""
        c = dataclasses.replace(c, render=dataclasses.replace(
            c.render, prune_mode="capsule"))
        seen, orig = [], renderer_mod.prune_mask

        def keep(*args):
            seen.append(args)
            return orig(*args)
        renderer_mod.prune_mask = keep
        try:
            with torch.inference_mode():
                build(c, where)(b, s_)
        finally:
            renderer_mod.prune_mask = orig
        n = b.ray_o.shape[1] * c.render.depth_resolution
        surv = int(orig(*seen[0]).sum())
        cap = -(-int(surv * MARGIN) // 128) * 128
        check(cap < n, f"capsule budget {cap} covers the whole frame ({n})")
        return (dataclasses.replace(c, render=dataclasses.replace(
            c.render, point_capacity_frac=cap / n)), surv, seen)

    with torch.inference_mode():
        ref_img = model(batch, smpl_d)[0]["image_raw"]
    M = H * W * DEPTH

    # (a) the importance frame, budgets calibrated with the pass on
    imp_cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, depth_resolution_importance=IMP_DEPTH))
    fitted, _ = calibrate_budgets([batch], imp_cfg, margin=MARGIN)
    imp_cfg = dataclasses.replace(imp_cfg, render=fitted)
    m = build(imp_cfg).eval()
    o, res, calls = frame("imp_frame", m, IMP_LAUNCHES)
    check({"imp_coarse_overflow", "imp_fine_overflow"} <= set(res["overflow"]),
          f"imp_frame: overflow counters {sorted(res['overflow'])}")
    rcap = int(H * W * fitted.ray_capacity_frac)
    # the compactions in order: rays, the coarse pass's points, its three
    # sparse-conv downsamples, the fine pass's points, its downsamples
    (m_c, cap_c), (m_f, cap_f) = (calls["compact_mask"][i] for i in (1, 5))
    check(m_c.shape[0] == rcap * DEPTH and m_f.shape[0] == rcap * IMP_DEPTH,
          f"imp_frame: compactions 1 and 5 have {m_c.shape[0]} and "
          f"{m_f.shape[0]} samples, expected the {rcap}-ray grids")
    # the fine pass's point KNN: the nn_1 call whose queries are its budget
    fine_q = [(q, v) for q, v in calls["nn_1"] if q.shape[0] == cap_f][-1]
    n_f, nv_f = fine_q[0].shape[0], fine_q[1].shape[0]
    tile = _cuda.library().sherf_nn1_tile()
    coop = coop_queries(fine_q[0], tile, torch)
    # the work this call's data needs: a tile of identical queries (the
    # budget's padding) is one query's scan
    ops_nn1 = (n_f - coop + coop // tile) * nv_f * NN1_OPS_PER_PAIR
    res.update(
        ray_cap=rcap, coarse_cap=cap_c, fine_cap=cap_f,
        coarse_survivors=int(m_c.sum()), fine_survivors=int(m_f.sum()),
        importance_capacity_frac=fitted.importance_capacity_frac,
        psnr_vs_frame_db=psnr_db(np, o["image_raw"], ref_img),
        fine_nn_1={"n": n_f, "v": nv_f,
                   "ms": cuda_ms(lambda: knn.nn_1_cuda(*fine_q), 5, torch),
                   "plain_ms": cuda_ms(lambda: knn.nn_1_plain(*fine_q), 3,
                                       torch),
                   "bound_ms": ops_nn1 / PEAK_F32_FLOPS * 1e3,
                   "bound_by": "operations", "coop_queries": coop,
                   "all_pairs_bound_ms": n_f * nv_f * NN1_OPS_PER_PAIR
                   / PEAK_F32_FLOPS * 1e3},
        fine_compact_mask={
            "n": m_f.shape[0], "cap": cap_f,
            "ms": cuda_ms(lambda: compaction.compact_mask_cuda(m_f, cap_f), 5,
                          torch),
            "plain_ms": cuda_ms(lambda: compaction.compact_mask_plain(
                m_f, cap_f), 3, torch),
            "bound_ms": (m_f.shape[0] + 5 * cap_f) / PEAK_BYTES_S * 1e3,
            "bound_by": "bytes"})
    out["imp_frame"] = res
    imp_img = o["image_raw"]
    del o, calls, fine_q, m_c, m_f

    # ... and with the cluster shortlist on (B6 on both passes)
    sl = build(dataclasses.replace(imp_cfg, render=dataclasses.replace(
        fitted, knn_shortlist=KNN_SHORTLIST))).eval()
    o, res, _ = frame("imp_shortlist_frame", sl, IMP_SHORTLIST_LAUNCHES)
    res["psnr_vs_imp_frame_db"] = psnr = psnr_db(np, o["image_raw"], imp_img)
    check(psnr == "inf" or psnr >= 45.0,
          f"imp_shortlist_frame: {psnr} dB from the importance frame < 45")
    out["imp_shortlist_frame"] = res
    del sl, o, imp_img

    # ... one train step with it (random u and density noise from the
    # generator), IMP_TRAIN_STEPS steps timed
    tm = build(dataclasses.replace(imp_cfg, render=dataclasses.replace(
        fitted, density_noise=RenderConfig().density_noise)))
    del m
    torch.cuda.empty_cache()
    tcfg = TrainConfig(batch_size=1)
    state = create_train_state(tm, tcfg)
    step_fn = make_train_step(tm, smpl_d, tcfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    step_ms, per_step, metrics = [], [], []
    with Recorder(shims) as rec:
        _cuda.reset_launches()
        for i in range(IMP_TRAIN_STEPS):
            rec.on = i == 0
            seen = dict(_cuda.LAUNCHES)
            ts = time.perf_counter()
            mt = step_fn(state, batch, gen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            per_step.append({k: _cuda.LAUNCHES[k] - seen[k] for k in seen})
            metrics.append({k: float(v) for k, v in mt.items()})
        launches["imp_train"] = per_step[0]
    for i, (mt, n) in enumerate(zip(metrics, per_step)):
        check(np.isfinite(mt["loss"]) and np.isfinite(mt["grad_norm"]),
              f"imp_train step {i + 1}: {mt}")
        check(mt["overflow"] == 0, f"imp_train step {i + 1}: overflow "
              f"{mt['overflow']}")
        check(n == IMP_TRAIN_LAUNCHES, f"imp_train step {i + 1}: launches "
              f"{n}, expected {IMP_TRAIN_LAUNCHES}")
    hold("imp_train", rec.calls)
    out["imp_train"] = {
        "steps": IMP_TRAIN_STEPS, "step_ms": step_ms,
        "step_ms_median_2_3": statistics.median(step_ms[1:]),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
        "launches_per_step": per_step[0], "metrics": metrics}
    del tm, state, step_fn, rec
    torch.cuda.empty_cache()

    # (b) the capsule frame, its point budget from its own survivors; the
    # capsule test's own time on its inputs
    cap_cfg, surv, seen = capsule_budget(cfg, batch, smpl_d, dev)
    o, res, _ = frame("capsule_frame", build(cap_cfg).eval(), FRAME_LAUNCHES)
    pts, verts, joints, smpl_c, radius = seen[0]
    psnr = psnr_db(np, o["image_raw"], ref_img)
    check(psnr == "inf" or psnr >= 45.0,
          f"capsule_frame: {psnr} dB from the default frame < 45")
    res.update(capsule_survivors=surv, voxel_survivors=voxel_survivors,
               point_cap=int(M * cap_cfg.render.point_capacity_frac),
               capsule_points_tested=pts.shape[0], psnr_vs_frame_db=psnr,
               capsule_mask_ms=cuda_ms(lambda: capsules.prune_mask(
                   pts, verts, joints, smpl_c, radius), 5, torch))
    out["capsule_frame"] = res
    del o, seen, pts, verts

    # (c) the OSG-decoder frame and (d) the SR frame at the CLIs' default
    # img_resolution (512: 8XDC)
    osg_cfg = dataclasses.replace(cfg, use_nerf_decoder=False)
    m = build(osg_cfg, strict=False).eval()
    _, out["osg_frame"], _ = frame("osg_frame", m, FRAME_LAUNCHES)
    del m
    sr_cfg = dataclasses.replace(cfg, use_sr_module=True, img_resolution=512)
    m = build(sr_cfg, strict=False).eval()
    o, res, _ = frame("sr_frame", m, FRAME_LAUNCHES)
    check(tuple(o["image"].shape) == (1, 512, 512, 3),
          f"sr_frame: image {tuple(o['image'].shape)}")
    with torch.inference_mode():
        ws = m.mapping(batch.obs_img)
        raw = o["image_raw"]
        res["sr_ms"] = cuda_ms(lambda: m.superresolution(raw, raw, ws), 5,
                               torch)
    out["sr_frame"] = res
    del m, o, raw, ws
    torch.cuda.empty_cache()

    # the four configurations at a small shape, f32: the card against the
    # CPU (the decoder's density bias raised, as small_input_vs_cpu)
    small_batch = make_synthetic_batch(smpl, batch_size=1, H=SMALL_HW,
                                       W=SMALL_HW, seed=1, device="cpu")
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              render=RenderConfig(depth_resolution=SMALL_D,
                                                  density_noise=0.0))
    small_fit, _ = calibrate_budgets([small_batch], dataclasses.replace(
        f32, render=dataclasses.replace(
            f32.render, depth_resolution_importance=SMALL_DI)),
        margin=MARGIN, round_to=128)
    no_imp = dataclasses.replace(small_fit, depth_resolution_importance=0,
                                 importance_capacity_frac=None)
    small_cfgs = {
        "importance": dataclasses.replace(f32, render=small_fit),
        "capsule": capsule_budget(dataclasses.replace(f32, render=no_imp),
                                  small_batch, smpl, "cpu")[0],
        "osg": dataclasses.replace(f32, use_nerf_decoder=False, render=no_imp),
        "sr": dataclasses.replace(f32, use_sr_module=True, img_resolution=128,
                                  render=no_imp)}
    small = {}
    for name, c in small_cfgs.items():
        mc = build(c, where="cpu", strict=False).eval()
        with torch.no_grad():
            dec = mc.renderer.decoder
            if c.use_nerf_decoder:
                dec.alpha.bias += DENSITY_BIAS
            else:
                dec.fc1.bias[0] += DENSITY_BIAS
            ref, diag_c = mc(small_batch, smpl)
            got, diag_g = mc.to(dev)(small_batch.to(dev), smpl_d)
        for where, dg in (("cpu", diag_c), ("cuda", diag_g)):
            check(all(int(v) == 0 for v in dg.values()),
                  f"small {name} ({where}): overflow {overflow_report(dg)}")
        acc_max = float(ref["weights_image"].max())
        check(acc_max > 0.5, f"small {name}: nearly empty (acc max {acc_max})")
        keys = ("image_raw", "image") if c.use_sr_module else ("image_raw",)
        small[name] = {"acc_max": acc_max}
        for k in keys:
            p = psnr_db(np, got[k], ref[k])
            check(p == "inf" or p >= 45.0,
                  f"small {name} GPU vs CPU {k}: {p} dB < 45")
            small[name][f"{k}_psnr_db"] = p
        del mc, ref, got
    out["small_vs_cpu"] = small
    torch.cuda.empty_cache()
    return out, cases, errs


# ---- the gan and gan_metrics phases: the adversarial path and its metrics -

GAN_ROUNDS = 3
GAN_ADV_WEIGHT = 0.1
GAN_REG_INTERVAL = 2
# per adversarial round: the G phase is a train step; Dmain re-renders G in
# train mode without a graph (the frame's kernels, no table gradient); Dreg
# runs the discriminator alone
GAN_LAUNCHES = {"gan_g": TRAIN_LAUNCHES, "gan_d": FRAME_LAUNCHES,
                "gan_dreg": NONE}
GAN_CLI_STEPS = 2
GAN_METRICS = ("fid", "kid", "pr", "is", "ppl", "eqt", "eqr")
GAN_METRIC_ITEMS, GAN_METRIC_SIZE = 8, 128


def _phase_grads(cpu, gpu):
    """Worst relative L2 of ``gpu``'s parameter gradients against
    ``cpu``'s, and its parameter; fails above 1e-3."""
    rel = grad_rel_errors(cpu, gpu)
    worst = max(rel, key=rel.get)
    check(rel[worst] <= 1e-3, f"small GAN round GPU vs CPU: {worst} "
          f"relative L2 {rel[worst]} > 1e-3")
    return {"params_compared": len(rel), "worst_param": worst,
            "worst_rel_l2": rel[worst]}


def gan(torch, np, dev, cfg, out_sh, model, batch, smpl, smpl_d, shims,
        out_dir):
    """Phase ``gan``: GAN_ROUNDS adversarial rounds (G phase, Dmain, Dreg on
    rounds 0 and 2) at the train phase's configuration (512x512x48, bf16,
    budgets calibrated at MARGIN, batch 1) with a DualDiscriminator at 512
    (channel_base 32768, channel_max 512): each phase timed and counted,
    every kernel call of the first round held against its plain version;
    then one round at 24x24 in f32 on the card against the CPU (gradients
    of each phase from the same weights, relative L2 <= 1e-3); then the
    train CLI with ``--adv_weight 0.1`` for GAN_CLI_STEPS steps on the
    synthetic_grid rig.  Returns (numbers, cases, errs, launches by path,
    the CLI's snapshot)."""
    import dataclasses

    from sherf_tpu_torch.cli import train as train_cli
    from sherf_tpu_torch.core.calibrate import calibrate_budgets
    from sherf_tpu_torch.core.config import RenderConfig, TrainConfig
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch
    from sherf_tpu_torch.features.discriminator import DualDiscriminator
    from sherf_tpu_torch.kernels import _cuda
    from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
    from sherf_tpu_torch.train import create_train_state
    from sherf_tpu_torch.train import loop as train_loop
    from sherf_tpu_torch.train.checkpoint import latest_checkpoint
    from sherf_tpu_torch.train.gan import (create_d_train_state,
                                           make_gan_losses,
                                           make_gan_train_step)

    out = {}
    tcfg = TrainConfig(batch_size=1, adv_weight=GAN_ADV_WEIGHT,
                       d_reg_interval=GAN_REG_INTERVAL)
    train_cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, density_noise=RenderConfig().density_noise))

    # (a) GAN_ROUNDS rounds at full width
    g = SHERFGenerator(train_cfg, out_sh=out_sh, device=dev)
    random_init_(g, torch.Generator().manual_seed(0))
    d = DualDiscriminator(img_resolution=H).to(dev)
    d_state = create_d_train_state(d, tcfg,
                                   generator=torch.Generator().manual_seed(1))
    g_state = create_train_state(g, tcfg)
    g_step, d_main, d_reg = make_gan_train_step(g, smpl_d, tcfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    d_gen = torch.Generator(device=dev).manual_seed(2)
    d_in = []
    hook = d.register_forward_pre_hook(
        lambda m, a: d_in.append(tuple(str(t.dtype) for t in a)))
    g0 = {n: p.detach().clone() for n, p in g.named_parameters()}
    d0 = {n: p.detach().clone() for n, p in d.named_parameters()}
    ms = {path: [] for path in GAN_LAUNCHES}
    counts = {path: [] for path in GAN_LAUNCHES}
    metrics, first = [], {}
    torch.cuda.reset_peak_memory_stats()

    def timed_phase(path, rec, fn, *args):
        rec.on = not ms[path]            # keep the first round's calls
        seen = dict(_cuda.LAUNCHES)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        m = fn(*args)
        torch.cuda.synchronize()
        ms[path].append((time.perf_counter() - ts) * 1e3)
        rec.on = False
        counts[path].append({k: _cuda.LAUNCHES[k] - seen[k] for k in seen})
        if rec.calls and len(ms[path]) == 1:
            first[path] = {k: list(v) for k, v in rec.calls.items()}
            for v in rec.calls.values():
                v.clear()
        return m

    with Recorder(shims) as rec:
        for r in range(GAN_ROUNDS):
            m = timed_phase("gan_g", rec, g_step, g_state, d_state, batch,
                            gen)
            m.update(timed_phase("gan_d", rec, d_main, d_state, g_state,
                                 batch, d_gen))
            if r % GAN_REG_INTERVAL == 0:
                m.update(timed_phase("gan_dreg", rec, d_reg, d_state,
                                     batch))
            metrics.append({k: float(v) for k, v in m.items()})
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        # where each phase's device time goes: one more round, profiled
        profiles = {}
        for path, fn, expect in (
                ("gan_g", lambda: g_step(g_state, d_state, batch, gen),
                 TRAIN_LAUNCHES),
                ("gan_d", lambda: d_main(d_state, g_state, batch, d_gen),
                 FRAME_LAUNCHES),
                ("gan_dreg", lambda: d_reg(d_state, batch), NONE)):
            prof = profiled(fn, torch, expect)
            profiles[path] = {k: prof[k] for k in (
                "wall_ms_profiled", "device_busy_ms", "device_idle_share",
                "kernel_launches", "port_kernels_ms", "top_ops")}
            profiles[path]["top_ops"] = prof["top_ops"][:8]
    hook.remove()
    for path, expect in GAN_LAUNCHES.items():
        check(all(c == expect for c in counts[path]),
              f"{path} launches {counts[path]}, expected {expect}")
    for i, m in enumerate(metrics):
        check(all(np.isfinite(v) for v in m.values()),
              f"gan round {i + 1}: {m}")
        check(m["overflow"] == 0, f"gan round {i + 1}: overflow "
              f"{m['overflow']}")
    check(len(ms["gan_dreg"]) == len(range(0, GAN_ROUNDS, GAN_REG_INTERVAL))
          and "r1_penalty" in metrics[0], "gan: Dreg cadence")
    # D sees f32 for the fake and the real images, as the JAX D (whose
    # weights follow its input's dtype) does in a bf16 run
    check(set(d_in) == {("torch.float32", "torch.float32")},
          f"gan: D input dtypes {sorted(set(d_in))}")
    check(d_state.step == GAN_ROUNDS + len(ms["gan_dreg"]) + 2,
          f"gan: D state at step {d_state.step}")
    params = dict(g.named_parameters())
    check(all(not torch.equal(d0[n], p) for n, p in d.named_parameters()),
          "gan: a D parameter did not move")
    moved = sum(not torch.equal(g0[n], params[n]) for n in g0)
    check(moved > len(g0) // 2, f"gan: {moved} of {len(g0)} G parameters "
          f"moved")
    errs = dict.fromkeys(HELD, 0.0)
    cases = (held_calls(torch, first.get("gan_g", {}), "gan_g", errs)
             + held_calls(torch, first.get("gan_d", {}), "gan_d", errs))
    check(sum(c["path"] == "gan_g" for c in cases)
          == sum(TRAIN_LAUNCHES.values())
          and sum(c["path"] == "gan_d" for c in cases)
          == sum(FRAME_LAUNCHES.values()), "gan: calls held")
    med = lambda xs: statistics.median(xs[1:]) if len(xs) > 1 else None
    out["rounds"] = {
        "rounds": GAN_ROUNDS, "g_ms": ms["gan_g"], "d_main_ms": ms["gan_d"],
        "d_reg_ms": ms["gan_dreg"], "g_ms_median_after_1": med(ms["gan_g"]),
        "d_main_ms_median_after_1": med(ms["gan_d"]),
        "d_reg_ms_after_1": med(ms["gan_dreg"]),
        "peak_mem_gb": round(peak_gb, 3),
        "launches_per_phase": {p: c[0] for p, c in counts.items()},
        "d_params": sum(p.numel() for p in d.parameters()),
        "d_input_dtypes": sorted(set(d_in)), "metrics": metrics,
        "profiles": profiles}
    launches = {p: c[0] for p, c in counts.items()}
    del g, d, g_state, d_state, g_step, d_main, d_reg, first, rec, g0, d0
    torch.cuda.empty_cache()

    # (b) one round at 24x24, card against CPU, each phase from the same
    # weights.  The G phase runs in f32 through g_step.  The D phases run D
    # in f64 on the same inputs (the CPU's re-render): the two devices'
    # f32 renders differ by ~1e-8, and a leaky ReLU whose input lies that
    # close to zero takes the other slope on the other device, which moves
    # that layer's gradient by ~5e-3: a property of the comparison, not of
    # either device.
    t0 = time.perf_counter()
    small_batch = make_synthetic_batch(smpl, batch_size=1, H=SMALL_HW,
                                       W=SMALL_HW, seed=1, device="cpu")
    small_cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                    render=RenderConfig(depth_resolution=16,
                                                        density_noise=0.0))
    fit, _ = calibrate_budgets([small_batch], small_cfg, margin=MARGIN,
                               round_to=128)
    small_cfg = dataclasses.replace(small_cfg, render=fit)
    sd = model.state_dict()
    sd["renderer.decoder.alpha.bias"] = (sd["renderer.decoder.alpha.bias"]
                                         + DENSITY_BIAS)
    d_sd = create_d_train_state(DualDiscriminator(img_resolution=SMALL_HW),
                                tcfg, generator=torch.Generator().manual_seed(1)
                                ).model.state_dict()

    class D64(torch.nn.Module):
        """The discriminator in f64, on f64 copies of its inputs."""

        def __init__(self):
            super().__init__()
            self.d = DualDiscriminator(img_resolution=SMALL_HW).double()
            self.d.load_state_dict(d_sd)

        def forward(self, image, image_raw):
            return self.d(image.double(), image_raw.double())

    small, sides, metrics_g = {}, {}, {}
    for where, d_, b_, s_ in (("cpu", "cpu", small_batch, smpl),
                              ("cuda", dev, small_batch.to(dev), smpl_d)):
        gm = SHERFGenerator(small_cfg, out_sh=out_sh, device=d_)
        gm.load_state_dict(sd)
        dm = DualDiscriminator(img_resolution=SMALL_HW).to(d_)
        dm.load_state_dict(d_sd)
        g_step, _, d_reg_step = make_gan_train_step(gm, s_, tcfg)
        m = g_step(create_train_state(gm, tcfg), create_d_train_state(dm, tcfg),
                   b_, torch.Generator(device=d_).manual_seed(0))
        metrics_g[where] = {k: float(v) for k, v in m.items()}
        sides[where] = (gm, D64().to(d_), b_, d_reg_step)
    check(all(m["overflow"] == 0 for m in metrics_g.values()),
          f"small GAN round overflow {metrics_g}")
    small["g"] = _phase_grads(sides["cpu"][0], sides["cuda"][0])
    with torch.no_grad():            # Dmain's re-render: the CPU's G
        fake, _ = sides["cpu"][0](small_batch, smpl, noise_mode="none",
                                  train=True)
    d_states, metrics_d = {}, {}
    for where, (gm, d64, b_, d_reg_step) in sides.items():
        ds = d_states[where] = create_d_train_state(d64, tcfg)
        real = b_.img * 2.0 - 1.0
        loss, m = make_gan_losses(d64)[1](
            {k: v.to(real.device) for k, v in fake.items()}, real, real)
        loss.backward()
        metrics_d[where] = {k: float(v) for k, v in m.items()}
    small["d_main"] = _phase_grads(sides["cpu"][1], sides["cuda"][1])
    for where, (gm, d64, b_, d_reg_step) in sides.items():
        d_states[where].apply_gradients()
        metrics_d[where].update({k: float(v) for k, v in
                                 d_reg_step(d_states[where], b_).items()})
    small["d_reg"] = _phase_grads(sides["cpu"][1], sides["cuda"][1])
    out["small_round_vs_cpu"] = {
        "seconds": round(time.perf_counter() - t0, 3), "phases": small,
        "metrics": {w: {**metrics_g[w], **metrics_d[w]} for w in metrics_g}}
    del sides, d_states
    torch.cuda.empty_cache()

    # (c) the train CLI with the adversarial phases, GAN_CLI_STEPS steps
    t0 = time.perf_counter()
    run_dir = os.path.join(out_dir, "gan_run")
    orig_loop = train_loop.training_loop

    def few_steps(c, t, *args, **kwargs):
        t = dataclasses.replace(t, total_kimg=GAN_CLI_STEPS * t.batch_size
                                / 1000, snapshot_ticks=100)
        return orig_loop(c, t, *args, **kwargs)
    train_loop.training_loop = few_steps
    try:
        _cuda.reset_launches()
        train_cli.main(["--outdir", run_dir, "--cfg", "synthetic_grid",
                        "--batch", "1", "--num_instance", "2",
                        "--adv_weight", str(GAN_ADV_WEIGHT),
                        "--d_reg_interval", str(GAN_REG_INTERVAL),
                        "--calibrate_budgets", "true",
                        "--calibrate_margin", str(LIFE_MARGIN)])
        torch.cuda.synchronize()
        cli_launches = dict(_cuda.LAUNCHES)
    finally:
        train_loop.training_loop = orig_loop
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    loss = [x for x in lines if "Loss/loss" in x]
    keys = ("g_adv", "d_loss", "scores_fake", "scores_real", "r1_penalty",
            "loss")
    check(len(loss) == 1 and all(np.isfinite(loss[0].get(f"Loss/{k}", np.nan))
                                 for k in keys)
          and loss[0]["Loss/overflow"] == 0, f"gan CLI stats {loss}")
    snap = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    check(snap is not None and snap.endswith(f"snapshot-{GAN_CLI_STEPS:06d}.pt"),
          f"gan CLI snapshot {snap}")
    out["train_cli"] = {"seconds": round(time.perf_counter() - t0, 3),
                        "steps": GAN_CLI_STEPS, "launches": cli_launches,
                        "stats": {k: loss[0][f"Loss/{k}"] for k in keys}}
    torch.cuda.empty_cache()
    return out, cases, errs, launches, snap


def random_state_dict(torch, template, seed):
    """A seeded random state dict with ``template``'s keys and shapes:
    He-scaled convolutions, BN variances in [0.5, 1.5), scales near 1,
    small biases and linear weights."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in template.items():
        if k.startswith("scaling_layer.") or k.endswith("num_batches_tracked"):
            sd[k] = v.clone()
        elif v.dim() == 4:
            sd[k] = torch.randn(v.shape, generator=g) * (
                2.0 / v[0].numel()) ** 0.5
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("bn.weight"):
            sd[k] = 1.0 + 0.1 * torch.randn(v.shape, generator=g)
        elif k.startswith("lins."):
            sd[k] = torch.rand(v.shape, generator=g) * 0.1
        else:
            sd[k] = 0.02 * torch.randn(v.shape, generator=g)
    return sd


def gan_metrics(torch, np, dev, out_dir, snap):
    """Phase ``gan_metrics``: ``cli.calc_metrics.main`` on the card with
    ``--resume`` on the GAN CLI run's snapshot, every metric, GAN_METRIC_ITEMS
    items at GAN_METRIC_SIZE, with seeded random Inception and LPIPS state
    dicts written here (``SHERF_INCEPTION_WEIGHTS``, ``SHERF_LPIPS_WEIGHTS``);
    then InceptionV3 timed on a batch at 299 and held, card against CPU, on
    2 images of 320x320."""
    from sherf_tpu_torch.cli import calc_metrics
    from sherf_tpu_torch.eval import metrics as t_metrics
    from sherf_tpu_torch.features import inception as t_inc
    from sherf_tpu_torch.kernels import _cuda
    from sherf_tpu_torch.train import lpips as t_lpips

    inc_sd = random_state_dict(torch, t_inc.InceptionV3().state_dict(), 12)
    paths = {"SHERF_INCEPTION_WEIGHTS": os.path.join(out_dir, "inception.pt"),
             "SHERF_LPIPS_WEIGHTS": os.path.join(out_dir, "lpips_vgg.pt")}
    torch.save(inc_sd, paths["SHERF_INCEPTION_WEIGHTS"])
    torch.save(random_state_dict(torch, t_lpips.LPIPS().state_dict(), 11),
               paths["SHERF_LPIPS_WEIGHTS"])
    before = {k: os.environ.get(k) for k in paths}
    os.environ.update(paths)
    t_lpips._TRIED, t_lpips._LPIPS_PARAMS = False, None
    t0 = time.perf_counter()
    try:
        _cuda.reset_launches()
        res = calc_metrics.main([
            "--cfg", "synthetic", "--resume", snap, "--metrics", *GAN_METRICS,
            "--num_items", str(GAN_METRIC_ITEMS), "--size",
            str(GAN_METRIC_SIZE), "--out", os.path.join(out_dir,
                                                        "metrics.json")])
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        t_lpips._TRIED, t_lpips._LPIPS_PARAMS = False, None
        t_metrics._LPIPS.clear()
    seconds = time.perf_counter() - t0
    names = ("fid", "kid", "precision", "recall", "is_mean", "is_std", "ppl",
             "eqt_int_psnr", "eqr90_psnr")
    check(all(np.isfinite(res[k]) for k in names), f"gan_metrics: {res}")
    check(res["overflow"] == 0, f"gan_metrics: overflow {res['overflow']}")
    check(launches["nn_1"] > 0, f"gan_metrics: launches {launches}")

    net = t_inc.make_inception(inc_sd, dev)
    x = torch.rand(GAN_METRIC_ITEMS, t_inc.INPUT_SIZE, t_inc.INPUT_SIZE, 3,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        batch_ms = cuda_ms(lambda: net(x), 5, torch)
    x2 = torch.rand(2, 320, 320, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        fg, lg = net(x2.to(dev))
        fc, lc = t_inc.make_inception(inc_sd, "cpu")(x2)
    err = {"pool3_max_abs": max_abs(fg.cpu(), fc),
           "logits_max_abs": max_abs(lg.cpu(), lc),
           "pool3_max_abs_ref": float(fc.abs().max())}
    check(torch.allclose(fg.cpu(), fc, rtol=1e-3, atol=1e-3)
          and torch.allclose(lg.cpu(), lc, rtol=1e-3, atol=1e-3),
          f"gan_metrics: Inception card vs CPU {err}")
    return {"seconds_calc_metrics": round(seconds, 3), "results": res,
            "launches": launches, "inception_ms_per_batch": batch_ms,
            "inception_batch": GAN_METRIC_ITEMS,
            "inception_card_vs_cpu": err}


# ---------------------------------------------------------------------------
# TF32: what PyTorch's default costs the f32 CLIs, and the repair


def tf32(torch, np, dev, cfg, out_sh, batch, smpl_d):
    """Phase ``tf32``: the CLIs' f32 model (default widths, 48 samples,
    budgets calibrated at MARGIN on the frame's scene, seed-0 weights with
    the decoder's density bias raised) run with both TF32 switches on
    (PyTorch's cuDNN default) and off: one render (PSNR between the two),
    one train step's loss and per-parameter gradients (worst relative L2),
    InceptionV3 features on 8 images at 299 (max abs).  Then every CLI's
    ``resolve_device`` must leave both switches off."""
    import dataclasses
    import importlib

    from sherf_tpu_torch.core.config import RenderConfig, TrainConfig
    from sherf_tpu_torch.features import inception as t_inc
    from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
    from sherf_tpu_torch.train import reconstruction_loss

    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              render=dataclasses.replace(
                                  cfg.render, density_noise=0.0))
    models = {}
    for on in (False, True):
        m = SHERFGenerator(f32, out_sh=out_sh, device=dev)
        random_init_(m, torch.Generator().manual_seed(0))
        with torch.no_grad():
            m.renderer.decoder.alpha.bias += DENSITY_BIAS
        models[on] = m
    inc = t_inc.make_inception(random_state_dict(
        torch, t_inc.InceptionV3().state_dict(), 12), dev)
    x = torch.rand(8, t_inc.INPUT_SIZE, t_inc.INPUT_SIZE, 3,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    out = {}
    try:
        for on, m in models.items():
            torch.backends.cudnn.allow_tf32 = on
            torch.backends.cuda.matmul.allow_tf32 = on
            with torch.no_grad():
                img, diag = m.eval()(batch, smpl_d)
                feats, _ = inc(x)
            check(all(int(v) == 0 for v in diag.values()),
                  f"tf32: render overflow {diag}")
            o, diag = m.train()(batch, smpl_d, train=True)
            loss, _ = reconstruction_loss(o, batch, TrainConfig(batch_size=1))
            loss.backward()
            out[on] = (img["image_raw"], float(loss.detach()), feats)
            del o, loss
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rel = grad_rel_errors(models[False], models[True])
    worst = max(rel, key=rel.get)
    res = {"render_psnr_db": psnr_db(np, out[False][0], out[True][0]),
           "render_max_abs": max_abs(out[False][0], out[True][0]),
           "loss_tf32_off": out[False][1], "loss_tf32_on": out[True][1],
           "loss_rel_diff": abs(out[True][1] - out[False][1])
           / abs(out[False][1]),
           "grad_worst_rel_l2": rel[worst], "grad_worst_param": worst,
           "grad_median_rel_l2": float(np.median(list(rel.values()))),
           "params_compared": len(rel),
           "inception_pool3_max_abs": max_abs(out[False][2], out[True][2]),
           "inception_pool3_max_abs_ref": float(out[False][2].abs().max())}
    del models, inc
    torch.cuda.empty_cache()
    for name in ("train", "eval", "calc_metrics", "gen_videos", "gen_samples",
                 "render_demo", "debug_project", "visualizer"):
        mod = importlib.import_module(f"sherf_tpu_torch.cli.{name}")
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        mod.resolve_device("cuda")
        check(not torch.backends.cudnn.allow_tf32
              and not torch.backends.cuda.matmul.allow_tf32,
              f"tf32: cli.{name}'s resolve_device left TF32 on")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res["clis_checked"] = 8
    return res


# ---------------------------------------------------------------------------
# the native host-ops library


def native_phase(np):
    """Phase ``native``: the host-ops library builds (with this machine's
    g++); its rays against numpy's at the tests' bounds (rays 1e-4, box
    masks agreeing on > 0.999 of the rays, near / far 1e-3 where both hit)
    on a 512x512 and a 640x360 view, each timed; and a loader item's rays
    (``sample_rays_for_image``) built through the library and through
    numpy, timed."""
    from sherf_tpu_torch import native
    from sherf_tpu_torch.data import base
    from sherf_tpu_torch.data.synthetic import synthetic_camera
    from sherf_tpu_torch.geometry.rays import get_rays_np, near_far_aabb_np

    t0 = time.perf_counter()
    lib = native.lib()
    build_s = time.perf_counter() - t0
    check(lib is not None, "native: the host-ops library did not build")
    bounds = np.array([[-0.45, -1.2, -0.25], [0.45, 0.75, 0.25]], np.float32)
    out = {"library": os.path.relpath(str(native.library_path())),
           "build_or_load_s": build_s}
    rng = np.random.RandomState(0)

    def best_ms(fn, n=5):
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    for H_, W_ in ((512, 512), (360, 640)):
        K, R, T = synthetic_camera(H_, W_, rng)
        K, R, T = (np.asarray(a, np.float32) for a in (K, R, T))
        ro, rd, near, far, mask = native.prepare_rays_native(H_, W_, K, R, T,
                                                             bounds)
        ro_n, rd_n = get_rays_np(H_, W_, K, R, T)
        ro_n = ro_n.reshape(-1, 3).astype(np.float32)
        rd_n = rd_n.reshape(-1, 3).astype(np.float32)
        n_n, f_n, m_n = near_far_aabb_np(bounds, ro_n, rd_n)
        both = mask & m_n
        err = {"ray_o": float(np.abs(ro - ro_n).max()),
               "ray_d": float(np.abs(rd - rd_n).max()),
               "mask_agree": float((mask == m_n).mean()),
               "near": float(np.abs(near - n_n)[both].max(initial=0)),
               "far": float(np.abs(far - f_n)[both].max(initial=0))}
        check(err["ray_o"] <= 1e-4 and err["ray_d"] <= 1e-4
              and err["mask_agree"] > 0.999 and err["near"] <= 1e-3
              and err["far"] <= 1e-3 and mask.any(),
              f"native: rays at {H_}x{W_} against numpy {err}")

        def numpy_rays():
            o, d = get_rays_np(H_, W_, K, R, T)
            near_far_aabb_np(bounds, o.reshape(-1, 3).astype(np.float32),
                             d.reshape(-1, 3).astype(np.float32))
        img = rng.rand(H_, W_, 3).astype(np.float32)
        msk = (rng.rand(H_, W_) > 0.5).astype(np.float32)
        item = lambda: base.sample_rays_for_image(img, msk, K, R, T, bounds)
        native_item_ms = best_ms(item)
        real = native.prepare_rays_native
        native.prepare_rays_native = lambda *a, **k: None
        try:
            numpy_item_ms = best_ms(item)
        finally:
            native.prepare_rays_native = real
        out[f"{H_}x{W_}"] = {
            "vs_numpy": err, "mask_share": float(mask.mean()),
            "rays_native_ms": best_ms(lambda: native.prepare_rays_native(
                H_, W_, K, R, T, bounds)),
            "rays_numpy_ms": best_ms(numpy_rays),
            "item_rays_native_ms": native_item_ms,
            "item_rays_numpy_ms": numpy_item_ms}
    return out


# ---------------------------------------------------------------------------
# the image-folder dataset tool


def _bmp24(np, img):
    """An (H, W, 3) uint8 image as an uncompressed bottom-up 24-bit BMP."""
    import struct
    H_, W_ = img.shape[:2]
    stride = (W_ * 3 + 3) // 4 * 4
    rows = np.zeros((H_, stride), np.uint8)
    rows[:, :W_ * 3] = img[::-1, :, ::-1].reshape(H_, W_ * 3)
    px = rows.tobytes()
    header = struct.pack("<IiiHHIIiiII", 40, W_, H_, 1, 24, 0, len(px), 2835,
                         2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 54 + len(px), 0, 0, 54) + header + px


def dataset_tool_phase(np, out_dir):
    """Phase ``dataset_tool``: a tree written here (two PNGs, the 512x512
    JPEG fixture, a 24-bit BMP, in sub-folders, with ``dataset.json``
    labels) packed by ``cli.dataset_tool.main`` at 256x256 center-crop,
    then read back through ``ImageFolderDataset``: names, labels, and each
    image equal to ``transform_image`` of its source item."""
    import json as json_
    import zipfile

    from sherf_tpu_torch.cli import dataset_tool
    from sherf_tpu_torch.data.image_folder import ImageFolderDataset
    from sherf_tpu_torch.eval.png import png_bytes

    rng = np.random.RandomState(0)
    src = os.path.join(out_dir, "tree")
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "jpeg", "person_512_420.jpg")
    files = {"a/p0.png": png_bytes(rng.randint(0, 256, (480, 640, 3)).astype(
                 np.uint8)),
             "a/p1.png": png_bytes(rng.randint(0, 256, (600, 400, 3)).astype(
                 np.uint8)),
             "b/photo.jpg": open(fixture, "rb").read(),
             "b/q.bmp": _bmp24(np, rng.randint(0, 256, (300, 500, 3)).astype(
                 np.uint8))}
    for name, data in files.items():
        os.makedirs(os.path.dirname(os.path.join(src, name)), exist_ok=True)
        with open(os.path.join(src, name), "wb") as f:
            f.write(data)
    with open(os.path.join(src, "dataset.json"), "w") as f:
        json_.dump({"labels": [[n, i % 3] for i, n in enumerate(files)]}, f)
    dest = os.path.join(out_dir, "data.zip")
    t0 = time.perf_counter()
    dataset_tool.main(["--source", src, "--dest", dest, "--resolution",
                       "256x256", "--transform", "center-crop"])
    pack_s = time.perf_counter() - t0
    tree = ImageFolderDataset(src, use_labels=True)
    packed = ImageFolderDataset(dest, use_labels=True)
    try:
        check(len(packed) == len(tree) == 4, f"dataset_tool: {len(packed)} "
              f"items packed of {len(tree)}")
        for k in range(len(tree)):
            (a, la), (b, lb) = tree[k], packed[k]
            want = dataset_tool.transform_image(a, "center-crop", 256, 256)
            check(b.shape == (256, 256, 3) and np.array_equal(b, want)
                  and np.array_equal(la, lb),
                  f"dataset_tool: item {k} differs from its source")
        with zipfile.ZipFile(dest) as zf:
            names = sorted(zf.namelist())
        check(names == ["dataset.json"] + [f"img{i:08d}.png"
                                           for i in range(4)],
              f"dataset_tool: zip members {names}")
    finally:
        tree.close()
        packed.close()
    return {"items": 4, "pack_s": pack_s, "zip_bytes": os.path.getsize(dest)}


# ---------------------------------------------------------------------------
# StyleGAN3 synthesis, the ADA pipe and the image inputs added with them

# StyleGAN3-T at 512 (NVlabs/stylegan3 stylegan3-t-afhqv2-512x512.pkl)
SG3_512 = dict(z_dim=512, w_dim=512, img_resolution=512, img_channels=3,
               num_layers=14, channel_base=32768, channel_max=512)
# the tests' small configuration (tests/test_torch_stylegan3.py)
SG3_SMALL = dict(z_dim=16, w_dim=32, img_resolution=32, img_channels=3,
                 num_layers=4, channel_base=1024, channel_max=32)
SG3_BATCH = 4
SG3_ITERS = 5
SG3_REL_L2 = 1e-5
# the reference's bgc knobs (training/augment.py augpipe_specs) and the
# filter and corruption groups
ADA_KNOBS = dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                 xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                 saturation=1, imgfilter=1, noise=1, cutout=1)
ADA_RES = 512
ADA_BATCH = 32
ADA_P = 0.6
ADA_ITERS = 10
ADA_MAX_ABS = 1e-4


def _png_rgb(img, interlace):
    """An (H, W, 3) uint8 image as an RGB PNG, filter type None, Adam7-
    interlaced if asked."""
    import struct
    import zlib
    H_, W_ = img.shape[:2]
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)) if interlace \
        else ((0, 0, 1, 1),)
    rows = []
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size:
            rows += [b"\x00" + r.tobytes()
                     for r in sub.reshape(sub.shape[0], -1)]
    raw = b"".join(rows)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W_, H_, 8, 2, 0, 0, int(interlace)))
        + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def sg3_ada(torch, np, dev, out_dir):
    """Phase ``sg3_ada`` (see the module docstring).  The layer checks run
    the card's captured inputs at batch 1 on both devices: StyleGAN3's
    modulated conv normalises the styles over the whole batch, so a
    one-image CPU run is held to a one-image card run of the same layer."""
    import copy

    from sherf_tpu_torch.cli import dataset_tool
    from sherf_tpu_torch.data.image_folder import ImageFolderDataset
    from sherf_tpu_torch.data.png_read import decode_png
    from sherf_tpu_torch.eval.png import png_bytes
    from sherf_tpu_torch.features.augment import (AugmentPipe, Draws,
                                                  ReplayDraws)
    from sherf_tpu_torch.features.stylegan3 import SG3Generator

    out = {}
    # ---- StyleGAN3-T at 512 on the card
    g = SG3Generator(**SG3_512, device=dev,
                     generator=torch.Generator().manual_seed(0)).eval()
    net = g.synthesis
    held = (net.layer_names[0], net.layer_names[-2], net.layer_names[-1])
    seen = {}

    def capture(name):
        def hook(_mod, args, _out):
            if name not in seen:
                seen[name] = (args[0].detach().clone(),
                              args[1].detach().clone())
        return hook
    hooks = [getattr(net, n).register_forward_hook(capture(n)) for n in held]
    z = torch.randn(SG3_BATCH, SG3_512["z_dim"],
                    generator=torch.Generator().manual_seed(1)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    with torch.no_grad():
        for _ in range(SG3_ITERS + 1):
            t = time.perf_counter()
            img = g(z)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(img).all())
    # one more forward: each layer's device ms (CUDA events around it),
    # then one under the profiler (busy share, the top operations)
    events = {}

    def bracket(name):
        def pre(_mod, _args):
            events[name] = [torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)]
            events[name][0].record()

        def post(_mod, _args, _out):
            events[name][1].record()
        return pre, post
    hooks = []
    for name in ["input"] + net.layer_names:
        pre, post = bracket(name)
        mod = getattr(net, name)
        hooks += [mod.register_forward_pre_hook(pre),
                  mod.register_forward_hook(post)]
    with torch.no_grad():
        g(z)
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    layer_ms = {n: a.elapsed_time(b) for n, (a, b) in events.items()}
    with torch.no_grad():
        prof = profiled(lambda: g(z), torch, NONE)
    res = SG3_512["img_resolution"]
    check(img.shape == (SG3_BATCH, 3, res, res) and finite,
          f"sg3_ada: 512 image {tuple(img.shape)}, finite {finite}")
    layers = {}
    with torch.no_grad():
        for name in held:
            x, w = seen[name]
            layer = getattr(net, name)
            want = layer(x[:1], w[:1])
            got = copy.deepcopy(layer).cpu()(x[:1].cpu(), w[:1].cpu())
            layers[name] = _rel_l2(got, want.cpu())
            check(layers[name] <= SG3_REL_L2, f"sg3_ada: layer {name} card "
                  f"vs CPU relative L2 {layers[name]} > {SG3_REL_L2}")
    out["sg3_512"] = {
        "config": SG3_512, "batch": SG3_BATCH,
        "params": sum(p.numel() for p in g.parameters()),
        "forward_ms_median": statistics.median(ms[1:]),
        "forward_ms": ms, "first_forward_ms": ms[0],
        "peak_mem_gb": peak / 2 ** 30, "finite": finite,
        "image_abs_mean": float(img.abs().mean()),
        "layers_vs_cpu_rel_l2": layers, "layer_ms": layer_ms,
        "profile": {k: prof[k] for k in ("wall_ms_profiled",
                                         "device_busy_ms",
                                         "device_idle_share",
                                         "kernel_launches", "top_ops")}}
    del g, net, seen, img
    torch.cuda.empty_cache()

    # ---- the small configuration whole, card against CPU
    small = SG3Generator(**SG3_SMALL,
                         generator=torch.Generator().manual_seed(2)).eval()
    zs = torch.randn(2, SG3_SMALL["z_dim"],
                     generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref = small(zs)
        got = small.to(dev)(zs.to(dev)).cpu()
    out["sg3_small_vs_cpu_rel_l2"] = _rel_l2(got, ref)
    check(out["sg3_small_vs_cpu_rel_l2"] <= SG3_REL_L2,
          f"sg3_ada: small generator card vs CPU relative L2 "
          f"{out['sg3_small_vs_cpu_rel_l2']}")

    # ---- the ADA pipe at 512, batch 32
    rng = np.random.RandomState(4)
    yy, xx = np.mgrid[0:ADA_RES, 0:ADA_RES] / ADA_RES
    ph = rng.rand(ADA_BATCH, 3, 3) * 8
    imgs = np.sin(ph[..., 0, None, None] * xx + ph[..., 1, None, None] * yy
                  + ph[..., 2, None, None]) * 0.8 \
        + rng.randn(ADA_BATCH, 3, ADA_RES, ADA_RES) * 0.05
    x = torch.from_numpy(imgs.astype(np.float32)).to(dev)
    pipe = AugmentPipe(**ADA_KNOBS)
    gen = torch.Generator(device=dev).manual_seed(5)
    ms = []
    for _ in range(ADA_ITERS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe(x, ADA_P, generator=gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    rec = Draws(torch.Generator(device=dev).manual_seed(6), record=True)
    card = pipe(x, ADA_P, draws=rec).cpu()
    replay = ReplayDraws([(k, v.cpu()) for k, v in rec.record])
    cpu = pipe(x.cpu(), ADA_P, draws=replay)
    vs_cpu = float((card - cpu).abs().max())
    check(replay.exhausted and vs_cpu <= ADA_MAX_ABS,
          f"sg3_ada: augment card vs CPU max abs {vs_cpu}")
    # at p = 0 every gate is off; the four-band filter still applies its
    # fixed sum of separable bands, which is not the identity (a property
    # of the JAX pipe, whose own identity test leaves imgfilter out)
    no_filter = AugmentPipe(**{k: v for k, v in ADA_KNOBS.items()
                               if k != "imgfilter"})
    p0 = float((no_filter(x, 0.0, generator=gen) - x).abs().max())
    check(p0 <= ADA_MAX_ABS, f"sg3_ada: augment at p = 0 moved {p0}")
    p0_filter = float((pipe(x, 0.0, generator=gen) - x).abs().max())
    flip = AugmentPipe(xflip=1)(x, 1.0, generator=gen)
    mirrored = [bool(torch.equal(flip[i], x[i].flip(-1)))
                for i in range(ADA_BATCH)]
    same = [bool(torch.equal(flip[i], x[i])) for i in range(ADA_BATCH)]
    check(all(m or s_ for m, s_ in zip(mirrored, same)),
          "sg3_ada: an xflip image is neither a mirror nor the identity")
    out["augment_512"] = {
        "knobs": sorted(ADA_KNOBS), "res": ADA_RES, "batch": ADA_BATCH,
        "p": ADA_P,
        "ms_median": statistics.median(ms[1:]), "ms": ms,
        "draws": len(rec.record), "vs_cpu_max_abs": vs_cpu,
        "p0_max_abs": p0, "p0_with_imgfilter_max_abs": p0_filter,
        "xflip_mirrored": sum(mirrored),
        "xflip_identity": sum(same)}
    del x, card, cpu, rec, flip
    torch.cuda.empty_cache()

    # ---- dataset_tool enlarging; an Adam7 PNG
    src = os.path.join(out_dir, "small")
    os.makedirs(src)
    for i, (h, w) in enumerate(((48, 64), (90, 60), (100, 100))):
        with open(os.path.join(src, f"s{i}.png"), "wb") as f:
            f.write(png_bytes(rng.randint(0, 256, (h, w, 3)).astype(
                np.uint8)))
    dest = os.path.join(out_dir, "enlarged.zip")
    dataset_tool.main(["--source", src, "--dest", dest, "--resolution",
                       "256x192", "--transform", "center-crop-wide"])
    tree = ImageFolderDataset(src)
    packed = ImageFolderDataset(dest)
    try:
        check(len(packed) == len(tree) == 3, "sg3_ada: enlarged zip items")
        for k in range(3):
            want = dataset_tool.transform_image(tree[k][0],
                                                "center-crop-wide", 256, 192)
            check(packed[k][0].shape == (192, 256, 3)
                  and np.array_equal(packed[k][0], want),
                  f"sg3_ada: enlarged item {k} differs from its source")
    finally:
        tree.close()
        packed.close()
    img = rng.randint(0, 256, (509, 511, 3)).astype(np.uint8)
    inter, plain = _png_rgb(img, True), _png_rgb(img, False)
    t = time.perf_counter()
    got = decode_png(inter, "adam7.png")
    adam7_ms = (time.perf_counter() - t) * 1e3
    check(np.array_equal(got, decode_png(plain)) and np.array_equal(got, img),
          "sg3_ada: the Adam7 PNG differs from the non-interlaced one")
    out["host"] = {"enlarged_items": 3, "enlarged_to": "256x192",
                   "adam7_shape": list(img.shape), "adam7_decode_ms": adam7_ms}
    return out


# ---------------------------------------------------------------------------
# multi-process training: two ranks on the one card

# the meshes of phase ``parallel`` and their global batches
PAR_MESHES = ((1, 2), (2, 1))
# Adam's eps in the phase's comparisons (as the JAX package's sharded GAN
# test): g / (sqrt(v) + eps) flips sign under reduction-order noise for
# near-zero gradients, which no parameter tolerance can hold
PAR_EPS = 1e-3
PAR_LOSS_RTOL = 1e-4
PAR_PARAM_RTOL, PAR_PARAM_ATOL = 2e-3, 2e-5
# the gradient norm (f32): a wrong reduction scale (x rm, / dm) is >= 2x off
PAR_GRAD_NORM_RTOL = 1e-3
# bf16: the shards' matmuls and scatter-adds take other row counts and
# orders than the one-process step's, so gradients differ at bf16 rounding
# (~4e-3 an operation) and Adam's first step turns a near-zero gradient's
# sign flip into a 2 lr parameter difference; the bf16 run is held on its
# losses and on its gradients' global relative L2, the f32 run on the
# parameters
PAR_BF16_GRAD_REL = 1e-2
PAR_TIMED_STEPS = 3
PAR_JOIN_S = 600.0
# each rank's launches: per step / round phase, one item of the rank's
PAR_LAUNCHES = {"render": FRAME_LAUNCHES, "train": TRAIN_LAUNCHES,
                "gan_g": TRAIN_LAUNCHES, "gan_d": FRAME_LAUNCHES,
                "gan_dreg": NONE}


def _digest(model):
    import hashlib
    h = hashlib.sha256()
    for n, p in model.named_parameters():
        h.update(n.encode())
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def parallel_rank(rank, world, init_file, shape, out_dir):
    """One rank of phase ``parallel`` (run by ``parallel/launch.run_local``):
    the production scene at batch dm, this rank's shard.  In bf16 (the
    production dtype): a sharded render counted, its kernel calls held,
    and PAR_TIMED_STEPS timed, one sharded train step counted and held,
    PAR_TIMED_STEPS timed and one profiled, one sharded GAN round counted;
    in f32: one sharded train step and GAN round.  Rank 0 then runs the
    one-process phases on the same items (``parallel/reference.py``) and
    compares.  Writes ``rank<r>.json``."""
    import dataclasses

    import numpy as np
    import torch

    from sherf_tpu_torch.core.calibrate import (calibrate_budgets,
                                                calibrate_sparse_caps)
    from sherf_tpu_torch.core.config import (ModelConfig, RenderConfig,
                                             TrainConfig)
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch
    from sherf_tpu_torch.features.discriminator import DualDiscriminator
    from sherf_tpu_torch.features.sparseconv import prepare_voxel_volume
    from sherf_tpu_torch.kernels import _cuda
    from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_
    from sherf_tpu_torch.parallel import make_mesh, make_sharded_render
    from sherf_tpu_torch.parallel.mesh import shard_batch, shard_generator
    from sherf_tpu_torch.parallel.multihost import (
        coordination_barrier, maybe_initialize_distributed, rank_device)
    from sherf_tpu_torch.parallel.reference import (data_parallel_phase,
                                                    split_items)
    from sherf_tpu_torch.smpl import big_pose_params, smpl_forward, synthetic_smpl
    from sherf_tpu_torch.train import create_train_state, make_train_step
    from sherf_tpu_torch.train.gan import (_step_d, create_d_train_state,
                                           make_gan_train_step,
                                           make_sharded_gan_steps)
    from sherf_tpu_torch.train.step import make_sharded_train_step
    from sherf_tpu_torch.train.train_state import ema_beta, ema_update

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    maybe_initialize_distributed("file://" + init_file, world, rank,
                                 device="cuda")
    dev = rank_device("cuda")
    dm = shape[0]
    smpl = synthetic_smpl(0, device="cpu")
    bp = big_pose_params()
    with torch.no_grad():
        t_verts = smpl_forward(smpl, torch.from_numpy(bp["poses"]),
                               torch.from_numpy(bp["shapes"]))[0].numpy()
    base = ModelConfig(compute_dtype="bfloat16",
                       render=RenderConfig(depth_resolution=DEPTH,
                                           density_noise=0.0))
    _, out_sh = prepare_voxel_volume(t_verts, voxel_size=base.voxel_size)
    base = dataclasses.replace(base, sparse_caps=calibrate_sparse_caps(
        [t_verts], base.voxel_size))
    smpl_d = smpl.to(dev)
    batch = make_synthetic_batch(smpl, batch_size=dm, H=H, W=W, seed=0,
                                 device=dev)
    fitted, _ = calibrate_budgets([batch], base, margin=MARGIN)
    base = dataclasses.replace(base, render=fitted)
    mesh = make_mesh(shape)
    local = shard_batch(batch, mesh)
    groups = split_items(batch, dm)
    tcfg = TrainConfig(batch_size=dm, eps=PAR_EPS, adv_weight=GAN_ADV_WEIGHT,
                       d_reg_interval=GAN_REG_INTERVAL)
    beta = ema_beta(tcfg.batch_size, tcfg.ema_kimg)

    def generator(cfg):
        g = SHERFGenerator(cfg, out_sh=out_sh, device=dev)
        return random_init_(g, torch.Generator().manual_seed(0))

    def disc():
        d = DualDiscriminator(img_resolution=H).to(dev)
        return create_d_train_state(d, tcfg,
                                    generator=torch.Generator().manual_seed(1))

    def counted(fn, *args):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        ts = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, dict(_cuda.LAUNCHES), (time.perf_counter() - ts) * 1e3

    cases, errs = [], {k: 0.0 for k in HELD}

    def counted_held(path, fn, *args):
        """``counted``, every kernel call of the run then held against its
        plain version on the same card tensors (after the count: those
        launches are not counted)."""
        rec = Recorder(kernel_shims())
        with rec:
            got = counted(fn, *args)
        name = f"sharded_{shape[0]}x{shape[1]}_{path}"
        held = held_calls(torch, rec.calls, name, errs)
        for key, n in got[1].items():
            check(sum(c["kernel"] == key for c in held) >= n,
                  f"{name}: rank {rank} held fewer {key} calls than its "
                  f"{n} launches")
        cases.extend(dict(c, rank=rank) for c in held)
        return got

    def floats(m):
        return {k: float(v) for k, v in m.items()}

    def kept(model, grads=False):
        return {n: (p.grad if grads else p).detach().clone()
                for n, p in model.named_parameters()
                if not grads or p.grad is not None}

    def g_update(s):
        s.apply_gradients()
        ema_update(s.ema, s.model.named_parameters(), beta)

    def params_off(got, model):
        """Entries outside rtol / atol of the one-process parameters, and
        the worst entry's error in units of its tolerance."""
        bad, worst = 0, 0.0
        for n, p in model.named_parameters():
            a, b = got[n].double(), p.detach().double()
            tol = PAR_PARAM_ATOL + PAR_PARAM_RTOL * b.abs()
            bad += int(((a - b).abs() > tol).sum())
            worst = max(worst, float(((a - b).abs() / tol).max()))
        return bad, worst

    def grads_rel(got, model):
        """The global, the median and the worst per-leaf relative L2 of the
        sharded gradients against the one-process ones."""
        num = den = 0.0
        worst, name, leaves = 0.0, None, []
        for n, p in model.named_parameters():
            if p.grad is None:
                continue
            a, b = got[n].double(), p.grad.double()
            d2, r2 = float(((a - b) ** 2).sum()), float((b ** 2).sum())
            num, den = num + d2, den + r2
            if r2 > 0:
                leaves.append((d2 / r2) ** 0.5)
                if leaves[-1] > worst:
                    worst, name = leaves[-1], n
        return {"global": (num / den) ** 0.5, "worst_leaf": worst,
                "median_leaf": float(np.median(leaves)), "leaves": len(leaves),
                "worst_param": name}

    res = {"rank": rank, "mesh": [mesh.data, mesh.rays, mesh.data_index,
                                  mesh.ray_index],
           "backend": mesh.backend, "device": str(dev),
           "local_rays": int(local.ray_o.shape[1]), "launches": {},
           "setup_s": time.perf_counter() - t_start}
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, compute_dtype=dt)
        r = res[dt] = {}
        if dt == "bfloat16":                # (a) render
            render = make_sharded_render(generator(cfg).eval(), smpl_d, mesh)
            img, res["launches"]["render"], first_ms = counted_held(
                "render", render, local)
            r["render_ms"] = [first_ms] + [counted(render, local)[2]
                                           for _ in range(PAR_TIMED_STEPS)]
            r["render_overflow"] = float(img["overflow"])
        # (b) the train step
        g = generator(cfg)
        state = create_train_state(g, tcfg)
        step = make_sharded_train_step(g, smpl_d, tcfg, mesh)
        gen = shard_generator(0, mesh, dev)
        m, launches, first_ms = (counted_held("train", step, state, local,
                                              gen) if dt == "bfloat16" else
                                 counted(step, state, local, gen))
        r["train"], r["train_digest"] = floats(m), _digest(g)
        train_params, train_grads = kept(g), kept(g, grads=True)
        if dt == "bfloat16":
            res["launches"]["train"] = launches
            r["step_ms"] = [first_ms] + [counted(step, state, local, gen)[2]
                                         for _ in range(PAR_TIMED_STEPS)]
            prof = profiled(lambda: step(state, local, gen), torch,
                            TRAIN_LAUNCHES)
            r["step_profile"] = {k: prof[k] for k in (
                "wall_ms_profiled", "device_busy_ms", "device_idle_share",
                "kernel_launches", "port_kernels_ms")}
            r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del state, step, g
        # (c) one GAN round
        g = generator(cfg)
        g_state, d_state = create_train_state(g, tcfg), disc()
        g_step, d_main, d_reg = make_sharded_gan_steps(g, smpl_d, tcfg, mesh)
        gen = shard_generator(0, mesh, dev)
        for path, fn, args in (
                ("gan_g", g_step, (g_state, d_state, local, gen)),
                ("gan_d", d_main, (d_state, g_state, local, gen)),
                ("gan_dreg", d_reg, (d_state, local))):
            m, launches, r[f"{path}_ms"] = counted(fn, *args)
            r[path] = floats(m)
            if path == "gan_g":
                gan_g_grads = kept(g, grads=True)
            if dt == "bfloat16":
                res["launches"][path] = launches
        r["gan_digest"] = _digest(g) + _digest(d_state.model)
        gan_params = (kept(g), kept(d_state.model))
        del g_state, d_state, g_step, d_main, d_reg, g

        # (d) rank 0: the one-process phases on the same items, compared
        if rank == 0:
            gen = torch.Generator(device=dev).manual_seed(0)
            ref = {}
            if dt == "bfloat16":
                with torch.no_grad():
                    out, _ = generator(cfg).eval()(batch, smpl_d)
                d = mesh.data_index
                r["render_psnr_db"] = psnr_db(
                    np, img["image_raw"],
                    out["image_raw"][d:d + 1 if dm > 1 else None])
                del out, img
            g = generator(cfg)
            state = create_train_state(g, tcfg)
            ts = time.perf_counter()
            ref["train"] = data_parallel_phase(
                make_train_step(g, smpl_d, tcfg), state, groups,
                args_after=(gen,), step=g_update)
            torch.cuda.synchronize()
            r["one_process_step_ms"] = (time.perf_counter() - ts) * 1e3
            r["train_grads_rel"] = grads_rel(train_grads, g)
            r["train_params_off"] = params_off(train_params, g)
            del state, g
            g = generator(cfg)
            g_state, d_state = create_train_state(g, tcfg), disc()
            g_step, d_main, d_reg = make_gan_train_step(g, smpl_d, tcfg)
            ref["gan_g"] = data_parallel_phase(
                g_step, g_state, groups, args_before=(d_state,),
                args_after=(gen,), step=g_update)
            r["gan_g_grads_rel"] = grads_rel(gan_g_grads, g)
            ref["gan_d"] = data_parallel_phase(
                d_main, d_state, groups, args_before=(g_state,),
                args_after=(gen,), step=_step_d)
            ref["gan_dreg"] = data_parallel_phase(d_reg, d_state, groups,
                                                  step=_step_d)
            r["gan_g_params_off"] = params_off(gan_params[0], g)
            r["gan_d_params_off"] = params_off(gan_params[1], d_state.model)
            r["reference"] = {k: floats(v) for k, v in ref.items()}
            del g_state, d_state, g
        del train_params, train_grads, gan_params, gan_g_grads
        torch.cuda.empty_cache()
        coordination_barrier(f"parallel_{dt}")
    res["seconds"] = time.perf_counter() - t_start
    res["cases"], res["errs"] = cases, errs
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def parallel(torch, out_dir, meshes=PAR_MESHES, backend="gloo"):
    """Phase ``parallel``: two ranks on the card (gloo: NCCL refuses two
    ranks on one GPU) at the production scene (512x512x48, budgets
    calibrated at MARGIN on the global batch), at meshes (1, 2) (batch 1)
    and (2, 1) (batch 2).  Each rank runs the sharded render, train step
    and GAN round on its shard, in bf16 and in f32; rank 0 holds them to
    the one-process phases on the card.  f32: every phase's losses rtol
    1e-4, parameters after each step rtol 2e-3 / atol 2e-5, the gradient
    norm rtol 1e-3.  bf16: the losses of the phases that start from the
    shared weights (the train step, Gmain) rtol 1e-4, their gradients'
    global relative L2 <= 1e-2, the render >= 45 dB.  Every rank: overflow
    0, the expected launches per phase, the ``backend`` the ranks chose,
    the same parameters as rank 0 after each phase, and every kernel call
    of its first bf16 render and train step held against the kernel's
    plain version on the same card tensors (paths ``sharded_<dm>x<rm>_
    render`` / ``_train``).  Returns (numbers, held cases, each kernel's
    max abs error).  (``meshes`` and ``backend`` are for a run on more
    cards: there each rank owns its card and the backend is NCCL.)"""
    from sherf_tpu_torch.parallel.launch import run_local

    out, cases, errs = {}, [], {k: 0.0 for k in HELD}
    for shape in meshes:
        world = shape[0] * shape[1]
        key = f"mesh_{shape[0]}x{shape[1]}"
        run_dir = os.path.join(out_dir, key)
        os.makedirs(run_dir)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        codes = run_local(parallel_rank, world,
                          (os.path.join(run_dir, "store"), shape, run_dir),
                          timeout_s=PAR_JOIN_S)
        check(codes == [0] * world,
              f"parallel {shape}: rank exit codes {codes}")
        ranks = []
        for r in range(world):
            with open(os.path.join(run_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
            cases += ranks[-1].pop("cases")
            for k, e in ranks[-1].pop("errs").items():
                errs[k] = max(errs[k], e)
        r0 = ranks[0]
        for res in ranks:
            check(res["backend"] == backend,
                  f"parallel {shape}: backend {res['backend']}")
            for path, want in PAR_LAUNCHES.items():
                check(res["launches"][path] == want,
                      f"parallel {shape}: rank {res['rank']} {path} launches "
                      f"{res['launches'][path]}, expected {want}")
            for dt in ("bfloat16", "float32"):
                d = res[dt]
                check(d.get("render_overflow", 0) == 0
                      and d["train"]["overflow"] == 0
                      and d["gan_g"]["overflow"] == 0,
                      f"parallel {shape} {dt}: rank {res['rank']} overflow")
                check(d["train_digest"] == r0[dt]["train_digest"]
                      and d["gan_digest"] == r0[dt]["gan_digest"],
                      f"parallel {shape} {dt}: rank {res['rank']} parameters "
                      f"differ from rank 0's")
        b16, f32 = r0["bfloat16"], r0["float32"]
        check(b16["render_psnr_db"] == "inf" or b16["render_psnr_db"] >= 45.0,
              f"parallel {shape}: render {b16['render_psnr_db']} dB")
        # bf16: the phases that start from the shared weights (the train
        # step, Gmain); Dmain and Dreg start from the states Gmain and
        # Dmain stepped, which bf16's gradient noise has moved (see
        # PAR_BF16_GRAD_REL)
        for dt, d, phases in (("bfloat16", b16, ("train", "gan_g")),
                              ("float32", f32, ("train", "gan_g", "gan_d",
                                                "gan_dreg"))):
            for ph in phases:
                for k, v in d["reference"][ph].items():
                    if k == "overflow" or (k == "grad_norm"
                                           and dt == "bfloat16"):
                        continue
                    tol = PAR_GRAD_NORM_RTOL if k == "grad_norm" \
                        else PAR_LOSS_RTOL
                    check(abs(d[ph][k] - v) <= tol * abs(v),
                          f"parallel {shape} {dt}: {ph} {k} {d[ph][k]} vs "
                          f"one process {v}")
        for ph in ("train", "gan_g"):
            check(b16[f"{ph}_grads_rel"]["global"] <= PAR_BF16_GRAD_REL,
                  f"parallel {shape} bf16: {ph} gradients "
                  f"{b16[f'{ph}_grads_rel']} from the one-process step")
        for ph in ("train", "gan_g", "gan_d"):
            check(f32[f"{ph}_params_off"][0] == 0,
                  f"parallel {shape} f32: {ph} parameters off the "
                  f"one-process step: {f32[f'{ph}_params_off']} (entries, "
                  f"worst error in tolerances)")
        out[key] = {"seconds": time.perf_counter() - t0, "ranks": ranks}
    return out, cases, errs


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
    from sherf_tpu_torch.device_ops import device_work
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

    # ---- native: the host-ops library; dataset_tool: the image-folder zip
    t0 = time.perf_counter()
    phase("native", t0, **native_phase(np))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as dt_dir:
        phase("dataset_tool", t0, **dataset_tool_phase(np, dt_dir))

    # ---- sg3_ada: StyleGAN3-T at 512, the ADA pipe, the new image inputs
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as sg_dir:
        phase("sg3_ada", t0, **sg3_ada(torch, np, dev, sg_dir))
    torch.cuda.empty_cache()

    # ---- tf32: PyTorch's default against full f32, and the CLIs' repair --
    t0 = time.perf_counter()
    phase("tf32", t0, **tf32(torch, np, dev, cfg, out_sh, batch, smpl_d))

    shims = kernel_shims()
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
        prof = profiled(lambda: model(batch, smpl_d), torch, FRAME_LAUNCHES)
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
            prof = profiled(lambda: mdl(batch, smpl_d), torch, expect)
        knn_cluster.CLUSTERED = False
        phase(name, t0, launches=launches[name], overflow=overflow_c,
              psnr_vs_frame_db=psnr,
              max_abs_diff_vs_frame=float((img_c.float() - img.float()).abs().max()),
              survivors=survivors(rec.calls), frame_survivors=frame_survivors,
              frame_wall_ms_profiled=prof.pop("wall_ms_profiled"),
              device_busy_ms=prof["device_busy_ms"],
              device_idle_share=prof["device_idle_share"],
              kernel_launches=prof["kernel_launches"],
              port_kernels_ms=prof["port_kernels_ms"],
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

    # ---- branches: importance, capsule, OSG, SR at full width ------------
    t0 = time.perf_counter()
    branch, branch_cases, branch_errs = branches(
        torch, np, dev, cfg, out_sh, model, batch, smpl, smpl_d, shims,
        launches, frame_survivors["points"])
    phase("branches", t0, **branch)
    torch.cuda.empty_cache()

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
    prof = profiled(lambda: step_fn(state, batch, gen), torch, TRAIN_LAUNCHES)
    phase("train_profile", t0, step_wall_ms_profiled=prof.pop("wall_ms_profiled"),
          **prof)
    del before

    # ---- kernels vs their plain versions on the paths' own inputs --------
    # (these direct *_cuda calls add to LAUNCHES, which was read above)
    t0 = time.perf_counter()
    rows, cases = [], []
    errs = dict(branch_errs)

    def note_err(key, a, b):
        e = max_abs(a, b)
        errs[key] = max(errs[key], e)
        return e

    def bound(ops, nbytes):
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    def by_path(key):
        return {p: launches[p][key] for p in launches}

    # every call of the frame and of one train step against its plain
    # version; the frame's point-budget nn_1 call timed
    cases += held_calls(torch, rec_frame.calls, "frame", errs)
    cases += held_calls(torch, rec_train.calls, "train", errs)
    recorded = {k: rec_frame.calls[k] + rec_train.calls[k]
                for k in ("nn_1", "ray_body_mask", "compact_mask")}
    nn1_tile = _cuda.library().sherf_nn1_tile()
    coop = [coop_queries(q_c, nn1_tile, torch) for q_c, _ in recorded["nn_1"]]
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
        "coop_queries": coop[0], "coop_queries_by_call": coop,
        "tile": nn1_tile,
        "replaces": "sherf_tpu/kernels/knn_pallas.py:608",
        "launches": launches["frame"]["nn_1"], "launches_by_path": by_path("nn_1"),
        "max_abs_err": errs["nn_1"],
        "ms": cuda_ms(lambda: knn.nn_1_cuda(q_c, v_c), 5, torch),
        "plain_ms": cuda_ms(lambda: knn.nn_1_plain(q_c, v_c), 3, torch),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(nn1_library, 3, torch), "n": n, "v": nv})

    # ray_body_mask
    o_c, d, v_c, thr, act = recorded["ray_body_mask"][0]
    n, nv = o_c.shape[0], v_c.shape[0]
    tile = knn.RAY_TILE
    tile_any = torch.nn.functional.pad(act, (0, -n % tile)).reshape(
        -1, tile).any(dim=1)
    n_scanned = int(tile_any.sum()) * tile
    scanned = tile_any.repeat_interleave(tile)[:n]
    origins = int(torch.unique(o_c[scanned], dim=0).shape[0])
    # the least work on these rays: the origin-free operations of every
    # scanned pair, and w, a once per (origin, vertex)
    b_ms, b_by = bound(
        nv * (n_scanned * (RBM_OPS_PER_PAIR - RBM_OPS_PER_ORIGIN)
              + origins * RBM_OPS_PER_ORIGIN),
        n * (12 + 12 + 1 + 1) + nv * 12)
    # the same lines with each origin moved along its own ray: no two rays
    # share an origin, so every pair takes all 17 operations
    o_s = (o_c + d * torch.linspace(-0.3, 0.3, n, device=dev)[:, None]
           ).contiguous()
    case, err = held_ray_body_mask(torch, "ray_body_mask, origins spread",
                                   o_s, d, v_c, thr, act)
    errs["ray_body_mask"] = max(errs["ray_body_mask"], err)
    cases.append({"kernel": "ray_body_mask", "path": "frame",
                  "call": "origins_spread", **case})
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
        # the kernel issues no FMA: one operation per issue slot
        "no_fma_ceiling_ms": 2 * b_ms,
        # every scanned pair at 17 operations (no origin shared)
        "all_pairs_bound_ms": bound(n_scanned * nv * RBM_OPS_PER_PAIR, 0)[0],
        "rays_active": int(act.sum()), "rays_scanned": n_scanned,
        "origins_scanned": origins,
        "origins_spread_ms": cuda_ms(lambda: knn.ray_body_mask_cuda(
            o_s, d, v_c, thr, act), 5, torch),
        **knn.ray_body_mask_attrs()})
    del o_s

    # compact_mask: the frame's occupancy over all 512*512*48 samples (what the point
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
    case, err = held_compact_mask(torch, "compact_mask, full occupancy",
                                  full_mask, point_cap)
    errs["compact_mask"] = max(errs["compact_mask"], err)
    cases.append({"kernel": "compact_mask", "path": "frame",
                  "call": "full_occupancy", **case})

    def per_launch(fn):
        """compact_mask's kernel and memset ms and counts a call; fails
        unless a call is one kernel and one memset (to the nearest whole
        count)."""
        ops = device_work(fn)["ops"]
        k = [o for key, o in ops.items()
             if PORT_KERNELS["compact_mask"][0] in key]
        mset = [o for key, o in ops.items() if "Memset" in key]
        out = {"kernel_ms": sum(o["ms"] for o in k),
               "memset_ms": sum(o["ms"] for o in mset),
               "kernels_per_call": sum(o["per_call"] for o in k),
               "memsets_per_call": sum(o["per_call"] for o in mset)}
        check(round(out["kernels_per_call"]) == 1
              and round(out["memsets_per_call"]) == 1,
              f"compact_mask: a call issued {out}, expected one kernel and "
              f"one memset")
        return out

    def back_to_back_ms(fn, reps=50):
        """Host ms per call of ``fn`` issued back to back: the wrapper's own
        cost where the device work is shorter."""
        fn()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - ts) * 1e3 / reps

    frame_calls = []
    for m, cap in rec_frame.calls["compact_mask"]:
        call = lambda: compaction.compact_mask_cuda(m, cap)  # noqa: E731
        frame_calls.append({
            "n": m.shape[0], "cap": cap, "survivors": int(m.sum()),
            "ms": cuda_ms(call, 20, torch), **per_launch(call),
            "back_to_back_ms": back_to_back_ms(call),
            "bound_ms": bound(0, m.shape[0] + 5 * cap)[0]})
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
        "cap": cap, "calls": frame_calls,
        **per_launch(lambda: compaction.compact_mask_cuda(m, cap)),
        "frame_kernel_ms": sum(c["kernel_ms"] for c in frame_calls),
        "frame_bound_ms": sum(c["bound_ms"] for c in frame_calls)})
    del full_mask

    # weighted_accumulate: each call of the first train step (held above)
    # with its shape, zero-row share, split and time
    wa_calls = rec_train.calls["weighted_accumulate"]
    check(len(wa_calls) == TRAIN_LAUNCHES["weighted_accumulate"],
          f"{len(wa_calls)} weighted_accumulate calls recorded in step 1")
    wa_held = [c for c in cases if c["kernel"] == "weighted_accumulate"]
    wa_by_call = []
    for (ids, w, g, n_rows), held in zip(wa_calls, wa_held):
        wa_by_call.append({
            "n": ids.shape[0], "k": ids.shape[1], "c": g.shape[1],
            "n_rows": n_rows,
            # taps on the zero row (every empty or out-of-volume corner)
            "id0_share": float((ids == 0).float().mean()),
            "tiling": segment_accum.weighted_accumulate_tiling(
                ids.shape[0], ids.shape[1], g.shape[1]),
            "ms": cuda_ms(lambda: segment_accum.weighted_accumulate_cuda(
                ids, w, g, n_rows), 5, torch),
            **{k: held[k] for k in ("bound_use", "plain_use",
                                    "plain_spread")}})
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

    # the clustered kernels: every call of cluster_frame and shortlist_frame.
    # The prep kernel's Clusters against the plain prep (bit for bit), each
    # kernel against its plain version on them (same visit rule: bit-equal;
    # B6's lists against shortlist_tiles), and against the full-scan kernel
    # on the same raw inputs.  The two centre on f32 means that differ in
    # the last bit, which moves each centred coordinate by up to half an
    # ulp (6e-8 m at 1 m) and d2 by up to about 1e-4 relative or 1e-7 m^2;
    # ties may go to another vertex at the same distance, so the index is
    # held to the f64 distance at the full scan's
    check(_cuda.library().sherf_nn1_cluster_unit() == knn_cluster.NN_GROUP
          and _cuda.library().sherf_nn1_shortlist_tile() == knn_cluster.P_TILE,
          "the clustered kernels' grain differs from the plain versions'")

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

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def checked_prep(key, i, ref, csize, sorted_mean):
        """The prep kernel's Clusters of ``ref``, held bit for bit against
        the plain prep's."""
        ck = knn_cluster.make_clusters_cuda(ref, csize, sorted_mean)
        cp = knn_cluster.make_clusters_plain(ref, csize, sorted_mean)
        torch.cuda.synchronize()
        for f in ("order", "vs", "ctr0", "cent", "rad"):
            a, b = getattr(ck, f), getattr(cp, f)
            note_err("cluster_prep", a, b)
            check(a.shape == b.shape and torch.equal(bits(a), bits(b)),
                  f"cluster_prep for {key} call {i}: {f} differs from the "
                  f"plain prep")
        return ck

    clus = {"nn_1_clustered": rec_cluster["cluster_frame"]["nn_1_clustered"],
            "nn_1_shortlist": rec_cluster["shortlist_frame"]["nn_1_shortlist"],
            "ray_body_mask_clustered": (
                rec_cluster["cluster_frame"]["ray_body_mask_clustered"]
                + rec_cluster["shortlist_frame"]["ray_body_mask_clustered"])}

    def kernel_ms(fn, key):
        """Device ms of the ``key`` kernel in a call of ``fn`` (profiler)."""
        return sum(o["ms"] for name, o in device_work(fn)["ops"].items()
                   if PORT_KERNELS[key][0] in name)

    prep = {}
    for i, (query, ref) in enumerate(clus["nn_1_clustered"]):
        cl = checked_prep("nn_1_clustered", i, ref, knn_cluster.C_SIZE, True)
        q_c = (query - cl.ctr0).contiguous()
        d2k, ik = knn_cluster.nn_1_clustered_cuda(query, cl)
        d2p, ip, visits = knn_cluster.nn_1_clustered_plain(q_c, cl)
        torch.cuda.synchronize()
        err = note_err("nn_1_clustered", d2k, d2p)
        note_err("nn_1_clustered", ik, ip)
        check(torch.equal(ik, ip), f"nn_1_clustered call {i}: indices differ")
        check(torch.equal(bits(d2k), bits(d2p)), f"nn_1_clustered call {i}: "
              f"d2 not bit-equal (max abs err {err})")
        full = knn_vs_full("nn_1_clustered", i, query, ref, d2k,
                           cl.order[ik.long()])
        prep.setdefault("nn_1_clustered", (query, ref, cl, q_c, visits, d2k))
        cases.append({"kernel": "nn_1_clustered", "call": i,
                      "n": query.shape[0], "v": ref.shape[0], "equal": True,
                      "prep_equal": True, "pairs_admitted": int(visits.sum()),
                      "pairs_needed": knn_cluster.needed_pairs(q_c, cl, d2k),
                      "kernel_device_ms": kernel_ms(
                          lambda: knn_cluster.nn_1_clustered_cuda(query, cl),
                          "nn_1_clustered"),
                      **full})
    for i, (query, ref, _) in enumerate(clus["nn_1_shortlist"]):
        cl = checked_prep("nn_1_shortlist", i, ref, knn_cluster.SL_CSIZE,
                          False)
        q_c = (query - cl.ctr0).contiguous()
        counts, ids, _, _ = knn_cluster.shortlist_tiles(q_c, cl)
        lists = (torch.empty_like(counts), torch.empty_like(ids))
        d2k, ik, over = knn_cluster.nn_1_shortlist_cuda(query, cl, lists=lists)
        d2p, ip, visits = knn_cluster.nn_1_shortlist_plain(q_c, cl, counts, ids)
        torch.cuda.synchronize()
        check(torch.equal(lists[0], counts) and torch.equal(lists[1], ids),
              f"nn_1_shortlist call {i}: the kernel's tile lists differ from "
              f"shortlist_tiles")
        check(int(over) == 0, f"nn_1_shortlist call {i}: overflow {int(over)}")
        err = note_err("nn_1_shortlist", d2k, d2p)
        note_err("nn_1_shortlist", ik, ip)
        check(torch.equal(ik, ip), f"nn_1_shortlist call {i}: indices differ")
        check(torch.equal(bits(d2k), bits(d2p)), f"nn_1_shortlist call {i}: "
              f"d2 not bit-equal (max abs err {err})")
        full = knn_vs_full("nn_1_shortlist", i, query, ref, d2k,
                           cl.order[ik.long()])
        prep.setdefault("nn_1_shortlist", (query, ref, cl, q_c, visits, d2k,
                                           counts))
        cases.append({"kernel": "nn_1_shortlist", "call": i,
                      "n": query.shape[0], "v": ref.shape[0], "equal": True,
                      "prep_equal": True, "lists_equal": True,
                      "pairs_admitted": int(visits.sum()),
                      "pairs_needed": knn_cluster.needed_pairs(q_c, cl, d2k),
                      "clusters_per_tile_mean": float(counts.float().mean()),
                      "kernel_device_ms": kernel_ms(
                          lambda: knn_cluster.nn_1_shortlist_cuda(query, cl),
                          "nn_1_shortlist"),
                      **full})
    # B7: the kernel on the frame's raw strided views, as the wrapper
    # passes them; the plain version on the centred copy
    for i, (ray_o, ray_d, verts, thr) in enumerate(
            clus["ray_body_mask_clustered"]):
        cl = checked_prep("ray_body_mask_clustered", i, verts,
                          knn_cluster.C_SIZE, True)
        o_c = (ray_o - cl.ctr0).contiguous()
        mk = knn_cluster.ray_body_mask_clustered_cuda(ray_o, ray_d, cl, thr)
        mp, visits = knn_cluster.ray_body_mask_clustered_plain(o_c, ray_d, cl,
                                                               thr)
        o_f, v_f = knn._centre(ray_o, verts)
        mf = knn.ray_body_mask_cuda(o_f, ray_d.contiguous(), v_f, thr)
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
                      "n": ray_o.shape[0], "equal": True, "prep_equal": True,
                      "strides": [list(ray_o.stride()), list(ray_d.stride())],
                      "full_scan_borderline_flips": off.numel(),
                      "pairs": int(visits.sum()), "hits": int(mk.sum()),
                      "kernel_device_ms": kernel_ms(
                          lambda: knn_cluster.ray_body_mask_clustered_cuda(
                              ray_o, ray_d, cl, thr),
                          "ray_body_mask_clustered")})

    def cdist_min(q, v):
        def run():
            for s in range(0, q.shape[0], chunk):
                torch.cdist(q[s:s + chunk], v,
                            compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)
        return run

    def wrapper_ops(fn):
        """Device operations a call of a public clustered wrapper issues
        (kernels, memsets, copies, from the profiler); fails above
        CLUSTER_WRAPPER_OPS."""
        work = device_work(fn)
        check(round(work["ops_per_call"]) <= CLUSTER_WRAPPER_OPS,
              f"a clustered wrapper issued {work}, more than "
              f"{CLUSTER_WRAPPER_OPS} device operations a call")
        return {"device_ops_per_call": work["ops_per_call"],
                "device_ops": work["ops"]}

    # B5 and B6 timed at the point-budget KNN (the first call of each
    # frame), B7 at the ray prune.  The bounds of B5 and B6 count the pairs
    # these inputs need (pairs_needed: each run of bit-identical queries
    # once, the rows of every cluster whose lower bound is <= the query's
    # final d2); pairs_admitted is the count of PR 6-8 (the pairs each
    # query's own bound test admitted, B5, or its tile listed, B6, copies
    # included), and copies_share its part from queries that repeat the one
    # before.  B7's bound counts the pairs each ray's test admitted.
    # full_scan_ms: the full-scan kernel on the same inputs (for B7 also
    # with the default path's AABB tile skip); *wrapper_ms: the public
    # function, prep included, against the full scan's
    query, ref, cl, q_c, visits, d2k = prep["nn_1_clustered"]
    n, nv, nc = query.shape[0], ref.shape[0], cl.cent.shape[0]
    chunk = max(1, int(4e9 // (nv * 4)))
    q_f, v_f = knn._centre(query, ref)
    admitted = int(visits.sum())
    copies = ~knn_cluster.run_starts(q_c)
    needed = knn_cluster.needed_pairs(q_c, cl, d2k)
    nbytes = n * 20 + nv * 12 + nc * 16
    b_ms, b_by = bound(needed * NN1_OPS_PER_PAIR, nbytes)
    rows.append({
        "name": "nn_1_clustered", "route": "cuda",
        "source": "sherf_tpu_torch/csrc/knn_cluster.cu",
        "replaces": "sherf_tpu/kernels/knn_pallas.py:207",
        "launches": launches["cluster_frame"]["nn_1_clustered"],
        "launches_by_path": by_path("nn_1_clustered"),
        "max_abs_err": errs["nn_1_clustered"],
        "ms": cuda_ms(lambda: knn_cluster.nn_1_clustered_cuda(query, cl), 5,
                      torch),
        "plain_ms": cuda_ms(lambda: knn_cluster.nn_1_clustered_plain(q_c, cl),
                            3, torch),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(cdist_min(q_c, cl.vs), 3, torch),
        "full_scan_ms": cuda_ms(lambda: knn.nn_1_cuda(q_f, v_f), 5, torch),
        "wrapper_ms": cuda_ms(lambda: knn_cluster.nn_1_clustered(query, ref),
                              5, torch),
        "full_scan_wrapper_ms": cuda_ms(lambda: knn.nn_1(query, ref), 5, torch),
        **wrapper_ops(lambda: knn_cluster.nn_1_clustered(query, ref)),
        "n": n, "v": nv, "clusters": nc, "pairs_needed": needed,
        "pairs_admitted": admitted,
        "bound_admitted_ms": bound(admitted * NN1_OPS_PER_PAIR, nbytes)[0],
        "copies": int(copies.sum()),
        "copies_share_of_admitted": int(visits[copies].sum()) / max(admitted, 1),
        "coop_queries": coop_queries(q_c, knn_cluster.NN_GROUP, torch),
        "pairs_share": admitted / (n * nv)})

    query, ref, cl, q_c, visits, d2k, counts = prep["nn_1_shortlist"]
    n, nv, nc = query.shape[0], ref.shape[0], cl.cent.shape[0]
    q_f, v_f = knn._centre(query, ref)
    admitted = int(visits.sum())
    copies = ~knn_cluster.run_starts(q_c)
    needed = knn_cluster.needed_pairs(q_c, cl, d2k)
    nbytes = n * 20 + nv * 12 + nc * 16
    b_ms, b_by = bound(needed * NN1_OPS_PER_PAIR, nbytes)
    rows.append({
        "name": "nn_1_shortlist", "route": "cuda",
        "source": "sherf_tpu_torch/csrc/knn_cluster.cu",
        "replaces": "sherf_tpu/kernels/knn_pallas.py:318",
        "launches": launches["shortlist_frame"]["nn_1_shortlist"],
        "launches_by_path": by_path("nn_1_shortlist"),
        "max_abs_err": errs["nn_1_shortlist"],
        "ms": cuda_ms(lambda: knn_cluster.nn_1_shortlist_cuda(query, cl), 5,
                      torch),
        "plain_ms": cuda_ms(lambda: knn_cluster.nn_1_shortlist_plain(
            q_c, cl, *knn_cluster.shortlist_tiles(q_c, cl)[:2]), 3, torch),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(cdist_min(q_c, cl.vs), 3, torch),
        "full_scan_ms": cuda_ms(lambda: knn.nn_1_cuda(q_f, v_f), 5, torch),
        "wrapper_ms": cuda_ms(lambda: knn_cluster.nn_1_shortlist(query, ref),
                              5, torch),
        "full_scan_wrapper_ms": cuda_ms(lambda: knn.nn_1(query, ref), 5, torch),
        **wrapper_ops(lambda: knn_cluster.nn_1_shortlist(query, ref)),
        "n": n, "v": nv, "clusters": nc, "tiles": counts.numel(),
        "clusters_per_tile_mean": float(counts.float().mean()),
        "pairs_needed": needed, "pairs_admitted": admitted,
        "bound_admitted_ms": bound(admitted * NN1_OPS_PER_PAIR, nbytes)[0],
        "copies": int(copies.sum()),
        "copies_share_of_admitted": int(visits[copies].sum()) / max(admitted, 1),
        "coop_queries": coop_queries(q_c, knn_cluster.NN_GROUP, torch),
        "pairs_share": admitted / (n * nv)})

    # B7: the bound counts what these rays need at the kernel's grain
    # (rbmc_ops; all_pairs_bound_ms: every admitted pair at 17, the count of
    # PRs 6-9)
    ray_o, ray_d, verts, thr, cl, o_c, visits = prep["ray_body_mask_clustered"]
    n, nv, nc = ray_o.shape[0], verts.shape[0], cl.cent.shape[0]
    o_f, v_f = knn._centre(ray_o, verts)
    d_full = ray_d.contiguous()
    act = recorded["ray_body_mask"][0][4]       # the default frame's AABB mask
    pairs = int(visits.sum())
    origins = int(torch.unique(o_c, dim=0).shape[0])
    near = near_pairs(o_c, ray_d, cl, thr, torch)
    nbytes = n * 25 + nv * 12 + nc * 16
    b_ms, b_by = bound(rbmc_ops(n, nv, nc, pairs, origins, near), nbytes)
    # the same lines with each origin moved along its own ray: every unit
    # takes the kernel's unshared branch (17 operations a pair)
    o_s = (ray_o + ray_d * torch.linspace(-0.3, 0.3, n, device=dev)[:, None]
           ).contiguous()
    mk = knn_cluster.ray_body_mask_clustered_cuda(o_s, ray_d, cl, thr)
    mp, vis_s = knn_cluster.ray_body_mask_clustered_plain(
        (o_s - cl.ctr0).contiguous(), ray_d, cl, thr)
    torch.cuda.synchronize()
    note_err("ray_body_mask_clustered", mk, mp)
    check(torch.equal(mk, mp), f"ray_body_mask_clustered, origins spread: "
          f"masks differ ({int((mk != mp).sum())} rays)")
    cases.append({"kernel": "ray_body_mask_clustered", "call": "origins_spread",
                  "n": n, "equal": True, "hits": int(mk.sum()),
                  "pairs": int(vis_s.sum())})
    o_sc = (o_s - cl.ctr0).contiguous()
    origins_s = int(torch.unique(o_sc, dim=0).shape[0])
    near_s = near_pairs(o_sc, ray_d, cl, thr, torch)
    del o_sc
    union_pairs, union_slots = warp_union_pairs(o_c, ray_d, cl, thr, torch)
    rows.append({
        "name": "ray_body_mask_clustered", "route": "cuda",
        "source": "sherf_tpu_torch/csrc/knn_cluster.cu",
        "replaces": "sherf_tpu/kernels/knn_pallas.py:501",
        "launches": launches["cluster_frame"]["ray_body_mask_clustered"],
        "launches_by_path": by_path("ray_body_mask_clustered"),
        "max_abs_err": errs["ray_body_mask_clustered"],
        "ms": cuda_ms(lambda: knn_cluster.ray_body_mask_clustered_cuda(
            ray_o, ray_d, cl, thr), 20, torch),
        "plain_ms": cuda_ms(lambda: knn_cluster.ray_body_mask_clustered_plain(
            o_c, ray_d, cl, thr), 3, torch),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "all_pairs_bound_ms": bound(pairs * RBM_OPS_PER_PAIR, nbytes)[0],
        "origins_spread_ms": cuda_ms(
            lambda: knn_cluster.ray_body_mask_clustered_cuda(
                o_s, ray_d, cl, thr), 20, torch),
        "origins_spread_bound_ms": bound(rbmc_ops(
            n, nv, nc, int(vis_s.sum()), origins_s, near_s), nbytes)[0],
        "full_scan_ms": cuda_ms(lambda: knn.ray_body_mask_cuda(
            o_f, d_full, v_f, thr), 5, torch),
        "full_scan_active_ms": cuda_ms(lambda: knn.ray_body_mask_cuda(
            o_f, d_full, v_f, thr, act), 5, torch),
        "wrapper_ms": cuda_ms(lambda: knn_cluster.ray_body_mask_clustered(
            ray_o, ray_d, verts, thr), 20, torch),
        "full_scan_wrapper_ms": cuda_ms(lambda: knn.ray_body_mask(
            ray_o, ray_d, verts, thr, active=act), 5, torch),
        **wrapper_ops(lambda: knn_cluster.ray_body_mask_clustered(
            ray_o, ray_d, verts, thr)),
        **knn_cluster.ray_body_mask_clustered_attrs(),
        "n": n, "v": nv, "clusters": nc, "origins": origins,
        "near_pairs": near, "origins_spread_near_pairs": near_s,
        "strides": [list(ray_o.stride()), list(ray_d.stride())],
        "pairs": pairs, "pairs_share": pairs / (n * nv),
        "origins_spread_pairs": int(vis_s.sum()),
        "warp_union_pairs": union_pairs,
        "warp_union_lane_slots": union_slots})
    del o_s

    # the prep kernel, timed at the point-budget KNN's vertices (B5's
    # clusters); bound: its bytes (read V rows, write the order, the sorted
    # rows, centroids and radii)
    ref = prep["nn_1_clustered"][1]
    nv = ref.shape[0]
    nc = -(-nv // knn_cluster.C_SIZE)
    b_ms, b_by = bound(0, nv * (12 + 8 + 12) + nc * 16 + 12)
    rows.append({
        "name": "cluster_prep", "route": "cuda",
        "source": "sherf_tpu_torch/csrc/knn_cluster.cu",
        # no Pallas kernel: the XLA prep of nn_1_clustered_pallas and its
        # two siblings (morton_order, gather, centre, _cluster_stats_sized)
        "replaces": "sherf_tpu/kernels/knn_pallas.py:220",
        "launches": launches["cluster_frame"]["cluster_prep"],
        "launches_by_path": by_path("cluster_prep"),
        "max_abs_err": errs["cluster_prep"],
        "ms": cuda_ms(lambda: knn_cluster.make_clusters_cuda(
            ref, knn_cluster.C_SIZE, True), 20, torch),
        "plain_ms": cuda_ms(lambda: knn_cluster.make_clusters_plain(
            ref, knn_cluster.C_SIZE, True), 5, torch),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shortlist_ms": cuda_ms(lambda: knn_cluster.make_clusters_cuda(
            ref, knn_cluster.SL_CSIZE, False), 20, torch),
        "v": nv, "clusters": nc})
    del prep, clus
    rec_frame.calls.clear()
    rec_train.calls.clear()
    rec_cluster.clear()
    # printed after the lifecycle phase, whose kernel calls join its cases
    kernels_s = time.perf_counter() - t0

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
        grid_png = os.path.exists(os.path.join(run_dir, "fakes000002.png"))
    loss_steps = [x["step"] for x in lines if "Loss/loss" in x]
    check(loop_state.step == 2, f"training_loop ran {loop_state.step} steps")
    check(loss_steps == [1, 2], f"stats.jsonl loss lines at steps {loss_steps}")
    check(all(np.isfinite(x["Loss/loss"]) and x["Loss/overflow"] == 0
              for x in lines if "Loss/loss" in x), "training_loop metrics")
    check(ckpt is not None and ckpt.endswith("snapshot-000002.pt"),
          f"training_loop checkpoint {ckpt}")
    # two steps and the snapshot's sample grid (one frame, EMA weights)
    check(all(loop_launches[k] == 2 * v + FRAME_LAUNCHES[k]
              for k, v in TRAIN_LAUNCHES.items()),
          f"training_loop launches {loop_launches}")
    check(grid_png, "training_loop wrote no sample grid")
    phase("train_loop", t0, steps=loop_state.step, launches=loop_launches,
          stats_lines=len(lines), checkpoint_mb=round(ckpt_mb, 1))
    del loop_state
    torch.cuda.empty_cache()

    # ---- lifecycle: train -> snapshot -> the eval CLI on the snapshot ------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as life_dir:
        life, life_cases, life_errs = lifecycle(torch, np, dev, smpl_d,
                                                life_dir, shims)
    for row in rows:
        row["launches_per_eval_render"] = life["launches_per_render"][row["name"]]
        if row["name"] in life_errs:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     life_errs[row["name"]])
    phase("lifecycle", t0, **life)

    # ---- loaders: HuMMan and RenderPeople trees through the CLIs ----------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as load_dir:
        load, load_cases, load_errs = loaders(torch, np, dev, load_dir, shims)
        for row in rows:
            row["launches_per_loader_step"] = load["humman"][
                "launches_per_step"].get(row["name"], 0)
            row["launches_per_loader_render"] = load["humman"][
                "launches_per_render"][row["name"]]
            if row["name"] in load_errs:
                row["max_abs_err"] = max(row["max_abs_err"],
                                         load_errs[row["name"]])
        phase("loaders", t0, **load)

        # ---- render_clis: gen_videos, gen_samples, render_demo,
        # debug_project (on the loaders' HuMMan tree), the visualizer ------
        t0 = time.perf_counter()
        rc_dir = os.path.join(load_dir, "render_clis")
        os.makedirs(rc_dir)
        rc, rc_cases, rc_errs, _ = render_clis(
            torch, np, dev, rc_dir, os.path.join(load_dir, "humman"), shims)
        for row in rows:
            row["launches_per_orbit_frame"] = rc["gen_videos"][
                "launches_per_frame"].get(row["name"], 0)
            row["launches_per_query_chunk"] = rc["gen_samples"][
                "launches_per_chunk"].get(row["name"], 0)
            row["launches_by_path"].update(
                orbit_frame=row["launches_per_orbit_frame"],
                query_chunk=row["launches_per_query_chunk"])
            if row["name"] in rc_errs:
                row["max_abs_err"] = max(row["max_abs_err"],
                                         rc_errs[row["name"]])
        phase("render_clis", t0, **rc)
    torch.cuda.empty_cache()

    # ---- gan: the adversarial phases; gan_metrics: calc_metrics on its run
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as gan_dir:
        gan_out, gan_cases, gan_errs, gan_launches, snap = gan(
            torch, np, dev, cfg, out_sh, model, batch, smpl, smpl_d, shims,
            gan_dir)
        for row in rows:
            row["launches_per_gan_round"] = {
                p: n.get(row["name"], 0) for p, n in gan_launches.items()}
            row["launches_by_path"].update(row["launches_per_gan_round"])
            if row["name"] in gan_errs:
                row["max_abs_err"] = max(row["max_abs_err"],
                                         gan_errs[row["name"]])
        phase("gan", t0, **gan_out)
        t0 = time.perf_counter()
        phase("gan_metrics", t0, **gan_metrics(torch, np, dev, gan_dir, snap))
    torch.cuda.empty_cache()

    # ---- parallel: the sharded steps over two ranks on the card -----------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as par_dir:
        par, par_cases, par_errs = parallel(torch, par_dir)
    for row in rows:
        if row["name"] in par_errs:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     par_errs[row["name"]])
        row["launches_per_sharded_phase"] = {
            key: {path: n.get(row["name"], 0)
                  for path, n in res["ranks"][0]["launches"].items()}
            for key, res in par.items()}
        row["launches_by_path"].update({
            f"sharded_{path}": n for path, n in row[
                "launches_per_sharded_phase"]["mesh_1x2"].items()})
    phase("parallel", t0, **par)
    phase("kernels", time.perf_counter() - kernels_s,
          cases=cases + branch_cases + life_cases + load_cases + rc_cases
          + gan_cases + par_cases)
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
