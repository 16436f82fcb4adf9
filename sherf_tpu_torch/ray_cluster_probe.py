"""Where the time of ``ray_body_mask_clustered``'s kernel goes, on the
frame's ray prune.

The kernel (``ray_mask_cluster_kernel`` in ``csrc/knn_cluster.cu``) stages
the vertices, computes each (ray, cluster) bound, and visits the clusters
a ray's bound admits.  This script builds the kernel library in variants,
each set by the ``SHERF_PROBE`` and ``SHERF_RAY_*`` macros of that source
(all built at once, one ``nvcc`` each, into ``sherf_tpu_torch/_build/probe/``),
and times each on the production frame's ray prune: the 512x512 rays of the
synthetic batch (seed 0) against its 6,890 posed vertices at the renderer's
threshold.

* ``as_built``: no macro set;
* ``stage_only``: every block stages and leaves;
* ``bounds_only``: the bounds and their ballots, no visit;
* ``no_quick_reject``: every bound takes the exact test with its square
  root;
* ``one_ray_an_iteration``: a visit's loop tests one ray an iteration
  (two as built);
* ``stage_sync``: the vertices staged through registers (``cp.async``
  as built);
* ``block_512``: blocks of 16 warps, two an SM, each staging the vertices
  (one block of 32 warps an SM as built);
* ``unit_32``, ``unit_16``, ``unit_4``: units of 32, 16 or 4 rays, 1, 2
  or 8 lanes a ray (8 rays, 4 lanes a ray, as built);
* ``rows_2``, ``rows_8``: 2 or 8 rows a lane a pass (4 as built).

For each: ``kernel_ms``, the kernel's device time a call from the profiler
(``device_ops.device_work``, a mean over 20 calls), its registers and
spilled bytes, and, for the variants that compute the mask, whether it
equals the plain version's.

Needs a CUDA device and nvcc; prints one JSON line.

    python sherf_tpu_torch/ray_cluster_probe.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

# (name, nvcc defines)
VARIANTS = (
    ("as_built", ()),
    ("stage_only", ("SHERF_PROBE=1",)),
    ("bounds_only", ("SHERF_PROBE=2",)),
    ("no_quick_reject", ("SHERF_PROBE=3",)),
    ("one_ray_an_iteration", ("SHERF_PROBE=4",)),
    ("stage_sync", ("SHERF_PROBE=5",)),
    ("block_512", ("SHERF_RAY_WARPS=16",)),
    ("unit_32", ("SHERF_RAY_UNIT=32",)),
    ("unit_16", ("SHERF_RAY_UNIT=16",)),
    ("unit_4", ("SHERF_RAY_UNIT=4",)),
    ("rows_2", ("SHERF_RAY_ROWS=2",)),
    ("rows_8", ("SHERF_RAY_ROWS=8",)),
)
NO_MASK = ("stage_only", "bounds_only")
KERNEL = "ray_mask_cluster_kernel"


def frame_rays(dev):
    """(ray_o, ray_d, vertices, thr) of the production frame's ray prune,
    in the frame's layout."""
    import numpy as np
    from sherf_tpu_torch.core.config import RenderConfig
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch
    from sherf_tpu_torch.smpl import synthetic_smpl
    batch = make_synthetic_batch(synthetic_smpl(0, device="cpu"), batch_size=1,
                                 H=512, W=512, seed=0, device=dev)
    thr = (float(np.sqrt(RenderConfig().prune_threshold_sq)) + 1e-3) ** 2
    return batch.ray_o[0], batch.ray_d[0], batch.vertices[0], thr


def build_all():
    """Start one nvcc a variant, all at once; return {name: library path}."""
    from sherf_tpu_torch.kernels import _cuda
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    srcs = [str(s) for s in _cuda._sources()]
    procs = {}
    for name, defines in VARIANTS:
        so = out / f"lib_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS,
             *(f"-D{d}" for d in defines), "-o", str(so), *srcs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = so
    return libs


def load(so):
    from sherf_tpu_torch.kernels import _cuda
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _cuda._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path = [root] + [p for p in sys.path
                         if os.path.abspath(p or ".") != here]
    import torch
    if not torch.cuda.is_available():
        sys.exit("ray_cluster_probe: needs a CUDA device")
    from sherf_tpu_torch.device_ops import device_work
    from sherf_tpu_torch.kernels import _cuda
    from sherf_tpu_torch.kernels import knn_cluster as kc
    dev = torch.device("cuda")
    libs = build_all()
    ray_o, ray_d, verts, thr = frame_rays(dev)
    cl = kc.make_clusters(verts, kc.C_SIZE, sorted_mean=True)
    plain, visits = kc.ray_body_mask_clustered_plain(
        (ray_o - cl.ctr0).contiguous(), ray_d, cl, thr)
    out = {"n": ray_o.shape[0], "v": verts.shape[0],
           "clusters": cl.cent.shape[0], "pairs": int(visits.sum()),
           "hits": int(plain.sum()), "device": torch.cuda.get_device_name(0)}
    saved = _cuda._LIB
    try:
        for name, _ in VARIANTS:
            _cuda._LIB = load(libs[name])
            call = lambda: kc.ray_body_mask_clustered_cuda(  # noqa: E731
                ray_o, ray_d, cl, thr)
            ops = device_work(call)["ops"]
            r = {"kernel_ms": sum(o["ms"] for k, o in ops.items()
                                  if KERNEL in k),
                 **kc.ray_body_mask_clustered_attrs()}
            if name not in NO_MASK:
                r["equal"] = bool(torch.equal(call(), plain))
            out[name] = r
    finally:
        _cuda._LIB = saved
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["nvidia_smi"] = None
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
