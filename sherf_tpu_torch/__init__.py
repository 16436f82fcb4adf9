"""sherf_tpu_torch — the PyTorch/CUDA port of ``sherf_tpu``.

Same sub-package layout as the JAX package (core smpl geometry kernels
features nerf models train data eval cli compat).  Imports no JAX: the JAX package is the
reference the port is tested against, never a dependency.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""
