"""flax variables (as nested dicts of numpy arrays) -> a torch ``state_dict``
for the port's modules.

The port's modules carry the flax module names, so a parameter's key is its
flax path joined with '.', with the leaf renamed and re-laid-out:

  params  Dense  ``kernel`` (in, out)         -> ``weight`` (out, in)
          Conv   ``kernel`` (kh, kw, I, O)    -> ``weight`` (O, I, kh, kw)
          StyleGAN2 conv ``weight`` HWIO      -> ``weight`` OIHW
          StyleGAN2 FC ``weight`` (out, in)   -> unchanged
          StyleGAN2 ``const`` (H, W, C)       -> (C, H, W)
          BatchNorm / LayerNorm ``scale``     -> ``weight``
  batch_stats ``mean`` / ``var``              -> ``running_mean`` / ``running_var``
  noise / ema / buffers (``noise_const``, ``w_avg``, StyleGAN3's
  ``transform``, ``magnitude_ema``) and sparse-conv weights
  (3, 3, 3, Ci, Co)                           -> unchanged
  a tuple leaf ``a_b`` of two arrays          -> ``a`` and ``b``
  (StyleGAN3's ``freqs_phases``)

Takes numpy arrays only (call ``jax.device_get`` first), so it imports no
JAX.  Either the full variables dict ({"params": ..., "batch_stats": ...})
or a bare params tree is accepted.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_COLLECTIONS = ("params", "batch_stats", "noise", "ema", "buffers")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        elif isinstance(v, (tuple, list)):
            parts = str(k).split("_")
            if len(parts) != len(v):
                raise ValueError(f"tuple leaf {k!r} of {len(v)} arrays: its "
                                 f"name does not name each of them")
            for part, leaf in zip(parts, v):
                yield prefix + (part,), np.asarray(leaf)
        else:
            yield prefix + (str(k),), np.asarray(v)


def _convert(collection: str, path, arr: np.ndarray):
    leaf = path[-1]
    mods = path[:-1]
    if collection == "batch_stats":
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
        return mods + (name,), arr
    if collection != "params":
        return path, arr
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        return mods + ("weight",), arr
    if leaf == "weight" and arr.ndim == 4:
        return path, arr.transpose(3, 2, 0, 1)
    if leaf == "const" and arr.ndim == 3:
        return path, arr.transpose(2, 0, 1)
    if leaf == "scale":
        return mods + ("weight",), arr
    return path, arr


def from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables -> ``state_dict`` (float32 tensors, contiguous)."""
    if not any(c in variables for c in _COLLECTIONS):
        variables = {"params": variables}
    out: Dict[str, torch.Tensor] = {}
    for coll in _COLLECTIONS:
        for path, arr in _flatten(variables.get(coll, {})):
            key_path, arr = _convert(coll, path, arr)
            key = ".".join(key_path)
            if key in out:
                raise ValueError(f"duplicate state_dict key {key!r}")
            out[key] = torch.from_numpy(np.array(arr, dtype=arr.dtype, order="C"))
    return out
