"""Visualizer render backend (torch counterpart of
``sherf_tpu/viz/renderer.py``; the reference's viz/renderer.py
``Renderer``).

Same contract: a stateful object whose ``render(**args)`` takes the merged
widget state and returns a dict with ``image`` (uint8 HWC),
``render_time``, the frame's budget-overflow counters (``overflow``) and,
on failure, ``error`` (a traceback string: ``render`` never raises).

- A generator is built and its weights loaded once per (checkpoint,
  samples per ray, white background).  ``ckpt`` is read by content: a
  dict with ``model`` / ``ema`` / ``step`` is a port snapshot
  (``train/checkpoint.py``; its EMA weights are rendered), anything else
  a reference pickle (``compat/legacy_import.load_reference_pickle``,
  imported with ``import_sherf_generator``'s defaults and loaded with
  ``strict=True``, so a model of other widths fails instead of loading
  part of it).  Without a checkpoint the weights are drawn from seed 0.
- Layer capture: forward hooks on every submodule record its outputs (the
  JAX package uses flax ``capture_intermediates``).  A layer's name is its
  dotted module path, ``[i]`` after it when the module ran more than once
  in the frame, and ``.key`` / ``.i`` for an entry of a dict or tuple
  output; outputs with two or more dimensions are listed.  4-D outputs
  are listed and drawn channels-last, as the JAX package has them (the
  port's convolutions run channels-first; ``ResNet18``'s own output is
  channels-last already).
- Scalar outputs (depth / acc / cross-section / layers) are colour-mapped
  on the host with an embedded viridis ramp.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from sherf_tpu_torch.cli.common import (build_model, generator_weights,
                                        render_cli_config, resolve_smpl)
from sherf_tpu_torch.compat.legacy_import import (import_sherf_generator,
                                                  load_reference_pickle)
from sherf_tpu_torch.core.diag import overflow_report
from sherf_tpu_torch.data.synthetic import make_synthetic_batch
from sherf_tpu_torch.features.resnet import ResNet18
from sherf_tpu_torch.geometry.rays import get_rays_np, near_far_aabb_np

# 11-anchor viridis ramp (matplotlib values, embedded so the visualizer has
# no plotting dependency); linearly interpolated in _apply_cmap.
_VIRIDIS = np.array([
    [0.267004, 0.004874, 0.329415], [0.282623, 0.140926, 0.457517],
    [0.253935, 0.265254, 0.529983], [0.206756, 0.371758, 0.553117],
    [0.163625, 0.471133, 0.558148], [0.127568, 0.566949, 0.550556],
    [0.134692, 0.658636, 0.517649], [0.266941, 0.748751, 0.440573],
    [0.477504, 0.821444, 0.318195], [0.741388, 0.873449, 0.149561],
    [0.993248, 0.906157, 0.143936]], np.float32)


def _apply_cmap(x: np.ndarray) -> np.ndarray:
    """Normalize a scalar field to [0,1] and map through viridis -> float rgb."""
    x = np.asarray(x, np.float32)
    lo, hi = float(np.nanmin(x)), float(np.nanmax(x))
    t = (x - lo) / max(hi - lo, 1e-8)
    idx = t * (len(_VIRIDIS) - 1)
    i0 = np.clip(idx.astype(np.int32), 0, len(_VIRIDIS) - 2)
    frac = (idx - i0)[..., None]
    return _VIRIDIS[i0] * (1 - frac) + _VIRIDIS[i0 + 1] * frac


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _orbit_KRT(H: int, W: int, yaw: float, pitch: float, radius: float,
               fov: float, center: np.ndarray):
    """World -> camera K / R / T of a camera orbiting ``center`` (the
    widget-driven pose)."""
    pitch = float(np.clip(pitch, -1.4, 1.4))
    cam = center + radius * np.array([
        np.cos(pitch) * np.sin(yaw), np.sin(pitch), np.cos(pitch) * np.cos(yaw),
    ], np.float32)
    fwd = center - cam
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0, 1, 0], np.float32)
    right = np.cross(fwd, up)
    nr = np.linalg.norm(right)
    if nr < 1e-6:  # looking straight up/down
        right = np.array([1, 0, 0], np.float32)
    else:
        right = right / nr
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd]).astype(np.float32)
    T = (-R @ cam).reshape(3, 1).astype(np.float32)
    f = 0.5 * max(H, W) / np.tan(np.radians(fov) / 2.0)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return K, R, T


def _normals_image(depth: np.ndarray) -> np.ndarray:
    """Screen-space normals of a depth buffer (H, W) as float rgb in [0, 1]
    (no second gradient pass)."""
    H, W = depth.shape
    d = np.asarray(depth, np.float32)
    dy, dx = np.gradient(d)
    n = np.stack([-dx, -dy, np.full_like(d, 1.0 / max(H, W))], -1)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    return n * 0.5 + 0.5


def sample_cross_section(model, batch, smpl, resolution: int = 64,
                         w: float = 1.2, axis: int = 0, offset: float = 0.0):
    """Density on an axis-aligned plane through item 0's canonical volume
    (the reference's crosssection_utils ``sample_cross_section``; the
    slice axis and offset are selectable) through ``query_canonical``.
    Returns ((res, res) float32 sigma, its overflow report)."""
    center = batch.t_bounds[0].cpu().numpy().mean(0)
    a = np.linspace(w / 2, -w / 2, resolution, dtype=np.float32)
    b = np.linspace(-w / 2, w / 2, resolution, dtype=np.float32)
    A, B = np.meshgrid(a, b, indexing="ij")
    cols = [A.reshape(-1), B.reshape(-1)]
    cols.insert(axis, np.full(resolution * resolution, offset, np.float32))
    pts = torch.from_numpy(np.stack(cols, -1) + center)
    with torch.inference_mode():
        out, diag = model.query_canonical(batch, smpl,
                                          pts[None].to(batch.t_bounds.device))
    sigma = out["sigma"][0, :, 0].float().cpu().numpy()
    return sigma.reshape(resolution, resolution), overflow_report(diag)


def _port_snapshot(path: str) -> bool:
    """Whether ``path`` holds a port snapshot (``train/checkpoint.py``)."""
    try:
        snap = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        return False
    return isinstance(snap, dict) and {"model", "ema", "step"} <= set(snap)


def load_generator_weights(model, ckpt: Optional[str]):
    """Load ``ckpt`` into ``model`` (see the module docstring)."""
    if not ckpt or _port_snapshot(ckpt):
        return generator_weights(model, ckpt)
    nets = load_reference_pickle(ckpt)
    sd = nets.get("G_ema", nets.get("G"))
    if sd is None:
        raise KeyError(f"{ckpt}: no 'G_ema' or 'G' state_dict among "
                       f"{sorted(nets)}")
    model.load_state_dict(import_sherf_generator(sd), strict=True)
    return model


class LayerCapture:
    """Within ``with``: forward hooks on every submodule of ``model`` list
    each output with two or more dimensions (``layers``: name, shape,
    dtype) and keep the tensor of the name ``keep`` (every tensor with
    ``keep=True``) in ``kept``.  Only the tensors of the module ``keep``
    names outlive their call."""

    def __init__(self, model: torch.nn.Module, keep=None):
        self.model, self.keep = model, keep
        self.layers: list = []
        self.kept: Dict[str, torch.Tensor] = {}
        self._calls: Dict[str, list] = {}
        self._handles = []

    def _hook(self, path):
        def hook(mod, inputs, output):
            keep = self.keep is True or (isinstance(self.keep, str)
                                         and self.keep.startswith(path))
            self._calls.setdefault(path, []).append(
                [(suffix, t if keep else None, list(t.shape),
                  str(t.dtype).replace("torch.", ""))
                 for suffix, t in _flatten("", output,
                                           isinstance(mod, ResNet18))])
        return hook

    def __enter__(self):
        for name, mod in self.model.named_modules():
            if name:
                self._handles.append(mod.register_forward_hook(
                    self._hook(name)))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        for path in sorted(self._calls):
            calls = self._calls[path]
            for i, outs in enumerate(calls):
                call = path if len(calls) == 1 else f"{path}[{i}]"
                for suffix, t, shape, dtype in outs:
                    name = call + suffix
                    self.layers.append(dict(name=name, shape=shape,
                                            dtype=dtype))
                    if t is not None and (self.keep is True
                                          or name == self.keep):
                        self.kept[name] = t
        self._calls.clear()


def _flatten(name, out, channels_last):
    """(name suffix, tensor) of each output with two or more dimensions;
    4-D ones channels-last."""
    if isinstance(out, torch.Tensor):
        if out.dim() == 4 and not channels_last:
            out = out.permute(0, 2, 3, 1)
        if out.dim() >= 2:
            yield name, out
    elif isinstance(out, dict):
        for k in sorted(out):
            yield from _flatten(f"{name}.{k}", out[k], channels_last)
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            yield from _flatten(f"{name}.{i}", v, channels_last)


def _layer_to_image(x: np.ndarray) -> np.ndarray:
    """Mean-over-channels heatmap of an intermediate activation (the channel
    axis taken as the smaller of the first and last)."""
    x = np.asarray(x, np.float32)
    while x.ndim > 3:
        x = x[0]
    if x.ndim == 3:  # HWC or CHW -> HW mean
        x = x.mean(axis=-1 if x.shape[-1] <= x.shape[0] else 0)
    if x.ndim == 1:
        n = int(np.ceil(np.sqrt(x.size)))
        x = np.pad(x, (0, n * n - x.size)).reshape(n, n)
    return _to_uint8(_apply_cmap(x))


class VizRenderer:
    """Stateful render backend; one instance per visualizer session."""

    def __init__(self, smpl_path: Optional[str] = None, device="cuda"):
        self._smpl_path = smpl_path
        self.device = torch.device(device)
        self._smpl = None
        self._models: Dict[tuple, torch.nn.Module] = {}  # (ckpt, D, wb)
        self._scenes: Dict[tuple, tuple] = {}            # -> (batch, bounds)

    # -- caches --------------------------------------------------------
    def _get_smpl(self):
        if self._smpl is None:
            self._smpl = resolve_smpl(self._smpl_path, self.device)
        return self._smpl

    def _get_model(self, ckpt: Optional[str], depth_resolution: int,
                   white_back: bool):
        key = (ckpt or "", int(depth_resolution), bool(white_back))
        if key not in self._models:
            model, _, _ = build_model(
                render_cli_config(int(depth_resolution), bool(white_back)),
                self._get_smpl(), device=self.device)
            self._models[key] = load_generator_weights(model, ckpt).eval()
        return self._models[key]

    def _get_scene(self, seed: int, resolution: int, pose_scale: float):
        """Synthetic subject + base batch (the visualizer's 'latent': the
        synthetic-body seed)."""
        key = (int(seed), int(resolution), float(pose_scale))
        if key not in self._scenes:
            batch = make_synthetic_batch(self._get_smpl(), batch_size=1,
                                         H=resolution, W=resolution,
                                         seed=seed, pose_scale=pose_scale,
                                         device=self.device)
            verts = batch.vertices[0].cpu().numpy()
            wb = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
            self._scenes[key] = (batch, wb)
        return self._scenes[key]

    # -- main entry ----------------------------------------------------
    def render(self, **args) -> dict:
        """Render one frame from merged widget state.  Never raises: errors
        come back in res['error']."""
        res: dict = {}
        t0 = time.perf_counter()
        try:
            self._render_impl(res, **args)
        except Exception:
            res["error"] = traceback.format_exc()
        res["render_time"] = time.perf_counter() - t0
        return res

    def frame_batch(self, base, wb, H, W, yaw, pitch, radius, fov):
        """``base`` seen from the orbit camera: rays, near / far and the box
        mask of the posed body's box."""
        center = 0.5 * (wb[0] + wb[1])
        K, R, T = _orbit_KRT(H, W, yaw, pitch, radius, fov, center)
        ro, rd = get_rays_np(H, W, K, R, T)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        near, far, mask = near_far_aabb_np(wb, ro, rd)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x))[None].to(
            self.device)
        return dataclasses.replace(base, ray_o=t(ro), ray_d=t(rd),
                                   near=t(near), far=t(far),
                                   mask_at_box=t(mask))

    def _render_impl(self, res, ckpt: Optional[str] = None,
                     resolution: int = 128, depth_resolution: int = 24,
                     yaw: float = 0.0, pitch: float = 0.0,
                     radius: float = 3.0, fov: float = 42.0,
                     seed: int = 0, pose_scale: float = 0.25,
                     render_type: str = "rgb", white_back: bool = False,
                     layer_name: Optional[str] = None,
                     list_layers: bool = False,
                     crosssection_axis: int = 0,
                     crosssection_width: float = 1.2, **_unused):
        H = W = int(resolution)
        model = self._get_model(ckpt, depth_resolution, white_back)
        base, wb = self._get_scene(seed, H, pose_scale)

        if render_type == "crosssection":
            sigma, res["overflow"] = sample_cross_section(
                model, base, self._get_smpl(), resolution=H,
                w=crosssection_width, axis=int(crosssection_axis))
            res["image"] = _to_uint8(_apply_cmap(sigma))
            return

        batch = self.frame_batch(base, wb, H, W, yaw, pitch, radius, fov)
        capture = bool(layer_name or list_layers)
        with torch.inference_mode():
            if capture:
                with LayerCapture(model, keep=layer_name) as cap:
                    out, diag = model(batch, self._get_smpl())
            else:
                out, diag = model(batch, self._get_smpl())
        res["overflow"] = overflow_report(diag)

        if capture:
            res["layers"] = cap.layers
            if layer_name:
                sel = cap.kept.get(layer_name)
                if sel is None:
                    res["error"] = f"no such layer: {layer_name}"
                    return
                res["image"] = _layer_to_image(sel.float().cpu().numpy())
                return

        img = out["image_raw"][0].float().cpu().numpy() / 2.0 + 0.5
        if render_type == "depth":
            img = _apply_cmap(out["image_depth"][0].float().cpu().numpy())
        elif render_type == "acc":
            img = _apply_cmap(out["weights_image"][0].float().cpu().numpy())
        elif render_type == "normals":
            img = _normals_image(out["image_depth"][0].float().cpu().numpy())
        res["image"] = _to_uint8(img)
