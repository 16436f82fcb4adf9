"""Headless widget state for the visualizer (torch counterpart of
``sherf_tpu/viz/widgets.py``): the logic layer of the reference's imgui
widgets (viz/*_widget.py), decoupled from any GUI toolkit.

Each widget owns a slice of the render-arg dict: the app merges every
widget's ``args()`` into one dict and hands it to ``VizRenderer.render``
(the reference does the same through ``viz_args``, e.g.
viz/pose_widget.py sets yaw/pitch, viz/render_type_widget.py sets
render_type).  ``update()`` applies a partial state change (from the web UI
or tests) with clamping/validation.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from sherf_tpu_torch.eval.png import write_png


class Widget:
    """Base: a named bag of state exposed as render args."""

    def args(self) -> Dict:
        return {}

    def state(self) -> Dict:
        return dict(self.args())

    def update(self, changes: Dict) -> None:
        for k, v in changes.items():
            if hasattr(self, k):
                setattr(self, k, v)


class PoseWidget(Widget):
    """Camera orbit yaw/pitch (reference viz/pose_widget.py drag state)."""

    def __init__(self, yaw: float = 0.0, pitch: float = 0.0):
        self.yaw = float(yaw)
        self.pitch = float(pitch)

    def drag(self, dx: float, dy: float, speed: float = 0.01):
        self.yaw += dx * speed
        self.pitch = float(np.clip(self.pitch + dy * speed, -1.4, 1.4))

    def update(self, changes):
        super().update(changes)
        self.pitch = float(np.clip(self.pitch, -1.4, 1.4))

    def args(self):
        return dict(yaw=self.yaw, pitch=self.pitch)


class ZoomWidget(Widget):
    """Orbit radius + field of view (reference viz/zoom_widget.py)."""

    def __init__(self, radius: float = 3.0, fov: float = 42.0):
        self.radius = float(radius)
        self.fov = float(fov)

    def update(self, changes):
        super().update(changes)
        self.radius = float(np.clip(self.radius, 0.5, 20.0))
        self.fov = float(np.clip(self.fov, 5.0, 120.0))

    def args(self):
        return dict(radius=self.radius, fov=self.fov)


class ConditioningPoseWidget(Widget):
    """Subject selection: synthetic-body seed + pose magnitude (the
    SHERF-conditioned stand-in for viz/conditioning_pose_widget.py +
    viz/latent_widget.py — SHERF's 'latent' is the observation image)."""

    def __init__(self, seed: int = 0, pose_scale: float = 0.25):
        self.seed = int(seed)
        self.pose_scale = float(pose_scale)

    def update(self, changes):
        super().update(changes)
        self.seed = int(self.seed)
        self.pose_scale = float(np.clip(self.pose_scale, 0.0, 1.0))

    def args(self):
        return dict(seed=self.seed, pose_scale=self.pose_scale)


class RenderTypeWidget(Widget):
    """rgb / depth / acc / normals / crosssection
    (reference viz/render_type_widget.py)."""

    TYPES = ("rgb", "depth", "acc", "normals", "crosssection")

    def __init__(self, render_type: str = "rgb"):
        self.render_type = render_type

    def update(self, changes):
        super().update(changes)
        if self.render_type not in self.TYPES:
            self.render_type = "rgb"

    def args(self):
        return dict(render_type=self.render_type)


class RenderDepthSampleWidget(Widget):
    """Samples/ray + output resolution
    (reference viz/render_depth_sample_widget.py)."""

    def __init__(self, depth_resolution: int = 24, resolution: int = 128):
        self.depth_resolution = int(depth_resolution)
        self.resolution = int(resolution)

    def update(self, changes):
        super().update(changes)
        self.depth_resolution = int(np.clip(self.depth_resolution, 4, 128))
        self.resolution = int(np.clip(self.resolution, 16, 1024))

    def args(self):
        return dict(depth_resolution=self.depth_resolution,
                    resolution=self.resolution)


class TruncNoiseWidget(Widget):
    """Truncation psi + white background (reference
    viz/trunc_noise_widget.py; SHERF's mapping ignores trunc but the flag is
    part of the API surface, triplane.py:73-79)."""

    def __init__(self, truncation_psi: float = 1.0, white_back: bool = False):
        self.truncation_psi = float(truncation_psi)
        self.white_back = bool(white_back)

    def update(self, changes):
        super().update(changes)
        self.white_back = bool(self.white_back)

    def args(self):
        return dict(truncation_psi=self.truncation_psi,
                    white_back=self.white_back)


class PickleWidget(Widget):
    """Checkpoint selection + recents (reference viz/pickle_widget.py).
    Accepts port snapshots and reference pickles (``VizRenderer`` tells
    them apart by content)."""

    def __init__(self, ckpt: Optional[str] = None):
        self.ckpt = ckpt
        self.recents: List[str] = [ckpt] if ckpt else []

    def update(self, changes):
        if "ckpt" in changes:
            ckpt = changes["ckpt"] or None
            self.ckpt = ckpt
            if ckpt and ckpt not in self.recents:
                self.recents.insert(0, ckpt)
                del self.recents[8:]

    def state(self):
        return dict(ckpt=self.ckpt, recents=list(self.recents))

    def args(self):
        return dict(ckpt=self.ckpt)


class LayerWidget(Widget):
    """Intermediate-activation browser (reference viz/layer_widget.py):
    request the layer list, then select one by dotted name."""

    def __init__(self):
        self.layer_name: Optional[str] = None
        self.list_layers = False
        self.layers: List[Dict] = []  # filled from render results

    def update(self, changes):
        if "layer_name" in changes:
            self.layer_name = changes["layer_name"] or None
        if "list_layers" in changes:
            self.list_layers = bool(changes["list_layers"])

    def observe(self, result: Dict):
        if "layers" in result:
            self.layers = result["layers"]

    def state(self):
        return dict(layer_name=self.layer_name, list_layers=self.list_layers,
                    layers=self.layers)

    def args(self):
        return dict(layer_name=self.layer_name, list_layers=self.list_layers)


class PerformanceWidget(Widget):
    """Render-time EMA + fps (reference viz/performance_widget.py)."""

    def __init__(self, ema_beta: float = 0.8):
        self.ema_beta = float(ema_beta)
        self.render_time_ema: Optional[float] = None
        self.last_render_time: Optional[float] = None
        self.frames = 0

    def observe(self, result: Dict):
        t = result.get("render_time")
        if t is None:
            return
        self.frames += 1
        self.last_render_time = float(t)
        if self.render_time_ema is None:
            self.render_time_ema = float(t)
        else:
            self.render_time_ema = (self.ema_beta * self.render_time_ema
                                    + (1 - self.ema_beta) * float(t))

    def state(self):
        fps = (1.0 / self.render_time_ema
               if self.render_time_ema else None)
        return dict(frames=self.frames, last_render_time=self.last_render_time,
                    render_time_ema=self.render_time_ema, fps=fps)


class CaptureWidget(Widget):
    """Save the current frame to disk (reference viz/capture_widget.py)."""

    def __init__(self, out_dir: str = "viz_captures"):
        self.out_dir = out_dir

    def save(self, image: np.ndarray) -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir,
                            time.strftime("capture_%Y%m%d_%H%M%S.png"))
        write_png(path, image)
        return path

    def state(self):
        return dict(out_dir=self.out_dir)
