"""Interactive visualizer (torch counterpart of ``sherf_tpu/viz``; the
reference's viz/* + gui_utils/*).

The reference ships an EG3D imgui / OpenGL desktop browser.  A GPU server
has no display, so the port keeps its architecture (a stateful render
backend driven by widget state dicts) and serves it over HTTP to any
browser:

- ``viz.renderer.VizRenderer``: the render state machine (model and
  checkpoint cache, render-arg dict in, image + perf + overflow + error
  dict out, layer capture through forward hooks).
- ``viz.widgets``: headless widget state (camera orbit, zoom, conditioning
  pose, render type, depth samples, truncation / noise, pickle, layer list,
  performance, capture).
- ``viz.server``: the standard library's HTTP server and a single-page UI.
- CLI: ``python -m sherf_tpu_torch.cli.visualizer``.
"""

from sherf_tpu_torch.viz.renderer import VizRenderer, sample_cross_section
from sherf_tpu_torch.viz.widgets import (CaptureWidget, ConditioningPoseWidget,
                                         LayerWidget, PerformanceWidget,
                                         PickleWidget, PoseWidget,
                                         RenderDepthSampleWidget,
                                         RenderTypeWidget, TruncNoiseWidget,
                                         ZoomWidget)

__all__ = [
    "VizRenderer", "sample_cross_section",
    "PoseWidget", "ZoomWidget", "ConditioningPoseWidget", "RenderTypeWidget",
    "RenderDepthSampleWidget", "TruncNoiseWidget", "PickleWidget",
    "LayerWidget", "PerformanceWidget", "CaptureWidget",
]
