"""Web front-end for the visualizer (torch counterpart of
``sherf_tpu/viz/server.py``), in place of the reference's desktop shell
(gui_utils/glfw_window.py + gui_utils/imgui_window.py + GL texture upload).

GPU servers are headless, so instead of GLFW/OpenGL the UI is a single
embedded HTML page served by the standard library's ThreadingHTTPServer;
use ``ssh -L 8123:localhost:8123 <gpu-host>`` and open
http://localhost:8123.

Endpoints:
- ``GET  /``            the UI page
- ``GET  /api/state``   widget state, perf, last error and overflow (JSON)
- ``POST /api/update``  partial widget-state update (JSON)
- ``GET  /api/frame.png`` render with current state, return PNG
- ``POST /api/capture`` save the last frame (CaptureWidget)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from sherf_tpu_torch.eval.png import png_bytes
from sherf_tpu_torch.viz.renderer import VizRenderer
from sherf_tpu_torch.viz.widgets import (CaptureWidget, ConditioningPoseWidget,
                                   LayerWidget, PerformanceWidget,
                                   PickleWidget, PoseWidget,
                                   RenderDepthSampleWidget, RenderTypeWidget,
                                   TruncNoiseWidget, ZoomWidget)


class VisualizerApp:
    """Widget set + renderer; thread-safe render entry.

    The reference's AsyncRenderer runs the network in a side process
    (viz/renderer.py async machinery); here one lock serializes renders:
    frames are pulled, not pushed.
    """

    def __init__(self, smpl_path: Optional[str] = None,
                 ckpt: Optional[str] = None, resolution: int = 128,
                 depth_resolution: int = 24, device="cuda"):
        self.renderer = VizRenderer(smpl_path=smpl_path, device=device)
        self.pose = PoseWidget()
        self.zoom = ZoomWidget()
        self.cond = ConditioningPoseWidget()
        self.rtype = RenderTypeWidget()
        self.depth = RenderDepthSampleWidget(depth_resolution=depth_resolution,
                                             resolution=resolution)
        self.trunc = TruncNoiseWidget()
        self.pickle = PickleWidget(ckpt)
        self.layers = LayerWidget()
        self.perf = PerformanceWidget()
        self.capture = CaptureWidget()
        self._widgets = dict(pose=self.pose, zoom=self.zoom, cond=self.cond,
                             rtype=self.rtype, depth=self.depth,
                             trunc=self.trunc, pickle=self.pickle,
                             layers=self.layers, perf=self.perf,
                             capture=self.capture)
        self._lock = threading.Lock()
        self.last_error: Optional[str] = None
        self.last_overflow: Optional[Dict] = None
        self.last_image: Optional[np.ndarray] = None

    def render_args(self) -> Dict:
        args: Dict = {}
        for w in self._widgets.values():
            args.update(w.args())
        return args

    def render_frame(self) -> Optional[np.ndarray]:
        with self._lock:
            res = self.renderer.render(**self.render_args())
            self.perf.observe(res)
            self.layers.observe(res)
            self.last_error = res.get("error")
            self.last_overflow = res.get("overflow")
            img = res.get("image")
            if img is not None:
                self.last_image = img
            return img

    def update(self, changes: Dict) -> None:
        with self._lock:
            for w in self._widgets.values():
                w.update(changes)

    def state(self) -> Dict:
        st = {name: w.state() for name, w in self._widgets.items()}
        st["error"] = self.last_error
        st["overflow"] = self.last_overflow
        return st


_PAGE = """<!doctype html><html><head><meta charset=utf-8>
<title>sherf_tpu_torch visualizer</title><style>
body{font-family:system-ui;margin:0;display:flex;background:#15181e;color:#cdd3dd}
#panel{width:300px;padding:14px;background:#1c2128;min-height:100vh}
#panel label{display:block;margin:10px 0 2px;font-size:12px;color:#8b95a5}
#panel input,#panel select{width:100%;box-sizing:border-box;background:#12151a;
 color:#cdd3dd;border:1px solid #333a45;border-radius:4px;padding:4px}
#view{flex:1;display:flex;align-items:center;justify-content:center}
#frame{image-rendering:pixelated;max-width:90%;max-height:90vh;cursor:grab}
#perf,#err{font-size:12px;margin-top:10px;white-space:pre-wrap}
#err{color:#ff7b72}h3{margin:4px 0 8px;font-size:14px}</style></head><body>
<div id=panel><h3>sherf_tpu_torch visualizer</h3>
<label>checkpoint (port snapshot / reference .pkl; empty = random init)</label>
<input id=ckpt placeholder="runs/.../snapshot-000000.pt">
<label>render type</label><select id=render_type>
<option>rgb</option><option>depth</option><option>acc</option>
<option>normals</option><option>crosssection</option></select>
<label>resolution</label><input id=resolution type=number value=128>
<label>samples/ray</label><input id=depth_resolution type=number value=24>
<label>subject seed</label><input id=seed type=number value=0>
<label>pose scale</label><input id=pose_scale type=number step=0.05 value=0.25>
<label>radius</label><input id=radius type=number step=0.1 value=3.0>
<label>fov°</label><input id=fov type=number step=1 value=42>
<label>layer (blank = final image)</label><input id=layer_name>
<label><input id=list_layers type=checkbox style="width:auto"> list layers</label>
<button id=apply style="margin-top:10px;width:100%">apply</button>
<button id=snap style="margin-top:6px;width:100%">save capture</button>
<div id=perf></div><div id=err></div><pre id=layerlist
 style="font-size:10px;max-height:30vh;overflow:auto"></pre></div>
<div id=view><img id=frame src="/api/frame.png"></div>
<script>
const $=id=>document.getElementById(id);
let drag=null;
async function refresh(){
  $("frame").src="/api/frame.png?"+Date.now();
  const s=await (await fetch("/api/state")).json();
  const p=s.perf; $("perf").textContent=p.render_time_ema?
    ("render "+(1e3*p.render_time_ema).toFixed(0)+" ms  ("+
     p.fps.toFixed(2)+" fps, "+p.frames+" frames)"):"";
  $("err").textContent=s.error||"";
  $("layerlist").textContent=(s.layers.layers||[])
    .map(l=>l.name+"  "+JSON.stringify(l.shape)).join("\\n");
}
async function send(ch){await fetch("/api/update",{method:"POST",
  body:JSON.stringify(ch)});await refresh();}
$("apply").onclick=()=>send({
  ckpt:$("ckpt").value, render_type:$("render_type").value,
  resolution:+$("resolution").value,
  depth_resolution:+$("depth_resolution").value,
  seed:+$("seed").value, pose_scale:+$("pose_scale").value,
  radius:+$("radius").value, fov:+$("fov").value,
  layer_name:$("layer_name").value, list_layers:$("list_layers").checked});
$("snap").onclick=()=>fetch("/api/capture",{method:"POST"});
$("frame").onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault()};
window.onmouseup=async e=>{if(!drag)return;
  const s=await (await fetch("/api/state")).json();
  await send({yaw:s.pose.yaw+(e.clientX-drag[0])*0.01,
              pitch:s.pose.pitch+(e.clientY-drag[1])*0.01});drag=null;};
window.onwheel=async e=>{const s=await (await fetch("/api/state")).json();
  await send({radius:s.zoom.radius*(e.deltaY>0?1.1:0.9)});};
refresh();
</script></body></html>"""


_PLACEHOLDER = np.full((32, 32, 3), 40, np.uint8)


def make_handler(app: VisualizerApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._reply(200, _PAGE.encode(), "text/html")
            elif path == "/api/state":
                self._reply(200, json.dumps(app.state()).encode(),
                            "application/json")
            elif path == "/api/frame.png":
                img = app.render_frame()
                if img is None:
                    img = app.last_image if app.last_image is not None \
                        else _PLACEHOLDER
                self._reply(200, png_bytes(img), "image/png")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else b"{}"
            if self.path == "/api/update":
                try:
                    app.update(json.loads(body or b"{}"))
                    self._reply(200, b"{}", "application/json")
                except Exception as e:  # bad json etc.
                    self._reply(400, str(e).encode(), "text/plain")
            elif self.path == "/api/capture":
                if app.last_image is None:
                    self._reply(409, b"no frame yet", "text/plain")
                else:
                    path = app.capture.save(app.last_image)
                    self._reply(200, json.dumps({"path": path}).encode(),
                                "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

    return Handler


def serve(app: VisualizerApp, port: int = 8123, host: str = "127.0.0.1"
          ) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call .shutdown() to stop)."""
    server = ThreadingHTTPServer((host, port), make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    server._viz_thread = thread  # keep a handle for clean shutdown
    return server
