"""Interactive visualizer entry point (torch counterpart of
``sherf_tpu/cli/visualizer.py``): serves the web UI of
``sherf_tpu_torch/viz/server.py``.

    python -m sherf_tpu_torch.cli.visualizer --port 8123 \\
        [--ckpt snapshot-NNNNNN.pt | --ckpt reference.pkl]
    (add --device cpu to render on the CPU)

then ``ssh -L 8123:localhost:8123 <gpu-host>`` and open
http://localhost:8123.  ``--ckpt`` is a port snapshot or a reference
pickle, told apart by content (``viz/renderer.load_generator_weights``).
"""

from __future__ import annotations

import argparse
import time

from sherf_tpu_torch.cli.common import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8123)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--ckpt", default=None,
                   help="a port snapshot or a reference .pkl")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--smpl_model", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when 'cpu' is passed")
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    from sherf_tpu_torch.viz.server import VisualizerApp, serve

    app = VisualizerApp(smpl_path=a.smpl_model, ckpt=a.ckpt,
                        resolution=a.size, depth_resolution=a.depth,
                        device=device)
    server = serve(app, port=a.port, host=a.host)
    print(f"visualizer at http://{a.host}:{server.server_address[1]}  "
          f"(ctrl-c to stop)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
