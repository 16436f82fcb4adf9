"""The port's visualizer (``sherf_tpu_torch/viz``, ``cli/visualizer.py``)
against the JAX package's, on the CPU.

Both ``VizRenderer``s render from one reference (PyTorch SHERF) pickle
written here (``tests/test_torch_render_clis.reference_state_dict`` at the
visualizer's import defaults: backbone 256, here with narrow channels; the
decoder's density bias raised by 5, as in ``tests/test_torch_e2e.py``, so
that the frames are not empty), at 16x16 rays x 6 samples with 2 cm voxels
(both packages' model builds patched to those widths).  The port reads the
pickle itself; the JAX renderer is handed the variables its own pickle path
builds (``import_sherf_generator``), with the mapping's ``w_avg`` added:
its own path drops it and every render then fails
(``test_jax_visualizer_drops_w_avg_of_a_reference_pickle``).  JAX's pickle
reader is not called: it patches torch process-wide.

Held: ``rgb``, ``depth``, ``normals`` and ``crosssection`` images equal to
JAX's within 1 uint8 level (measured: equal), no ``error``, every overflow
counter 0; the helpers (``_orbit_KRT``, ``_apply_cmap``,
``_layer_to_image``, the normal panel) within 1e-6 of JAX's numpy; the
layer list non-empty, with the heatmaps of every layer both packages list
(flax intermediates named without ``.__call__``) within 1 uint8 level but
for ``HEATMAP_OFF_SHARE`` of a heatmap's pixels; the HTTP server on
127.0.0.1 answering GET page, state and frame (decoded with
``data/png_read.py``) and a POST update, then shutting down.

JAX graphs compiled: the forward, the capturing forward and the
cross-section's ``query_canonical``.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sherf_tpu.cli.common as j_common
from sherf_tpu.compat import legacy_import as j_legacy
from sherf_tpu.geometry.rays import get_rays_np as j_get_rays_np
from sherf_tpu.geometry.rays import near_far_aabb_np as j_near_far_aabb_np
from sherf_tpu.viz import renderer as j_viz
from sherf_tpu_torch.cli import common as t_common
from sherf_tpu_torch.cli import visualizer as t_visualizer_cli
from sherf_tpu_torch.data.png_read import decode_png
from sherf_tpu_torch.viz import renderer as t_viz
from sherf_tpu_torch.viz import server as t_server
from test_torch_render_clis import reference_state_dict, write_reference_pickle

RES, DEPTH = 16, 6
VIZ = dict(channel_base=1024, channel_max=32, voxel_size=0.02)
DENSITY_BIAS = 5.0
CAMERA = dict(yaw=0.7, pitch=0.2, radius=2.5)
# share of a layer heatmap's pixels allowed more than 1 level from JAX's:
# a few sites of the first sparse downsample (down0) differ by ~1-2% of
# the layer's spread (measured: 2.2e-4 of its pixels; none elsewhere)
HEATMAP_OFF_SHARE = 1e-3


@pytest.fixture(scope="module")
def viz(tmp_path_factory):
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    mp = pytest.MonkeyPatch()
    j_build, t_build = j_common.build_model, t_common.build_model
    mp.setattr(j_common, "build_model", lambda cfg, smpl: j_build(
        dataclasses.replace(cfg, **VIZ), smpl))
    mp.setattr(t_viz, "build_model", lambda cfg, smpl, device="cuda": t_build(
        dataclasses.replace(cfg, **VIZ), smpl, device=device))
    sd = reference_state_dict()
    sd["decoder.alpha_linear.bias"] = sd["decoder.alpha_linear.bias"] \
        + DENSITY_BIAS
    ckpt = str(tmp_path_factory.mktemp("viz") / "reference.pkl")
    write_reference_pickle(ckpt, sd)
    params, stats, noise, ema = j_legacy.import_sherf_generator(sd)
    jv = j_viz.VizRenderer()
    # what the JAX renderer's pickle branch builds (viz/renderer.py:161-166)
    jv._variables[(ckpt, (DEPTH, False))] = {
        "params": params, "batch_stats": stats, "noise": noise, "ema": ema}
    tv = t_viz.VizRenderer(device="cpu")
    yield dict(jv=jv, tv=tv, ckpt=ckpt, jax_vars=(params, stats, noise))
    mp.undo()
    torch.set_num_threads(before)


def _args(v, **kw):
    return {"ckpt": v["ckpt"], "resolution": RES, "depth_resolution": DEPTH,
            **CAMERA, **kw}


def _clean(res):
    assert "error" not in res, res["error"]
    assert res["overflow"] and all(n == 0 for n in res["overflow"].values()), \
        res["overflow"]


@pytest.mark.parametrize("render_type",
                         ["rgb", "depth", "normals", "crosssection"])
def test_render_matches_jax(viz, render_type):
    got = viz["tv"].render(render_type=render_type, **_args(viz))
    ref = viz["jv"].render(render_type=render_type, **_args(viz))
    _clean(got)
    assert ref.get("error") is None, ref["error"]
    assert got["image"].shape == ref["image"].shape == (RES, RES, 3)
    assert got["image"].dtype == np.uint8
    assert np.abs(got["image"].astype(int) - ref["image"]).max() <= 1
    if render_type == "rgb":
        # not an empty frame: some pixels are far from the background
        assert (got["image"].astype(int) > 40).any()


def test_jax_visualizer_drops_w_avg_of_a_reference_pickle(viz):
    """A fault of the JAX package, repaired in the port: its pickle branch
    keeps params / batch_stats / noise of ``import_sherf_generator`` and
    drops the mapping's ``w_avg`` (the ``ema`` collection), so the flax
    apply stops on the missing collection and every render with a ``.pkl``
    returns an error.  The port loads the imported ``w_avg``."""
    jv = j_viz.VizRenderer()
    jv._models = viz["jv"]._models
    jv._scenes = viz["jv"]._scenes
    params, stats, noise = viz["jax_vars"]
    jv._variables[(viz["ckpt"], (DEPTH, False))] = {
        "params": params, "batch_stats": stats, "noise": noise}
    res = jv.render(render_type="crosssection", **_args(viz))
    assert "w_avg" in (res.get("error") or "")
    _clean(viz["tv"].render(render_type="crosssection", **_args(viz)))


def test_helpers_match_jax():
    rng = np.random.RandomState(0)
    for yaw, pitch, radius, fov in ((0.3, 0.2, 2.5, 42.0), (2.0, -1.5, 4.0, 30.0),
                                    (1.0, 1.4, 3.0, 90.0)):
        center = rng.randn(3).astype(np.float32)
        for got, ref in zip(
                t_viz._orbit_KRT(96, 128, yaw, pitch, radius, fov, center),
                j_viz._orbit_KRT(96, 128, yaw, pitch, radius, fov, center)):
            assert got.dtype == ref.dtype and np.array_equal(got, ref)
    x = rng.randn(20, 30).astype(np.float32)
    x[3, 4] = np.nan
    np.testing.assert_allclose(t_viz._apply_cmap(x), j_viz._apply_cmap(x),
                               rtol=0, atol=1e-6)
    for shape in ((2, 8, 8, 16), (16, 8, 8), (8, 8, 32), (50,), (1, 3, 9, 9, 4)):
        a = rng.randn(*shape).astype(np.float32)
        assert np.array_equal(t_viz._layer_to_image(a), j_viz._layer_to_image(a))
    # the JAX renderer's normal panel, inline at viz/renderer.py:272-277
    d = rng.uniform(1, 3, (24, 24)).astype(np.float32)
    dy, dx = np.gradient(d)
    n = np.stack([-dx, -dy, np.full_like(d, 1.0 / 24)], -1)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    np.testing.assert_allclose(t_viz._normals_image(d), n * 0.5 + 0.5,
                               rtol=0, atol=1e-6)


def _jax_name(name):
    return name.replace(".__call__", "")


def test_layers_match_jax(viz, record_property):
    got = viz["tv"].render(list_layers=True, **_args(viz))
    ref = viz["jv"].render(list_layers=True, **_args(viz))
    _clean(got)
    assert ref.get("error") is None, ref["error"]
    t_names = [x["name"] for x in got["layers"]]
    j_names = {_jax_name(x["name"]) for x in ref["layers"]}
    common = sorted(set(t_names) & j_names)
    record_property("layers_port_only", sorted(set(t_names) - j_names))
    record_property("layers_jax_only", sorted(j_names - set(t_names)))
    assert len(t_names) > 100 and len(common) > 100
    # one layer through the public path on both sides
    name = "encoder_2d.layer1_0.conv1"
    one = viz["tv"].render(layer_name=name, **_args(viz))
    _clean(one)
    ref_one = viz["jv"].render(layer_name=name + ".__call__", **_args(viz))
    assert np.abs(one["image"].astype(int) - ref_one["image"]).max() <= 1
    assert "no such layer" in viz["tv"].render(
        layer_name="no.such.layer", **_args(viz))["error"]

    # every common layer's heatmap, from one capture on each side
    tv, jv = viz["tv"], viz["jv"]
    model = tv._get_model(viz["ckpt"], DEPTH, False)
    base, wb = tv._get_scene(0, RES, 0.25)
    batch = tv.frame_batch(base, wb, RES, RES, CAMERA["yaw"], CAMERA["pitch"],
                           CAMERA["radius"], 42.0)
    with torch.inference_mode(), t_viz.LayerCapture(model, keep=True) as cap:
        model(batch, tv._get_smpl())
    # the JAX renderer's frame batch (viz/renderer.py:241-251)
    jbase, jwb = jv._get_scene(0, RES, 0.25)
    K, R, T = j_viz._orbit_KRT(RES, RES, CAMERA["yaw"], CAMERA["pitch"],
                               CAMERA["radius"], 42.0, 0.5 * (jwb[0] + jwb[1]))
    ro, rd = j_get_rays_np(RES, RES, K, R, T)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    near, far, mask = j_near_far_aabb_np(jwb, ro, rd)
    jbatch = jbase.replace(
        ray_o=jnp.asarray(ro[None]), ray_d=jnp.asarray(rd[None]),
        near=jnp.asarray(near[None]), far=jnp.asarray(far[None]),
        mask_at_box=jnp.asarray(mask[None]))
    jmodel, _ = jv._get_model(DEPTH, False)
    _, inter = jv._get_render_fn(DEPTH, False, True)(
        jv._get_variables(viz["ckpt"], jmodel, jbase), jbatch)
    j_acts = {_jax_name(k): v for k, v in j_viz._flatten_intermediates(
        jax.device_get(inter))}
    # the renderer's activations are per item in the port (no batch dim):
    # a (M, 1) column draws as the transpose of JAX's (1, M) row
    off, worst = [], 0.0
    for name in common:
        a = t_viz._layer_to_image(cap.kept[name].float().numpy())
        b = j_viz._layer_to_image(np.asarray(j_acts[name], np.float32))
        if a.shape != b.shape and a.shape[1::-1] == b.shape[:2]:
            a = a.transpose(1, 0, 2)
        share = (1.0 if a.shape != b.shape else
                 float((np.abs(a.astype(int) - b) > 1).any(-1).mean()))
        worst = max(worst, share)
        if share > HEATMAP_OFF_SHARE:
            off.append((name, share))
    record_property("layers_compared", len(common))
    record_property("layer_heatmap_worst_share_off", worst)
    assert not off, off


def test_http_server(viz, tmp_path):
    app = t_server.VisualizerApp(ckpt=viz["ckpt"], resolution=RES,
                                 depth_resolution=DEPTH, device="cpu")
    app.renderer = viz["tv"]
    app.capture.out_dir = str(tmp_path)
    server = t_server.serve(app, port=0)          # an ephemeral port
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        page = urllib.request.urlopen(base + "/").read().decode()
        assert "sherf_tpu_torch visualizer" in page
        png = urllib.request.urlopen(base + "/api/frame.png").read()
        img = decode_png(png)
        assert img.shape == (RES, RES, 3)
        ref = viz["tv"].render(**_args(viz, yaw=0.0, pitch=0.0, radius=3.0))
        assert np.array_equal(img, ref["image"])

        req = urllib.request.Request(
            base + "/api/update", method="POST",
            data=json.dumps({"yaw": 0.7, "render_type": "depth"}).encode())
        assert urllib.request.urlopen(req).status == 200
        urllib.request.urlopen(base + "/api/frame.png").read()
        state = json.loads(urllib.request.urlopen(base + "/api/state").read())
        assert state["pose"]["yaw"] == pytest.approx(0.7)
        assert state["rtype"]["render_type"] == "depth"
        assert state["error"] is None
        assert state["overflow"] and not any(state["overflow"].values())
        assert state["perf"]["frames"] == 2

        cap = urllib.request.Request(base + "/api/capture", method="POST")
        path = json.loads(urllib.request.urlopen(cap).read())["path"]
        assert np.array_equal(decode_png(open(path, "rb").read()),
                              app.last_image)
    finally:
        server.shutdown()
        server.server_close()


def test_visualizer_cli_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_visualizer_cli.main(["--port", "0"])
