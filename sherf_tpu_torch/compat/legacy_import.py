"""Reference-checkpoint import: a reference (PyTorch SHERF) ``state_dict``
-> a ``state_dict`` of the port's ``SHERFGenerator`` (torch counterpart of
``sherf_tpu/compat/legacy_import.py``).

The key mapping is the JAX package's, in numpy: each ``import_*`` function
emits the flax-layout tree of the JAX module it names (params /
batch_stats / noise / ema), and ``import_sherf_generator`` hands that tree
to ``compat.flax_bridge.from_flax``, which lays it out for the port's
modules (they carry the flax names).  Conventions translated on the way to
the flax tree:

  * torch Linear weight (out, in)          -> Dense ``kernel`` (in, out)
  * torch Conv2d weight (out, in, kh, kw)  -> HWIO (kh, kw, in, out)
  * torch BatchNorm (weight, bias, running_mean, running_var)
                                           -> (scale, bias) + batch_stats
  * spconv SubMConv3d weight               -> (3, 3, 3, in, out)

The import does not know the model's widths: the caller's
``load_state_dict(strict=True)`` is what fails on a mismatch.
"""

from __future__ import annotations

import math
import pickle
from typing import Dict, Mapping

import numpy as np

from sherf_tpu_torch.compat.flax_bridge import from_flax


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _conv_w(x) -> np.ndarray:
    """(out, in, kh, kw) -> (kh, kw, in, out)."""
    return np.transpose(_np(x), (2, 3, 1, 0))


def load_reference_pickle(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """A pickle of the reference's networks -> {'G_ema': state_dict, ...}
    as numpy mappings.  Each value of the pickled dict either has a
    ``state_dict()`` (a pickled ``nn.Module``) or is itself a mapping of
    arrays; other values are skipped.

    The released ``SHERF_*.pkl`` snapshots are the reference's PERSISTENCE
    pickles (its torch_utils/persistence.py): unpickling them imports the
    reference's own modules (``torch_utils``, ``training.*``, ``dnnlib``)
    and exec's their embedded sources.  The port does not carry those
    sources, so such a pickle raises ``ModuleNotFoundError`` naming the
    missing module.
    """
    with open(path, "rb") as f:
        try:
            data = pickle.load(f)
        except ModuleNotFoundError as e:
            raise ModuleNotFoundError(
                f"{path}: unpickling needs the module {e.name!r}, which is "
                f"not installed: this is a reference persistence pickle, "
                f"and loading it requires the reference (PyTorch SHERF) "
                f"sources on the import path", name=e.name) from e
    out = {}
    for key, value in data.items():
        if hasattr(value, "state_dict"):
            out[key] = {k: _np(v) for k, v in value.state_dict().items()}
        elif isinstance(value, Mapping):
            out[key] = {k: _np(v) for k, v in value.items()}
    return out


# ---------------------------------------------------------------------------
# ResNet18 (torchvision layout -> features.resnet.ResNet18)


def import_resnet18(sd: Mapping[str, np.ndarray], prefix: str = "",
                    max_stage: int = 4):
    """Returns (params, batch_stats) for features.resnet.ResNet18.
    ``max_stage`` limits the imported stages: the feature encoder runs
    conv1 / bn1 / layer1 only."""
    p = lambda k: sd[prefix + k]
    params: Dict = {}
    stats: Dict = {}

    def bn(dst_p, dst_s, key):
        dst_p["scale"] = _np(p(key + ".weight"))
        dst_p["bias"] = _np(p(key + ".bias"))
        dst_s["mean"] = _np(p(key + ".running_mean"))
        dst_s["var"] = _np(p(key + ".running_var"))

    params["conv1"] = {"kernel": _conv_w(p("conv1.weight"))}
    params["bn1"], stats["bn1"] = {}, {}
    bn(params["bn1"], stats["bn1"], "bn1")

    for i in range(1, max_stage + 1):
        for b in range(2):
            name = f"layer{i}_{b}"
            src = f"layer{i}.{b}"
            blk_p: Dict = {}
            blk_s: Dict = {}
            blk_p["conv1"] = {"kernel": _conv_w(p(src + ".conv1.weight"))}
            blk_p["conv2"] = {"kernel": _conv_w(p(src + ".conv2.weight"))}
            blk_p["bn1"], blk_s["bn1"] = {}, {}
            bn(blk_p["bn1"], blk_s["bn1"], src + ".bn1")
            blk_p["bn2"], blk_s["bn2"] = {}, {}
            bn(blk_p["bn2"], blk_s["bn2"], src + ".bn2")
            if (prefix + src + ".downsample.0.weight") in sd:
                blk_p["down_conv"] = {"kernel": _conv_w(
                    p(src + ".downsample.0.weight"))}
                blk_p["down_bn"], blk_s["down_bn"] = {}, {}
                bn(blk_p["down_bn"], blk_s["down_bn"], src + ".downsample.1")
            params[name] = blk_p
            stats[name] = blk_s
    return params, stats


# ---------------------------------------------------------------------------
# StyleGAN2 backbone


def import_mapping(sd: Mapping[str, np.ndarray], prefix: str = "mapping.",
                   num_layers: int = 2):
    """Returns (params, ema) for features.stylegan2.MappingNetwork."""
    params = {}
    for i in range(num_layers):
        params[f"fc{i}"] = {"weight": _np(sd[f"{prefix}fc{i}.weight"]),
                            "bias": _np(sd[f"{prefix}fc{i}.bias"])}
    ema = {"w_avg": _np(sd[f"{prefix}w_avg"])}
    return params, ema


def _import_synth_layer(sd, prefix):
    params = {
        "weight": _conv_w(sd[prefix + ".weight"]),
        "bias": _np(sd[prefix + ".bias"]),
        "affine": {"weight": _np(sd[prefix + ".affine.weight"]),
                   "bias": _np(sd[prefix + ".affine.bias"])},
    }
    noise = {}
    if prefix + ".noise_strength" in sd:
        params["noise_strength"] = _np(sd[prefix + ".noise_strength"])
        noise["noise_const"] = _np(sd[prefix + ".noise_const"])
    return params, noise


def import_stylegan2_backbone(sd: Mapping[str, np.ndarray],
                              img_resolution: int = 256, prefix: str = "",
                              mapping_layers: int = 2):
    """Returns (params, noise, ema) for features.stylegan2.StyleGAN2Backbone
    from a reference backbone state_dict (networks_stylegan2.Generator
    layout)."""
    synth_p: Dict = {}
    noise_c: Dict = {}
    resolutions = [2 ** i for i in range(2, int(math.log2(img_resolution)) + 1)]
    for res in resolutions:
        bp: Dict = {}
        bn: Dict = {}
        src = f"{prefix}synthesis.b{res}"
        if res == 4:
            bp["const"] = np.transpose(_np(sd[src + ".const"]), (1, 2, 0))
        else:
            bp["conv0"], n0 = _import_synth_layer(sd, src + ".conv0")
            if n0:
                bn["conv0"] = n0
        bp["conv1"], n1 = _import_synth_layer(sd, src + ".conv1")
        if n1:
            bn["conv1"] = n1
        bp["torgb"], _ = _import_synth_layer(sd, src + ".torgb")
        synth_p[f"b{res}"] = bp
        if bn:
            noise_c[f"b{res}"] = bn

    map_p, map_ema = import_mapping(sd, prefix=prefix + "mapping.",
                                    num_layers=mapping_layers)
    params = {"synthesis": synth_p, "mapping": map_p}
    noise = {"synthesis": noise_c}
    ema = {"mapping": map_ema}
    return params, noise, ema


def import_superresolution(sd: Mapping[str, np.ndarray], prefix: str = ""):
    """Reference SuperresolutionHybrid{2X,4X,8X,8XDC} state_dict -> (params,
    noise) for features.superresolution.SuperresolutionHybrid (two blocks
    of conv0 / conv1 / torgb synthesis layers)."""
    params: Dict = {}
    noise: Dict = {}
    for b in ("block0", "block1"):
        bp: Dict = {}
        bn: Dict = {}
        for layer in ("conv0", "conv1"):
            bp[layer], n = _import_synth_layer(sd, f"{prefix}{b}.{layer}")
            if n:
                bn[layer] = n
        bp["torgb"], _ = _import_synth_layer(sd, f"{prefix}{b}.torgb")
        params[b] = bp
        if bn:
            noise[b] = bn
    return params, noise


# ---------------------------------------------------------------------------
# The whole SHERF generator (reference TriPlaneGenerator state_dict)


def _linear(sd, key):
    """torch Linear / Conv1d(k=1) (out, in[, 1]) -> Dense {kernel, bias}."""
    w = _np(sd[key + ".weight"])
    if w.ndim == 3:
        w = w[..., 0]
    out = {"kernel": np.ascontiguousarray(w.T)}
    if key + ".bias" in sd:
        out["bias"] = _np(sd[key + ".bias"])
    return out


def _layernorm(sd, key):
    return {"scale": _np(sd[key + ".weight"]), "bias": _np(sd[key + ".bias"])}


def _spconv_w(sd, key, layout: str = "native"):
    """spconv SubMConv3d / SparseConv3d weight -> (kd, kh, kw, in, out).
    spconv 2.x's 'native' layout is (out, kd, kh, kw, in); any other layout
    is taken as already (kd, kh, kw, in, out)."""
    w = _np(sd[key + ".weight"])
    if layout == "native":
        return np.transpose(w, (1, 2, 3, 4, 0))
    return w


def _bn1d(sd, key):
    p = {"scale": _np(sd[key + ".weight"]), "bias": _np(sd[key + ".bias"])}
    s = {"mean": _np(sd[key + ".running_mean"]),
         "var": _np(sd[key + ".running_var"])}
    return p, s


def _sparse_stage(sd, key, n_convs, layout):
    """double_conv / triple_conv SparseSequential: conv at 3k, BN at 3k+1."""
    p, s = {}, {}
    for i in range(n_convs):
        p[f"conv{i}"] = _spconv_w(sd, f"{key}.{3 * i}", layout)
        p[f"bn{i}"], s[f"bn{i}"] = _bn1d(sd, f"{key}.{3 * i + 1}")
    return p, s


def _sparse_down(sd, key, layout):
    p, s = {}, {}
    p["conv"] = _spconv_w(sd, f"{key}.0", layout)
    p["bn"], s["bn"] = _bn1d(sd, f"{key}.1")
    return p, s


def _sherf_generator_tree(sd: Mapping[str, np.ndarray],
                          use_nerf_decoder: bool = True,
                          use_trans: bool = True,
                          use_1d_feature: bool = True,
                          use_2d_feature: bool = True,
                          use_3d_feature: bool = True,
                          sparse_layers: int = 4,
                          backbone_resolution: int = 256,
                          spconv_layout: str = "native") -> Dict:
    """Reference TriPlaneGenerator state_dict -> the flax-layout variables
    {"params", "batch_stats", "noise", "ema"} of the JAX package's
    SHERFGenerator, as numpy arrays (the key naming follows the reference
    source, triplane.py / renderer.py)."""
    params: Dict = {}
    stats: Dict = {}

    params["encoder_2d"], stats["encoder_2d"] = import_resnet18(
        sd, prefix="encoder_2d.backbone.")
    params["encoder_2d_feature"], stats["encoder_2d_feature"] = import_resnet18(
        sd, prefix="encoder_2d_feature.backbone.", max_stage=1)
    params["conv1d_projection"] = _linear(sd, "conv1d_projection")

    bb_p, bb_noise, bb_ema = import_stylegan2_backbone(
        sd, img_resolution=backbone_resolution, prefix="backbone.",
        mapping_layers=2)
    params["backbone"] = bb_p

    r: Dict = {}
    rs: Dict = {}
    r["conv1d_projection"] = _linear(sd, "renderer.conv1d_projection")
    # conv1d_reprojection exists only with two or more feature banks (96 ->
    # 32 for three, 64 -> 32 for two; reference renderer.py:272-275)
    n_banks = int(use_1d_feature) + int(use_2d_feature) + int(use_3d_feature)
    if n_banks >= 2:
        r["conv1d_reprojection"] = _linear(sd, "renderer.conv1d_reprojection")

    if use_trans:
        t = "renderer.transformer.layers.0"
        r["transformer"] = {
            "attn_norm_0": _layernorm(sd, t + ".0.fn.norm"),
            "ff_norm_0": _layernorm(sd, t + ".1.fn.norm"),
            "attn_0": {
                "to_qkv": {"kernel": np.ascontiguousarray(
                    _np(sd[t + ".0.fn.fn.to_qkv.weight"]).T)},
                "to_out": _linear(sd, t + ".0.fn.fn.to_out.0"),
            },
            "ff_0": {"fc1": _linear(sd, t + ".1.fn.fn.net.0"),
                     "fc2": _linear(sd, t + ".1.fn.fn.net.3")},
        }

    if use_nerf_decoder:
        dec = {f"pts_{i}": _linear(sd, f"decoder.pts_linears.{i}")
               for i in range(8)}
        dec["alpha"] = _linear(sd, "decoder.alpha_linear")
        dec["feature"] = _linear(sd, "decoder.feature_linear")
        dec["views"] = _linear(sd, "decoder.views_linear")
        dec["rgb"] = _linear(sd, "decoder.rgb_linear")
    else:
        dec = {"fc0": {"weight": _np(sd["decoder.net.0.weight"]),
                       "bias": _np(sd["decoder.net.0.bias"])},
               "fc1": {"weight": _np(sd["decoder.net.2.weight"]),
                       "bias": _np(sd["decoder.net.2.bias"])}}
    r["decoder"] = dec

    # the reference builds encoder_3d whatever the flags (renderer.py:270);
    # the generator has it only with the 3D bank
    if use_3d_feature:
        e3: Dict = {}
        e3s: Dict = {}
        stages = [("conv0", 2), ("down0", 0), ("conv1", 2), ("down1", 0),
                  ("conv2", 3), ("down2", 0), ("conv3", 3)]
        # conv0 / down0 always, then a conv and a downsample a layer, conv3
        # last
        for name, n_convs in stages[:min(2 * sparse_layers, len(stages))]:
            key = f"renderer.encoder_3d.{name}"
            if n_convs:
                e3[name], e3s[name] = _sparse_stage(sd, key, n_convs,
                                                    spconv_layout)
            else:
                e3[name], e3s[name] = _sparse_down(sd, key, spconv_layout)
        r["encoder_3d"] = e3
        rs["encoder_3d"] = e3s

    params["renderer"] = r
    stats["renderer"] = rs
    return {"params": params, "batch_stats": stats,
            "noise": {"backbone": bb_noise}, "ema": {"backbone": bb_ema}}


def import_sherf_generator(sd: Mapping[str, np.ndarray], **kwargs):
    """Reference TriPlaneGenerator state_dict -> a ``state_dict`` of the
    port's ``SHERFGenerator`` (load it with ``strict=True``: a model of
    other widths or flags then fails instead of loading part of it).  The
    keyword arguments select the flags and widths of the JAX function's:
    ``use_nerf_decoder``, ``use_trans``, ``use_1d/2d/3d_feature``,
    ``sparse_layers`` (4), ``backbone_resolution`` (256) and
    ``spconv_layout`` ('native')."""
    return from_flax(_sherf_generator_tree(sd, **kwargs))
