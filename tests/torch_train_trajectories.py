"""Train-step trajectories of the JAX package and the port from the same
initial weights, on the CPU (not a test module: run it by hand).

  python tests/torch_train_trajectories.py grad_scene DTYPE LR SEED
      20 steps on ``tests/test_torch_train.py``'s 12x12x4 ``grad_scene``
      (batch 2, parity render; the port's volume decisions and JAX's conv
      core by autodiff shared, as the gradient tests do) from the port's
      ``init_weights_`` (SEED), handed to JAX through the test-side inverse
      of ``from_flax``: both packages' losses, step by step.
  python tests/torch_train_trajectories.py toy KEYS STEPS LR [MODE]
      The JAX package's slow convergence test scene (16x16, backbone 32,
      2 cm voxels, 6 samples, point budget 0.5, f32) from JAX's
      ``model.init(PRNGKey(k))`` for each k of KEYS (comma separated), JAX
      stepping as MODE says (see ``grads``):
      each package's final and least loss after STEPS steps and whether
      its last 10 losses are frozen (every density clamped to 0: the
      density head is dead), the first step at which the two packages'
      losses differ by more than 0.1% and by more than 1%, and both loss
      curves.  One JSON line a key.
  python tests/torch_train_trajectories.py grads KEY LR [MODE [STEPS]]
      The same scene and JAX's ``PRNGKey(KEY)`` weights, or the port's
      after STEPS steps from them (handed to JAX through the test-side
      inverse of ``from_flax``): both packages' gradients there, leaf by
      leaf (``from_flax``'s names),
      JAX's as it trains (MODE ``jax``, the default), with its sparse-conv
      core differentiated by autodiff (``exact``: the adjoint, as the port
      computes it; ROADMAP Queue C), or that and the port's two discrete
      observation-volume decisions handed to it (``shared``, as the
      gradient tests of ``tests/test_torch_train.py`` do),
      and Adam's next update from each (beta1 = 0: g over the root of the
      second moment, the port's after STEPS steps, plus eps):
      how many entries' updates differ in sign, the largest |g| (relative
      to the leaf's largest) among them, and the relative L2 of the
      gradients and of the updates.  One JSON line a leaf with a sign
      flip, then one line of totals.

Run from the repository root with the root on ``PYTHONPATH``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402,F401 — the CPU platform and the compile cache
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sherf_tpu.core.config import ModelConfig as JModelConfig  # noqa: E402
from sherf_tpu.core.config import RenderConfig as JRenderConfig  # noqa: E402
from sherf_tpu.core.config import TrainConfig as JTrainConfig  # noqa: E402
from sherf_tpu.data import make_synthetic_batch as j_make_batch  # noqa: E402
from sherf_tpu.features.sparseconv import (  # noqa: E402
    prepare_voxel_volume as j_prepare_voxel_volume)
from sherf_tpu.models import SHERFGenerator as JGenerator  # noqa: E402
from sherf_tpu import smpl as j_smpl  # noqa: E402
from sherf_tpu import train as j_train  # noqa: E402
from sherf_tpu.train import step as j_step  # noqa: E402
from sherf_tpu_torch.compat.flax_bridge import from_flax  # noqa: E402
from sherf_tpu_torch.core.config import (ModelConfig, RenderConfig,  # noqa: E402
                                         TrainConfig)
from sherf_tpu_torch.core.types import SHERFBatch  # noqa: E402
from sherf_tpu_torch.models.generator import (SHERFGenerator,  # noqa: E402
                                              init_weights_)
from sherf_tpu_torch import smpl as t_smpl  # noqa: E402
from sherf_tpu_torch.train import step as t_step  # noqa: E402
from sherf_tpu_torch.train import (create_train_state,  # noqa: E402
                                   make_train_step)


def _jax_losses(jm, js, params, extra, batch, tcfg, n):
    state = j_train.create_train_state(params, extra, tcfg)
    step = j_train.make_train_step(jm, js, tcfg, donate=False)
    rng, out = jax.random.PRNGKey(7), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        state, m = step(state, batch, sub)
        out.append(float(m["loss"]))
    return out


def _port_losses(model, smpl, batch, tcfg, n):
    state = create_train_state(model, tcfg)
    step = make_train_step(model, smpl, tcfg)
    gen = torch.Generator().manual_seed(7)
    return [float(step(state, batch, gen)["loss"]) for _ in range(n)]


def grad_scene(dtype, lr, seed, n=20):
    import test_torch_train as T
    from test_torch_branches import _to_flax

    sc = T.grad_scene.__wrapped__()
    tm = SHERFGenerator(ModelConfig(**T.GRAD_KW, compute_dtype=dtype,
                                    render=sc["render"]),
                        out_sh=sc["out_sh"], device="cpu")
    init_weights_(tm, torch.Generator().manual_seed(seed))
    v = _to_flax(tm)
    # oneDNN off: its bf16 convolution gradient fault (ROADMAP Queue C)
    with torch.backends.mkldnn.flags(enabled=False):
        t = _port_losses(tm, sc["ts"], sc["tb"], TrainConfig(batch_size=2,
                                                             lr=lr), n)
    with pytest.MonkeyPatch.context() as mp:
        T._share_port_decisions(mp, sc)
        jm = JGenerator(JModelConfig(**T.GRAD_KW, render=sc["render"],
                                     compute_dtype=dtype), out_sh=sc["out_sh"])
        j = _jax_losses(jm, sc["js"], v["params"],
                        {k: x for k, x in v.items() if k != "params"},
                        sc["jb"], JTrainConfig(batch_size=2, lr=lr), n)
    print(json.dumps({"dtype": dtype, "lr": lr, "seed": seed,
                      "port": [round(x, 5) for x in t],
                      "jax": [round(x, 5) for x in j]}))


def _toy_scene():
    js = j_smpl.synthetic_smpl(0)
    bp = j_smpl.big_pose_params()
    tv = np.asarray(j_smpl.smpl_forward(js, jnp.asarray(bp["poses"]),
                                        jnp.asarray(bp["shapes"]))[0])
    _, out_sh = j_prepare_voxel_volume(tv, voxel_size=0.02)
    kw = dict(backbone_resolution=32, voxel_size=0.02)
    rk = dict(depth_resolution=6, point_capacity_frac=0.5, density_noise=0.0)
    jm = JGenerator(JModelConfig(**kw, render=JRenderConfig(**rk)),
                    out_sh=out_sh)
    jb = j_make_batch(js, batch_size=1, H=16, W=16, seed=0)
    init = jax.jit(lambda k, b: jm.init(k, b, js))
    ts = t_smpl.synthetic_smpl(0, device="cpu")
    tm = SHERFGenerator(ModelConfig(**kw, render=RenderConfig(**rk)),
                        out_sh=out_sh, device="cpu")
    tb = SHERFBatch.from_numpy(jax.device_get(jb))
    return js, jm, jb, init, ts, tm, tb


def _jax_as(mp, mode, tm, ts, tb, jb):
    """JAX's gradient as it trains (``jax``), its sparse-conv core by
    autodiff (``exact``), or that and the port's decisions (``shared``)."""
    import test_torch_train as T

    if mode in ("exact", "shared"):
        mp.setattr(T.j_sc, "_conv_core", T._exact_conv_core)
    if mode == "shared":
        t_coords, t_vis = _port_decisions(tm, ts, tb)
        T._share_port_decisions(mp, dict(jb=jb, t_coords=t_coords,
                                          t_vis=t_vis))


def toy(keys, n, lr, mode="jax"):
    js, jm, jb, init, ts, tm, tb = _toy_scene()
    frozen = lambda losses: len({round(x, 6) for x in losses[-10:]}) == 1

    def first_apart(a, b, rel):
        return next((i + 1 for i, (x, y) in enumerate(zip(a, b))
                     if abs(x - y) > rel * abs(x)), None)
    for k in keys:
        v = jax.tree_util.tree_map(np.asarray, jax.device_get(
            init(jax.random.PRNGKey(k), jb)))
        v.pop("diag", None)
        tm.load_state_dict(from_flax(v), strict=True)
        with pytest.MonkeyPatch.context() as mp:
            _jax_as(mp, mode, tm, ts, tb, jb)
            j = _jax_losses(jm, js, v["params"],
                            {a: x for a, x in v.items() if a != "params"}, jb,
                            JTrainConfig(batch_size=1, lr=lr), n)
        t = _port_losses(tm, ts, tb, TrainConfig(batch_size=1, lr=lr), n)
        print(json.dumps({
            "key": k, "mode": mode, "jax_end": round(j[-1], 4), "jax_min": round(min(j), 4),
            "jax_frozen": frozen(j), "port_end": round(t[-1], 4),
            "port_min": round(min(t), 4), "port_frozen": frozen(t),
            "apart_0.1%": first_apart(j, t, 1e-3),
            "apart_1%": first_apart(j, t, 1e-2),
            "jax": [round(x, 5) for x in j], "port": [round(x, 5) for x in t]}),
            flush=True)


def _port_decisions(tm, ts, tb):
    """The port's site voxel of each vertex and each vertex's visibility
    (as ``tests/test_torch_train.py``'s ``grad_scene`` computes them)."""
    from sherf_tpu_torch.geometry.rays import backface_mask
    from sherf_tpu_torch.nerf.warp import batch_pose_contexts

    with torch.no_grad():
        obs_feat = tm.encoder_2d_feature(tb.obs_img, extract_feature=True)
        min_dhw = (tb.t_vertices.amin(dim=1) - 0.05)[:, [2, 1, 0]]
        _, t_coords = tm._observation_volume(
            tb, obs_feat, ts, min_dhw, batch_pose_contexts(ts, tb.obs_pose),
            batch_pose_contexts(ts, tb.t_pose))
        t_vis = torch.stack([backface_mask(tb.obs_vertices[b], ts.faces,
                                           tb.obs_K[b], tb.obs_R[b],
                                           tb.obs_T[b])
                             for b in range(tb.obs_vertices.shape[0])])
    return t_coords.numpy(), t_vis.numpy()


def grads(key, lr, mode="jax", steps=0):
    from test_torch_branches import _to_flax

    js, jm, jb, init, ts, tm, tb = _toy_scene()
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(
        init(jax.random.PRNGKey(key), jb)))
    v.pop("diag", None)
    tm.load_state_dict(from_flax(v), strict=True)
    tcfg_t = TrainConfig(batch_size=1, lr=lr)
    state = create_train_state(tm, tcfg_t)
    if steps:
        step = make_train_step(tm, ts, tcfg_t)
        gen = torch.Generator().manual_seed(7)
        losses = [float(step(state, tb, gen)["loss"]) for _ in range(steps)]
        v = _to_flax(tm)
        print(json.dumps({"port_losses": [round(x, 5) for x in losses]}))
    adam_v = {n: state.opt.state[p]["exp_avg_sq"].double()
              for n, p in tm.named_parameters() if p in state.opt.state}
    tcfg = JTrainConfig(batch_size=1, lr=lr)
    with pytest.MonkeyPatch.context() as mp:
        _jax_as(mp, mode, tm, ts, tb, jb)
        grad_fn = j_step.make_phase_fns(jm, js, tcfg)[0]
        (_, jmet), jg = grad_fn(v["params"], {a: x for a, x in v.items()
                                              if a != "params"},
                                jb, jax.random.PRNGKey(7))
    jg = from_flax({"params": jax.device_get(jg)})
    tm.zero_grad(set_to_none=True)
    t_grad = t_step.make_phase_fns(tm, ts, tcfg_t)[0]
    tmet = t_grad(state, tb, torch.Generator().manual_seed(7))
    # Adam's next update (beta1 = 0) from each gradient, both with the
    # port's second moments after ``steps`` steps (none at step 0)
    b2, eps, n = tcfg_t.betas[1], tcfg_t.eps, steps + 1
    tot = dict(entries=0, flips=0, g2=0.0, dg2=0.0, u2=0.0, du2=0.0)
    for name, p in tm.named_parameters():
        g = (torch.zeros_like(p) if p.grad is None else p.grad).double()
        r = jg[name].double()
        v0 = adam_v.get(name, torch.zeros_like(g)).reshape(-1)

        def update(x):
            vh = (b2 * v0 + (1 - b2) * x * x) / (1 - b2 ** n)
            return x / (vh.sqrt() + eps)
        g, r = g.numpy().ravel(), r.numpy().ravel()
        ut = update(torch.from_numpy(g)).numpy()
        uj = update(torch.from_numpy(r)).numpy()
        flip = np.sign(ut) != np.sign(uj)
        tot["entries"] += g.size
        tot["flips"] += int(flip.sum())
        tot["g2"] += float((r ** 2).sum())
        tot["dg2"] += float(((g - r) ** 2).sum())
        tot["u2"] += float((uj ** 2).sum())
        tot["du2"] += float(((ut - uj) ** 2).sum())
        if flip.any():
            big = np.abs(r).max()
            print(json.dumps({
                "leaf": name, "n": g.size, "flips": int(flip.sum()),
                "max_flipped_rel": float(np.abs(r[flip]).max() / big)
                if big else None,
                "max_abs_g": float(big),
                "g_rel_l2": float(np.linalg.norm(g - r) /
                                  max(np.linalg.norm(r), 1e-30))}))
    print(json.dumps({
        "key": key, "mode": mode, "after_steps": steps,
        "loss_jax": float(jmet["loss"]), "loss_port": float(tmet["loss"]),
        "entries": tot["entries"], "sign_flips": tot["flips"],
        "grad_rel_l2": (tot["dg2"] / max(tot["g2"], 1e-300)) ** 0.5,
        "update_rel_l2": (tot["du2"] / max(tot["u2"], 1e-300)) ** 0.5}))


if __name__ == "__main__":
    torch.set_num_threads(4)
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "grad_scene":
        grad_scene(args[0], float(args[1]), int(args[2]))
    elif mode == "grads":
        grads(int(args[0]), float(args[1]), *args[2:3],
              *[int(x) for x in args[3:4]])
    else:
        toy([int(k) for k in args[0].split(",")], int(args[1]), float(args[2]),
            *args[3:])
