"""The port's multi-process training (``sherf_tpu_torch/parallel``, the
sharded steps of ``train/step.py`` and ``train/gan.py``, the train CLI's
``--mesh`` / ``--coordinator``) on the CPU.

  * The mesh helpers against JAX's (``sherf_tpu/parallel/mesh.py``): the
    ray interleave and its inverse bit-equal; each rank's ``shard_batch``
    equal to JAX's device shard of the same (data, rays) mesh; the (data,
    rays) ``auto_mesh`` chooses over a grid of batch, ray and device counts.
  * Two ranks under gloo, through a ``file://`` store in the test's
    directory, at meshes (1, 2) (rays, batch 1) and (2, 1) (data, batch 2):
    a sharded render, one sharded train step and one sharded GAN round
    (Gmain, Dmain, Dreg) against the port's one-process phases on the same
    items (``parallel/reference.py``: each data group's items through the
    one-process phase, gradients averaged; with one data group, the
    one-process phase itself), which ``tests/test_torch_train.py`` and
    ``tests/test_torch_gan.py`` hold to JAX.  The JAX package's own
    sharded GAN test fails today, so the port is not held to it.  Gates,
    the JAX package's own (``tests/test_multidevice.py``): losses rtol
    1e-4; parameters after the step rtol 2e-3 / atol 2e-5; renders rtol /
    atol 1e-5; and the gradient norm rtol 1e-4 (Adam's first step hides the
    gradient's scale from the parameters); overflow 0 on every rank; every
    rank ends with the same parameters.
  * ``maybe_initialize_distributed`` from the ``SHERF_*`` environment;
    ``cli/train.main --mesh 1,2`` over two processes writes one snapshot
    (rank 0) that restores; ``training_loop``'s ``progress_fn`` and
    ``abort_fn``; ``save_checkpoint(step=)``.

Every multi-process case runs under a join timeout (JOIN_S): a hang fails
the test and leaves no process behind.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_cases as cases
from sherf_tpu.data import make_synthetic_batch as j_make_batch
from sherf_tpu.parallel import mesh as j_mesh
from sherf_tpu import smpl as j_smpl
from sherf_tpu_torch.core.config import DataConfig, TrainConfig
from sherf_tpu_torch.core.types import SHERFBatch
from sherf_tpu_torch.parallel import mesh as t_mesh
from sherf_tpu_torch.parallel.launch import run_local
from sherf_tpu_torch.parallel.reference import (data_parallel_phase,
                                                split_items)
from sherf_tpu_torch.train import (create_train_state, make_train_step,
                                   training_loop)
from sherf_tpu_torch.train.checkpoint import (latest_checkpoint,
                                              restore_checkpoint,
                                              save_checkpoint)
from sherf_tpu_torch.train.gan import (_step_d, create_d_train_state,
                                       make_gan_train_step)
from sherf_tpu_torch.train.train_state import ema_beta, ema_update

JOIN_S = 180.0
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5
RENDER_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ mesh helpers

@pytest.mark.parametrize("rm", [1, 2, 3, 4])
def test_interleave_bit_equal_to_jax(rm):
    x = np.random.RandomState(rm).randn(2, 12 * rm, 3).astype(np.float32)
    ti = t_mesh._interleave(torch.from_numpy(x), rm).numpy()
    ji = np.asarray(j_mesh._interleave(jnp.asarray(x), rm))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(
        t_mesh.uninterleave_rays(torch.from_numpy(ji.copy()), rm).numpy(),
        np.asarray(j_mesh.uninterleave_rays(jnp.asarray(ji), rm)))
    np.testing.assert_array_equal(
        t_mesh.uninterleave_rays(torch.from_numpy(ti), rm).numpy(), x)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_shard_batch_is_jax_device_shard(shape):
    """Rank d * rm + r's shard is JAX's shard on mesh device (d, r)."""
    js = j_smpl.synthetic_smpl(0)
    jb = j_make_batch(js, batch_size=2, H=4, W=8, seed=0)
    tb = SHERFBatch.from_numpy(jax.device_get(jb))
    mesh = j_mesh.make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    sharded = j_mesh.shard_batch(jb, mesh, interleave=True)
    devices = mesh.devices
    for rank in range(shape[0] * shape[1]):
        local = t_mesh.shard_batch(tb, t_mesh.Mesh(*shape, rank=rank))
        dev = devices[rank // shape[1], rank % shape[1]]
        for field in ("ray_o", "ray_d", "near", "far", "mask_at_box",
                      "bkgd_msk", "img", "obs_img", "vertices"):
            arr = getattr(sharded, field)
            part = [s.data for s in arr.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(getattr(local, field).numpy(),
                                          np.asarray(part[0]), err_msg=field)


def test_auto_mesh_chooses_as_jax():
    for n in range(1, 9):
        for batch in (1, 2, 3, 4, 6):
            for rays in (1, 6, 8, 12, 15, 4096):
                jm = j_mesh.auto_mesh(batch, rays, devices=jax.devices()[:n])
                assert t_mesh.auto_mesh_shape(batch, rays, n) == \
                    tuple(jm.devices.shape), (n, batch, rays)


def test_one_process_mesh_and_collectives_are_identities():
    from sherf_tpu_torch.parallel.multihost import global_batch_size

    mesh = t_mesh.make_mesh()
    assert (mesh.data, mesh.rays, mesh.rank, mesh.backend) == (1, 1, 0, None)
    assert t_mesh.auto_mesh(4, 4096).shape == {"data": 1, "rays": 1}
    assert global_batch_size(3, t_mesh.Mesh(2, 2)) == 6
    x = torch.randn(2, 6, 3)
    assert t_mesh.gather_rays(mesh, x) is x
    with pytest.raises(ValueError, match="does not cover"):
        t_mesh.make_mesh((1, 2))


# ------------------------------------------------------- two ranks, gloo

def _spawn(fn, tmp_path, *args, world=2):
    init = str(tmp_path / "store")
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    codes = run_local(fn, world, (init, *args, str(out)), timeout_s=JOIN_S)
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _reference(shape):
    """The one-process counterparts of the sharded round on the same
    items and weights."""
    dm = shape[0]
    smpl, batch, cfg, out_sh = cases.scene(batch_size=dm)
    groups = split_items(batch, dm)
    tcfg = TrainConfig(batch_size=dm, **cases.TRAIN_KW)
    beta = ema_beta(tcfg.batch_size, tcfg.ema_kimg)
    gen = torch.Generator().manual_seed(0)

    def g_update(s):
        s.apply_gradients()
        ema_update(s.ema, s.model.named_parameters(), beta)

    ref = {}
    model = cases.model_of(cfg, out_sh).eval()
    with torch.no_grad():
        ref["render"], diag = model(batch, smpl)
    assert all(int(v) == 0 for v in diag.values())

    model = cases.model_of(cfg, out_sh)
    state = create_train_state(model, tcfg)
    ref["train"] = data_parallel_phase(make_train_step(model, smpl, tcfg),
                                       state, groups, args_after=(gen,),
                                       step=g_update)
    ref["train_params"] = cases._params(model)

    model = cases.model_of(cfg, out_sh)
    g_state = create_train_state(model, tcfg)
    d_state = create_d_train_state(cases.disc(), tcfg,
                                   generator=torch.Generator().manual_seed(1))
    g_step, d_main, d_reg = make_gan_train_step(model, smpl, tcfg)
    ref["gan_g"] = data_parallel_phase(g_step, g_state, groups,
                                       args_before=(d_state,),
                                       args_after=(gen,), step=g_update)
    ref["gan_d"] = data_parallel_phase(d_main, d_state, groups,
                                       args_before=(g_state,),
                                       args_after=(gen,), step=_step_d)
    ref["gan_r"] = data_parallel_phase(d_reg, d_state, groups, step=_step_d)
    ref["gan_g_params"] = cases._params(model)
    ref["gan_d_params"] = cases._params(d_state.model)
    return ref, batch


def _close_params(got, ref, what):
    assert got.keys() == ref.keys()
    for n in ref:
        np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{what}: {n}")


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["rays", "data"])
def test_sharded_round_matches_one_process(shape, tmp_path, record_property):
    ranks = _spawn(cases.sharded_round, tmp_path, shape)
    ref, batch = _reference(shape)
    dm, rm = shape
    n_rays = batch.ray_o.shape[1]
    for rank, res in enumerate(ranks):
        assert res["mesh"] == (dm, rm, rank // rm, rank % rm)
        assert res["backend"] == "gloo" and res["local_rays"] == n_rays // rm
        # the render: this data group's items, every ray
        d = rank // rm
        items = slice(d, d + 1) if dm > 1 else slice(None)
        want = {k: v[items].numpy() for k, v in ref["render"].items()}
        for k in ("image_raw", "weights_image"):
            np.testing.assert_allclose(res["render"][k].numpy(), want[k],
                                       rtol=RENDER_TOL, atol=RENDER_TOL,
                                       err_msg=k)
        # a ray the ray budget drops takes the largest far of the rays its
        # renderer sees (the shard's, as in JAX's shard_map body): depth is
        # held where the ray gathered any opacity
        seen = want["weights_image"] > 0
        assert seen.sum() >= 8
        np.testing.assert_allclose(res["render"]["image_depth"].numpy()[seen],
                                   want["image_depth"][seen],
                                   rtol=RENDER_TOL, atol=RENDER_TOL)
        assert float(res["render"]["overflow"]) == 0
        # the train step and the GAN round
        for phase in ("train", "gan_g", "gan_d", "gan_r"):
            got, want = res[phase], ref[phase]
            assert set(got) >= set(want) - {"grad_norm"}, phase
            for k in want:
                if k == "overflow":
                    assert float(got[k]) == 0 and float(want[k]) == 0
                    continue
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           rtol=LOSS_RTOL,
                                           err_msg=f"{phase} {k}")
        _close_params(res["train_params"], ref["train_params"], "train")
        # make_phase_fns on the mesh: the step's metrics and parameters
        for k, v in res["phases"].items():
            assert torch.equal(v, res["train"][k]), k
        for n, p in res["phases_params"].items():
            assert torch.equal(p, res["train_params"][n]), n
        _close_params(res["gan_g_params"], ref["gan_g_params"], "gan G")
        _close_params(res["gan_d_params"], ref["gan_d_params"], "gan D")
        assert all(v == 0 for v in res["launches"].values())    # CPU: plain
    for key in ("train_params", "gan_g_params", "gan_d_params"):
        for n in ranks[0][key]:
            assert torch.equal(ranks[0][key][n], ranks[1][key][n]), (key, n)
    record_property("train_loss", float(ranks[0]["train"]["loss"]))


def test_backend_rule(monkeypatch):
    """NCCL when each rank of this host owns a GPU, gloo when there are
    more ranks here than GPUs; a CUDA world larger than this host's GPUs
    without ``LOCAL_WORLD_SIZE`` raises rather than guess."""
    from sherf_tpu_torch.parallel.multihost import choose_backend

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert choose_backend(cpu, 2) == "gloo"
    assert choose_backend(cuda, 1) == "nccl"
    with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
        choose_backend(cuda, 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert choose_backend(cuda, 2) == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert choose_backend(cuda, 8) == "nccl"     # 8 hosts, a GPU each


def test_initialize_from_the_environment(tmp_path):
    ranks = _spawn(cases.env_join, tmp_path)
    for rank, res in enumerate(ranks):
        assert res["got"] == (rank, 2) and res["backend"] == "gloo"
        assert res["sum"] == 3.0


def test_initialize_without_a_coordinator_is_one_process(monkeypatch):
    from sherf_tpu_torch.parallel.multihost import maybe_initialize_distributed

    for var in ("SHERF_COORDINATOR", "SHERF_NUM_PROCESSES",
                "SHERF_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed(num_processes=2, process_id=1) == (0, 1)
    with pytest.raises(ValueError, match="--num_processes"):
        maybe_initialize_distributed("localhost:1")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("flags", [
    ["--cfg", "synthetic", "--batch", "1", "--mesh", "1,2"],
    ["--cfg", "synthetic_grid", "--num_instance", "2", "--batch", "2",
     "--mesh", "2,1", "--neural_rendering_resolution_initial", "32"]],
    ids=["rays_batch_source", "data_loader"])
def test_train_cli_over_two_processes(tmp_path, flags):
    """Both ranks end at step 2 with the same weights, and rank 0 alone
    writes stats.jsonl (overflow 0), the sample grids and one snapshot,
    which restores into a fresh state with those weights and EMA.  ``--mesh 1,2`` on the synthetic cfg (each
    rank's shard of the CLI's batch source); ``--mesh 2,1`` on the
    synthetic_grid rig through its loader (each data group's own items)."""
    ranks = _spawn(cases.train_cli, tmp_path, flags)
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    run = tmp_path / "out" / "run"
    lines = [json.loads(x) for x in open(run / "stats.jsonl")]
    loss = [x for x in lines if "Loss/loss" in x]
    assert [x["step"] for x in loss] == [1, 2]
    assert all(np.isfinite(x["Loss/loss"]) and x["Loss/overflow"] == 0
               for x in loss)
    assert sorted(os.listdir(run / "checkpoints")) == ["snapshot-000002.pt"]
    assert ranks[0]["restored"] == {"step": 2, "digest": ranks[0]["digest"],
                                    "ema_equal": True}


# ------------------------------------------- the loop's hooks, checkpoints

def _loop(tmp_path, total_kimg, **hooks):
    smpl, _, cfg, _ = cases.scene(batch_size=1)
    tcfg = TrainConfig(batch_size=1, total_kimg=total_kimg, report_imgs=1,
                       lr=1e-3, outdir=str(tmp_path))
    seeds = iter(range(100))
    from sherf_tpu_torch.data.synthetic import make_synthetic_batch

    def batch_source():
        return make_synthetic_batch(smpl, batch_size=1, H=cases.H, W=cases.W,
                                    seed=next(seeds), device="cpu")
    return training_loop(cfg, tcfg, DataConfig(), smpl,
                         batch_source=batch_source, device="cpu", **hooks)


def test_progress_fn_sees_every_report(tmp_path):
    calls = []
    state = _loop(tmp_path, 0.003,
                  progress_fn=lambda step, means: calls.append((step, means)))
    assert state.step == 3
    assert [s for s, _ in calls] == [1, 2, 3]
    lines = [json.loads(x) for x in open(tmp_path / "stats.jsonl")]
    for (step, means), line in zip(calls, [x for x in lines
                                           if "Loss/loss" in x]):
        assert line["step"] == step
        assert means["Loss/loss"] == pytest.approx(line["Loss/loss"])


def test_abort_fn_stops_after_the_first_report(tmp_path):
    polls = []

    def abort():
        polls.append(1)
        return True
    state = _loop(tmp_path, 0.003, abort_fn=abort)
    assert state.step == 1 and len(polls) == 1
    assert latest_checkpoint(str(tmp_path / "checkpoints")).endswith(
        "snapshot-000001.pt")
    assert os.path.exists(tmp_path / "fakes000001.png")
    lines = [json.loads(x) for x in open(tmp_path / "stats.jsonl")]
    assert [x["step"] for x in lines if "Loss/loss" in x] == [1]


def test_phase_fns_compose_to_the_step():
    """``make_phase_fns``' grad, optimizer and EMA phases, run in turn, give
    the fused step's metrics, parameters and EMA."""
    from sherf_tpu_torch.train.step import make_phase_fns

    smpl, batch, cfg, out_sh = cases.scene(batch_size=1)
    tcfg = TrainConfig(batch_size=1, lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    fused = cases.model_of(cfg, out_sh)
    s_fused = create_train_state(fused, tcfg)
    m_fused = make_train_step(fused, smpl, tcfg)(s_fused, batch, gen)
    split = cases.model_of(cfg, out_sh)
    s_split = create_train_state(split, tcfg)
    grad_fn, opt_fn, ema_fn = make_phase_fns(split, smpl, tcfg)
    m_split = grad_fn(s_split, batch, gen)
    opt_fn(s_split)
    ema_fn(s_split)
    assert s_split.step == s_fused.step == 1
    for k, v in m_split.items():
        assert torch.equal(v, m_fused[k]), k
    for (n, p), q in zip(split.named_parameters(), fused.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(s_split.ema[n], s_fused.ema[n]), n


def test_save_checkpoint_step(tmp_path):
    model = torch.nn.Linear(3, 2)
    state = create_train_state(model, TrainConfig(batch_size=1))
    state.step = 7
    path = save_checkpoint(str(tmp_path), state, step=42)
    assert path.endswith("snapshot-000042.pt")
    assert save_checkpoint(str(tmp_path), state).endswith("snapshot-000007.pt")
    fresh = create_train_state(torch.nn.Linear(3, 2),
                               TrainConfig(batch_size=1))
    restore_checkpoint(path, fresh)
    assert fresh.step == 7
    assert torch.equal(fresh.model.weight, model.weight)
