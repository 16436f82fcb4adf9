"""The port's data pipeline against the JAX package's, on the CPU, on the same
numpy inputs:

  * ``geometry/cameras.py``: every function, to 1e-12 (the same numpy code
    and draws);
  * ``load_smpl`` on a pickle written here (scipy-sparse J_regressor, as
    ``tests/test_smpl.py`` writes it, and a shuffled kinematic tree): every
    array equal;
  * ``InfiniteSampler``: the first 500 indices equal for several (size,
    rank, replicas, seed, window); ``PrefetchLoader`` keeps the sampler's
    order with more worker threads than cores and passes a worker's
    exception on;
  * ``SyntheticDataset`` and ``SyntheticHumanDataset`` items of subject100
    at image scaling 1/16, from both eval protocols' index sets: draws and
    cameras equal, vertices within 2e-5 m (the SMPL forward's f32
    rounding), rays and near / far to f32 rounding, masks and splats
    flipping on edges only (< 1%, as ``test_synthetic_batch_matches_jax``);
  * ``collate``: every field of the batch equal on the same items;
  * the host SMPL copy: two models made in sequence give their own
    vertices (the JAX package keys its CPU copy by ``id``);
  * the dataset registry: the file-backed loaders raise.
"""

import gc
import pickle

import numpy as np
import jax
import pytest
import torch

from sherf_tpu.data import base as j_base
from sherf_tpu.data import sampler as j_sampler
from sherf_tpu.data import synthetic as j_syn
from sherf_tpu.geometry import cameras as j_cam
from sherf_tpu import smpl as j_smpl
from sherf_tpu_torch import data as t_data
from sherf_tpu_torch.data import base as t_base
from sherf_tpu_torch.data import sampler as t_sampler
from sherf_tpu_torch.data import synthetic as t_syn
from sherf_tpu_torch.geometry import cameras as t_cam
from sherf_tpu_torch import smpl as t_smpl

SCALING = 1 / 16
POSE_NUM = 4


@pytest.fixture(scope="module")
def smpls():
    return j_smpl.synthetic_smpl(0), t_smpl.synthetic_smpl(0, device="cpu")


# ---------------------------------------------------------------- cameras

def test_cameras_match_jax():
    rng = np.random.RandomState(0)
    fwd = rng.randn(5, 3).astype(np.float32)
    org = rng.randn(5, 3).astype(np.float32)
    np.testing.assert_allclose(t_cam.normalize(fwd), j_cam.normalize(fwd),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_cam.create_cam2world_matrix(fwd, org),
                               j_cam.create_cam2world_matrix(fwd, org),
                               rtol=0, atol=1e-12)
    for kw in (dict(horizontal_stddev=0.3, vertical_stddev=0.1, batch_size=4),
               dict(radius=2.7, batch_size=1)):
        a = t_cam.look_at_pose(0.4, 1.3, [0, 0.2, 0], rng=np.random.RandomState(5),
                               **kw)
        b = j_cam.look_at_pose(0.4, 1.3, [0, 0.2, 0], rng=np.random.RandomState(5),
                               **kw)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    a = t_cam.uniform_pose(0.1, 1.5, h_stddev=0.5, v_stddev=0.2, radius=2.0,
                           batch_size=3, rng=np.random.RandomState(9))
    b = j_cam.uniform_pose(0.1, 1.5, h_stddev=0.5, v_stddev=0.2, radius=2.0,
                           batch_size=3, rng=np.random.RandomState(9))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for fov, hw in ((18.837, (1, 1)), (30.0, (512, 384))):
        np.testing.assert_allclose(t_cam.fov_to_intrinsics(fov, *hw),
                                   j_cam.fov_to_intrinsics(fov, *hw),
                                   rtol=0, atol=1e-12)
    for c2w in b:
        for x, y in zip(t_cam.cam2world_to_KRT(c2w), j_cam.cam2world_to_KRT(c2w)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)


# -------------------------------------------------------------- load_smpl

@pytest.mark.parametrize("shuffle_ids", [False, True])
def test_load_smpl_matches_jax(smpls, tmp_path, shuffle_ids):
    import scipy.sparse as sp

    js = smpls[0]
    ids = np.arange(24, dtype=np.int64)
    parents = np.asarray(js.parents, np.int64)
    if shuffle_ids:      # joint ids that are not the columns: remapped
        ids = np.random.RandomState(3).permutation(24) + 100
        parents = ids[parents]
    data = {
        "J_regressor": sp.csr_matrix(np.asarray(js.J_regressor)),
        "weights": np.asarray(js.weights).astype(np.float64),
        "posedirs": np.asarray(js.posedirs).astype(np.float64),
        "v_template": np.asarray(js.v_template).astype(np.float64),
        "shapedirs": np.concatenate([np.asarray(js.shapedirs),
                                     np.ones((6890, 3, 290), np.float32)],
                                    axis=-1).astype(np.float64),
        "f": np.asarray(js.faces).astype(np.int64),
        "kintree_table": np.stack([
            np.concatenate([[2 ** 32 - 1], parents[1:]]), ids]),
    }
    path = str(tmp_path / "smpl.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    jm = j_smpl.load_smpl(path)
    tm = t_smpl.load_smpl(path, device="cpu")
    assert tm.parents == jm.parents == tuple(js.parents)
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                 "weights", "faces"):
        t, j = getattr(tm, name), np.asarray(getattr(jm, name))
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


# -------------------------------------------------------------- sampler

@pytest.mark.parametrize("size,rank,replicas,seed,window", [
    (1, 0, 1, 0, 0.5), (7, 0, 1, 3, 0.5), (96, 1, 4, 11, 0.5),
    (1000, 2, 3, 0, 0.25), (50, 0, 2, 5, 0.0)])
def test_infinite_sampler_matches_jax(size, rank, replicas, seed, window):
    kw = dict(rank=rank, num_replicas=replicas, seed=seed, window_size=window)
    ti = iter(t_sampler.InfiniteSampler(size, **kw))
    ji = iter(j_sampler.InfiniteSampler(size, **kw))
    assert [next(ti) for _ in range(500)] == [next(ji) for _ in range(500)]


def test_prefetch_loader_raises_a_worker_failure():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(i)

    loader = t_sampler.PrefetchLoader(Broken(), 2, list,
                                      t_sampler.InfiniteSampler(4),
                                      num_workers=2)
    try:
        with pytest.raises(RuntimeError, match="worker failed"):
            next(loader)
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_prefetch_loader_keeps_the_sampler_order_under_contention():
    """More worker threads than cores and a tiny switch interval: the
    batches are the sampler's indices, in order, and close() stops the
    workers and restores torch's thread count."""
    import os
    import sys
    import time

    class Slow:
        def __len__(self):
            return 37

        def __getitem__(self, i):
            time.sleep(0.0005 * (i % 3))
            return i

    threads = torch.get_num_threads()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sampler = t_sampler.InfiniteSampler(37, seed=4)
        loader = t_sampler.PrefetchLoader(Slow(), 4, list, sampler,
                                          num_workers=2 * (os.cpu_count() or 1))
        try:
            got = [i for _ in range(50) for i in next(loader)]
        finally:
            loader.close()
    finally:
        sys.setswitchinterval(interval)
    want = iter(sampler)
    assert got == [next(want) for _ in range(200)]
    assert not loader._thread.is_alive()
    assert torch.get_num_threads() == threads


# -------------------------------------------------------------- items

def _assert_item_close(ti, ji):
    for key in ("params", "obs_params", "t_params"):
        assert ti[key].keys() == ji[key].keys()
        for f in ti[key]:
            np.testing.assert_array_equal(np.asarray(ti[key][f]),
                                          np.asarray(ji[key][f]), err_msg=key)
    for key in ("obs_K", "obs_R", "obs_T"):
        np.testing.assert_array_equal(ti[key], ji[key], err_msg=key)
    for key in ("vertices", "obs_vertices", "t_vertices", "t_world_bounds"):
        np.testing.assert_allclose(ti[key], np.asarray(ji[key]), rtol=0,
                                   atol=2e-5, err_msg=key)
    for key in ("ray_o", "ray_d"):
        np.testing.assert_allclose(ti[key], ji[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    flips = ti["mask_at_box"] != ji["mask_at_box"]
    assert flips.mean() < 0.01
    np.testing.assert_array_equal(ti["bkgd_msk"], ti["mask_at_box"].astype(
        np.float32))
    for key in ("near", "far"):
        np.testing.assert_allclose(ti[key][~flips], ji[key][~flips], rtol=0,
                                   atol=1e-4, err_msg=key)
    for key in ("img", "obs_img"):
        assert ti[key].shape == ji[key].shape and ti[key].dtype == np.float32
        assert (np.abs(ti[key] - ji[key]) > 1e-4).mean() < 0.01, key


def _protocol_indices(n_views, protocol, obs_view=0, data_interval=2):
    """The indices run_eval renders of a 1-subject grid dataset."""
    out = []
    for k in range(POSE_NUM * n_views):
        view = k % n_views
        if protocol == "novel_view":
            if view != obs_view and view % data_interval == 0:
                out.append(k)
        elif k // n_views != 0 and view % data_interval == 0:
            out.append(k)
    return out


@pytest.mark.parametrize("protocol", ["novel_view", "novel_pose"])
def test_synthetic_grid_items_match_jax(smpls, protocol):
    js, ts = smpls
    kw = dict(resolution=512, image_scaling=SCALING, split="test",
              multi_person=False, num_instance=1, poses_start=0,
              poses_interval=1, poses_num=POSE_NUM)
    jd = j_syn.SyntheticHumanDataset("subject100", js, **kw)
    td = t_syn.SyntheticHumanDataset("subject100", ts, **kw)
    for d in (jd, td):
        d.obs_view_index = 0
        if protocol == "novel_pose":
            d.obs_pose_index = 2      # the 'reference' re-based quirk
    assert len(td) == len(jd) and td.H == jd.H == 32
    idx = _protocol_indices(td.camera_view_num, protocol)
    assert len(idx) == (8 if protocol == "novel_view" else 9)
    for k in idx:
        _assert_item_close(td[k], jd[k])
    np.testing.assert_allclose(td.t_vertices, jd.t_vertices, rtol=0, atol=2e-5)

    # multi-person training rig: subject bodies
    mk = dict(kw, multi_person=True, num_instance=3, split="train")
    jb = j_syn.SyntheticHumanDataset("subject0", js, **mk).subject_bodies()
    tb = t_syn.SyntheticHumanDataset("subject0", ts, **mk).subject_bodies()
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-5)


@pytest.mark.parametrize("subjects", [None, 1])
def test_synthetic_dataset_items_match_jax(smpls, subjects):
    js, ts = smpls
    kw = dict(H=32, W=32, poses_num=4, size=8, seed=3, subjects=subjects,
              subject_offset=100)
    jd = j_syn.SyntheticDataset(js, **kw)
    td = t_syn.SyntheticDataset(ts, **kw)
    assert len(td) == len(jd)
    for i in range(4):
        _assert_item_close(td[i], jax.device_get(jd[i]))


def test_collate_matches_jax(smpls):
    js, _ = smpls
    jd = j_syn.SyntheticHumanDataset("subject100", js, resolution=512,
                                     image_scaling=SCALING, split="test",
                                     multi_person=False, poses_num=2)
    items = [jd[0], jd[7]]
    jb = jax.device_get(j_base.collate(items))
    tb = t_base.collate(items, device="cpu")

    def fields(obj, prefix=""):
        import dataclasses
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                yield from fields(v, prefix + f.name + ".")
            else:
                yield prefix + f.name, v

    jf = dict(fields(jb))
    tf = dict(fields(tb))
    assert tf.keys() == jf.keys()
    for name, t in tf.items():
        j = np.asarray(jf[name])
        assert t.device.type == "cpu" and tuple(t.shape) == j.shape, name
        assert t.numpy().dtype == j.dtype, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


def test_host_smpl_verts_follow_their_model():
    """Models made and dropped in sequence each give their own vertices."""
    bp = t_smpl.big_pose_params()
    pose = np.random.RandomState(0).randn(72).astype(np.float32) * 0.2
    seen = []
    for seed in (0, 1, 0, 2):
        m = t_smpl.synthetic_smpl(seed, device="cpu")
        v, _ = t_base.host_smpl_verts(m, pose, bp["shapes"])
        with torch.no_grad():
            own = t_smpl.smpl_forward(m, torch.from_numpy(pose),
                                      torch.from_numpy(bp["shapes"]))[0]
        np.testing.assert_array_equal(v, own.numpy())
        seen.append(v)
        del m
        gc.collect()
    np.testing.assert_array_equal(seen[0], seen[2])
    assert np.abs(seen[0] - seen[1]).max() > 1e-3


@pytest.mark.parametrize("name", ["renderpeople", "thuman", "humman", "zju"])
def test_file_backed_loaders_raise(smpls, name):
    """The file-backed loaders are ported: without their files they raise
    at their first read (tests/test_torch_loaders.py drives them on trees
    that it writes)."""
    with pytest.raises(FileNotFoundError, match="/nonexistent"):
        t_data.DATASETS[name]("/nonexistent/subject0", smpls[1])
