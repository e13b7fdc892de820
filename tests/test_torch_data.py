"""The port's host data path against the JAX package's, on the same inputs:

* datasets (`data/datasets.py`): TUM and RGB-folder datasets written under
  tmp_path give the same files, timestamps, shapes and frames in both
  packages, the same resized normalized images, and with `use_calib` the
  same undistortion and frame intrinsics (tests/test_datasets.py:37-72);
* prefetch (`data/prefetch.py`): order and payload, an error surfacing at
  the consumer, stop from another thread (tests/test_prefetch.py), and the
  upload preprocess's payload;
* export and evaluation (`app/evaluate.py`): the TUM trajectory writers, the
  PLY writers and the keyframe PNGs write byte-identical files, and
  ate_rmse / umeyama / associate / load_tum_trajectory agree to 1e-9.
"""

import threading
import time

import numpy as np
import pytest
import torch

from monst3r_slam_tpu.app import evaluate as jeval
from monst3r_slam_tpu.app.config import config as jconfig
from monst3r_slam_tpu.app.config import load_config as jload_config
from monst3r_slam_tpu.data import datasets as jds
from monst3r_slam_tpu.data.preprocess import resize_img as jresize
from monst3r_slam_torch.app import evaluate as teval
from monst3r_slam_torch.app.config import config as tconfig
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.data import datasets as tds
from monst3r_slam_torch.data.prefetch import FramePrefetcher, uploading_preprocess
from monst3r_slam_torch.data.preprocess import resize_img as tresize
from tests.test_datasets import _write_img, make_tum
from tests.test_prefetch import FakeDataset


@pytest.fixture(autouse=True)
def base_cfg():
    jload_config("config/base.yaml")
    tload_config("config/base.yaml")
    yield
    jconfig["use_calib"] = tconfig["use_calib"] = False


def _same_dataset(jd, td):
    assert type(td).__name__ == type(jd).__name__
    assert [str(p) for p in td.rgb_files] == [str(p) for p in jd.rgb_files]
    assert list(td.timestamps) == list(jd.timestamps)
    assert td.get_img_shape() == jd.get_img_shape()
    for i in range(len(jd)):
        (jt, jimg), (tt, timg) = jd[i], td[i]
        assert tt == jt
        np.testing.assert_array_equal(timg, jimg)
        jr, tr = jresize(jimg, jd.img_size), tresize(timg, td.img_size)
        for key in ("img", "true_shape", "unnormalized_img"):
            np.testing.assert_array_equal(tr[key], jr[key])


def test_tum_folder_matches_jax(tmp_path):
    d = make_tum(tmp_path)
    jd, td = jds.load_dataset(str(d)), tds.load_dataset(str(d))
    assert isinstance(td, tds.TUMDataset) and not td.has_calib()
    _same_dataset(jd, td)
    jd.subsample(2), td.subsample(2)
    _same_dataset(jd, td)


def test_rgb_folder_matches_jax(tmp_path):
    # (load_dataset dispatches on path parts: this test's name must not hold "tum")
    rgb = tmp_path / "mydir"
    rgb.mkdir()
    for i in [2, 10, 1]:  # natural sort
        _write_img(rgb / f"frame{i}.png", seed=i)
    jd, td = jds.load_dataset(str(rgb)), tds.load_dataset(str(rgb))
    assert isinstance(td, tds.RGBFiles)
    assert [p.name for p in td.rgb_files] == ["frame1.png", "frame2.png", "frame10.png"]
    _same_dataset(jd, td)


def test_tum_calibration_matches_jax(tmp_path):
    d = make_tum(tmp_path)
    jconfig["use_calib"] = tconfig["use_calib"] = True
    jd, td = jds.TUMDataset(str(d)), tds.TUMDataset(str(d))
    assert td.has_calib() and td.use_calibration
    for name in ("K", "K_frame", "mapx", "mapy"):
        np.testing.assert_array_equal(getattr(td.camera_intrinsics, name),
                                      getattr(jd.camera_intrinsics, name))
    _same_dataset(jd, td)  # frames undistorted by the same maps


def test_prefetch_order_payload_error_and_stop():
    got = list(FramePrefetcher(FakeDataset(7), lambda img: int(img[0, 0, 0]), hi=5))
    assert [i for i, _, _ in got] == list(range(5))
    assert [v for _, _, v in got] == list(range(5))
    assert got[3][1] == pytest.approx(3 / 30.0)

    it = iter(FramePrefetcher(FakeDataset(6, fail_at=3), lambda img: img))
    assert next(it)[0] == 0
    with pytest.raises(RuntimeError, match="frame 3"):
        for _ in range(5):
            next(it)

    pf = FramePrefetcher(FakeDataset(4, delay=0.5), lambda img: img, depth=1)
    t = threading.Thread(target=lambda: list(pf))
    t.start()
    time.sleep(0.1)
    pf.stop()
    t.join(timeout=5.0)
    assert not t.is_alive(), "consumer still blocked after a stop() from another thread"


def test_uploading_preprocess_payload():
    img = np.random.default_rng(0).uniform(0, 1, (48, 64, 3)).astype(np.float32)
    out = uploading_preprocess(lambda x: tresize(x, 512), "cpu")(img)
    ref = jresize(img, 512)
    np.testing.assert_array_equal(out["img"], ref["img"])
    assert out["img_dev"].dtype == torch.float32 and out["img_dev"].device.type == "cpu"
    np.testing.assert_array_equal(out["img_dev"].numpy(), ref["img"])


def test_export_writers_are_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    n_kf, hw = 3, 40
    taus = rng.normal(size=(n_kf, 7)) * 0.3
    from monst3r_slam_tpu.core import lie as jlie
    T = np.stack([np.asarray(jlie.sim3_exp(t.astype(np.float32))) for t in taus])
    X = rng.normal(size=(n_kf, hw, 3)).astype(np.float32) + [0, 0, 3]
    C = rng.uniform(0.5, 3.0, (n_kf, hw, 1)).astype(np.float32)
    cols = rng.uniform(0, 1, (n_kf, hw, 3)).astype(np.float32)
    stamps = [f"{1305031790.0 + 0.033 * i:.6f}" for i in range(6)]
    kf_ids = np.array([0, 2, 5])
    for name, mod in (("j", jeval), ("t", teval)):
        d = tmp_path / name
        mod.save_traj(d, "kf.txt", stamps, T, kf_ids)
        mod.save_full_traj(d, "full.txt", stamps[:n_kf], T)
        mod.save_ply(d / "cloud.ply", X[0], cols[0])
        mod.save_reconstruction(d, "recon.ply", T, X, C, cols, conf_threshold=1.5)
        mod.save_keyframes(d / "keyframes", stamps, kf_ids,
                           [cols[i].reshape(5, 8, 3) for i in range(n_kf)])
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert len(files) == 4 + n_kf
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f

    jt, jxyz, jq = jeval.load_tum_trajectory(tmp_path / "j" / "full.txt")
    tt, txyz, tq = teval.load_tum_trajectory(tmp_path / "t" / "full.txt")
    for a, b in ((tt, jt), (txyz, jxyz), (tq, jq)):
        np.testing.assert_array_equal(a, b)


def test_ate_and_alignment_match_jax():
    rng = np.random.default_rng(3)
    t = np.arange(20, dtype=np.float64)
    xyz = np.cumsum(rng.standard_normal((20, 3)), axis=0)
    gt = 1.7 * xyz @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T + [3.0, -2.0, 1.0]
    gt = gt + 0.05 * rng.standard_normal(gt.shape)
    t_gt = t + rng.uniform(-0.01, 0.01, t.shape)
    for with_scale in (True, False):
        (jr, jn), (tr, tn) = (m.ate_rmse(t, xyz, t_gt, gt, with_scale=with_scale)
                              for m in (jeval, teval))
        assert tn == jn == 20 and abs(tr - jr) <= 1e-9
        js, jR, jtr = jeval.umeyama_alignment(xyz, gt, with_scale)
        ts, tR, ttr = teval.umeyama_alignment(xyz, gt, with_scale)
        assert abs(ts - js) <= 1e-9
        np.testing.assert_allclose(tR, jR, atol=1e-9)
        np.testing.assert_allclose(ttr, jtr, atol=1e-9)
    for a, b in zip(teval.associate(t, t_gt[::2], 0.02), jeval.associate(t, t_gt[::2], 0.02)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        teval.ate_rmse(t[:2], xyz[:2], t[:2], gt[:2])
