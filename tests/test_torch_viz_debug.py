"""Twins of the JAX package's pointmap debug dumps (`viz/debug.py`) in the
port: on the same numpy inputs each dump writes the same PNG bytes as the
reference module's (same figure, same matplotlib, no metadata that differs
between the two calls), under the same file names. The mask overlay's bytes
are held by tests/test_torch_dynamic.py."""

import numpy as np
import pytest

from monst3r_slam_tpu.viz import debug as jdbg
from monst3r_slam_torch.viz import debug as tdbg


def _scene(h=24, w=32):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((h, w, 3)).astype(np.float32) + [0, 0, 3]
    C = rng.uniform(0.5, 3.0, (h, w)).astype(np.float32)
    mask = np.zeros((h, w), bool)
    mask[8:16, 10:20] = True
    Xm = X.copy()
    Cm = C.copy()
    Cm[mask] = 0.0
    Xm[mask] = 0.0
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    return X, C, Xm, Cm, mask, img


def _same_files(jpaths, tpaths):
    for jp, tp in zip(jpaths, tpaths):
        assert tp.name == jp.name and tp.stat().st_size > 0
        assert tp.read_bytes() == jp.read_bytes(), tp.name


def test_pointmap_visualization_writes_the_references_png(tmp_path):
    X, C, Xm, Cm, *_ = _scene()
    j = jdbg.save_pointmap_visualization(X, C, Xm, Cm, 7, tmp_path / "jax")
    t = tdbg.save_pointmap_visualization(X, C, Xm, Cm, 7, tmp_path / "port")
    assert [p.name for p in t] == ["pointmap_frame_000007.png", "pointmap_diff_frame_000007.png"]
    _same_files(j, t)


def test_confidence_overlay_writes_the_references_png(tmp_path):
    _, C, _, _, mask, img = _scene()
    for frame_img in (img, (img * 255).astype(np.uint8)):
        j = jdbg.save_confidence_overlay(C, mask, frame_img, 3, tmp_path / "jax")
        t = tdbg.save_confidence_overlay(C, mask, frame_img, 3, tmp_path / "port")
        _same_files([j], [t])


@pytest.mark.parametrize("max_points", [100, 10000])
def test_3d_pointcloud_comparison_writes_the_references_png(tmp_path, max_points):
    X, C, Xm, Cm, *_ = _scene()
    j = jdbg.save_3d_pointcloud_comparison(X, C, Xm, Cm, 5, tmp_path / "jax",
                                           max_points=max_points)
    t = tdbg.save_3d_pointcloud_comparison(X, C, Xm, Cm, 5, tmp_path / "port",
                                           max_points=max_points)
    _same_files([j], [t])
