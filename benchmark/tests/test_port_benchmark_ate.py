"""The trajectory error's alignment and pooling on known trajectories."""

import math

import numpy as np
import pytest

from benchmark.reference import ate


def path(n: int, seed: int) -> np.ndarray:
    t = np.linspace(0, 1, n)
    rng = np.random.default_rng(seed)
    return np.stack([3 * t, np.sin(4 * t), 0.2 * t**2], -1) + 0.01 * rng.standard_normal((n, 3))


def similarity(x: np.ndarray) -> np.ndarray:
    a = 0.7
    R = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
    return 2.5 * x @ R.T + np.array([1.0, -2.0, 0.5])


def test_a_similarity_of_the_ground_truth_has_no_error():
    gt = path(50, 0)
    assert ate.align_errors(similarity(gt), gt).max() < 1e-9


def test_known_errors_survive_the_alignment():
    gt = path(200, 1)
    err = np.zeros_like(gt)
    err[::2, 2], err[1::2, 2] = 0.01, -0.01  # zero mean, orthogonal to the path's span
    e = ate.align_errors(similarity(gt + err), gt)
    assert np.sqrt(np.mean(e**2)) == pytest.approx(0.01, rel=0.05)
    assert ate.episode_pct(similarity(gt + err), gt) == pytest.approx(
        100 * 0.01 / ate.extent(gt), rel=0.05)


def test_each_episode_of_the_mix_weighs_the_same():
    gts = [path(40, 2), path(40, 3)]
    noisy = []
    for k, (gt, s) in enumerate(zip(gts, (0.01, 0.03))):
        err = np.zeros_like(gt)
        err[::2, 2], err[1::2, 2] = s, -s
        noisy.append((k, gt + err, gt))
    one_each = ate.mix_pct(noisy)
    # replaying episode 0 twice more leaves the mix's error as it was
    assert ate.mix_pct(noisy + [noisy[0], noisy[0]]) == pytest.approx(one_each, rel=1e-9)
    rel = [np.sqrt(np.mean(ate.align_errors(e, g) ** 2)) / ate.extent(g) for _, e, g in noisy]
    assert one_each == pytest.approx(100 * np.sqrt(np.mean(np.square(rel))), rel=1e-9)
