"""The port's user scripts against the JAX package's, run as subprocesses
as a user runs them.

* `scripts/eval_ate_torch.py` and `scripts/eval_ate.py` (JAX on the CPU) on
  TUM files written from a seed print the same `ate_rmse` line, with and
  without scale, and both write the plot.
* `scripts/demo_pair_torch.py --device cpu` and `scripts/demo_pair.py` on
  one TINY checkpoint (`write_tiny_checkpoint`) and two oracle frames,
  which both resize to 384x512. With the model in f32 on both sides (each
  script run with its package's encode and decode defaulting to f32), the
  files have the same keys, dtypes and shapes, `valid` is equal, and
  `idx_1_to_2` equal on all but 1e-4 of the pixels: random TINY pointmaps
  reach ~6e4, and ~1e-6 relative differences move the ray search on a few
  pixels (11 of 196,608 measured); the PLY headers and colours are equal
  and the points within 1e-4 of their scale. As shipped (bf16), the port's
  script writes the same keys, dtypes and shapes.
* `scripts/run_real_torch.sh --synthetic --device cpu --max-frames 3` runs
  the whole drill and prints its stitching line.
"""

import os
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import torch

from monst3r_slam_torch.utils import oracle as toracle
from tests.test_torch_checkpoint import write_tiny_checkpoint

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(args, env=None, timeout=300):
    out = subprocess.run(args, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                         env={**os.environ, "JAX_PLATFORMS": "cpu", **(env or {})})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _write_tum(path, t, xyz, quat):
    rows = [f"{a:.6f} " + " ".join(f"{v:.6f}" for v in (*p, *q)) for a, p, q in zip(t, xyz, quat)]
    path.write_text("# timestamp tx ty tz qx qy qz qw\n" + "\n".join(rows) + "\n")


def test_eval_ate_torch_prints_eval_ates_line(tmp_path):
    rng = np.random.default_rng(0)
    n = 40
    t = np.arange(n) / 30.0
    gt = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    # the estimate: a scaled, rotated, shifted copy with noise, on a
    # slightly offset clock with one frame missing
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = 1.7 * gt @ R.T + [0.5, -0.2, 1.0] + rng.normal(0, 0.01, (n, 3))
    _write_tum(tmp_path / "gt.txt", t, gt, q)
    keep = np.arange(n) != 7
    _write_tum(tmp_path / "est.txt", t[keep] + 0.004, est[keep], q[keep])
    for extra in ([], ["--no-scale"]):
        lines = []
        for script in ("scripts/eval_ate.py", "scripts/eval_ate_torch.py"):
            plot = tmp_path / f"{pathlib.Path(script).stem}{len(extra)}.png"
            out = _run([sys.executable, script, "--gt", str(tmp_path / "gt.txt"),
                        "--est", str(tmp_path / "est.txt"), "--save-plot", str(plot), *extra])
            lines.append([ln for ln in out.splitlines() if ln.startswith("ate_rmse")])
            assert plot.stat().st_size > 0
        assert len(lines[0]) == 1 and lines[1] == lines[0], lines
        assert "(39 matched poses)" in lines[0][0]


_F32 = """
import functools, runpy, sys
import {np} as xnp
import {pkg}.models.mast3r as m
m.encode = functools.partial(m.encode, dtype=xnp.float32)
m.decode = functools.partial(m.decode, dtype=xnp.float32)
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _ply(path):
    data = path.read_bytes()
    i = data.index(b"end_header\n") + len(b"end_header\n")
    rec = np.frombuffer(data[i:], dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                        ("r", "u1"), ("g", "u1"), ("b", "u1")])
    return data[:i], np.stack([rec[c] for c in "xyz"], -1), np.stack([rec[c] for c in "rgb"], -1)


def test_demo_pair_torch_matches_demo_pair(tmp_path):
    ckpt = tmp_path / "tiny.pth"
    write_tiny_checkpoint(ckpt)
    imgs = []
    for i, T in enumerate(toracle.gt_trajectory(2, step=0.12)):
        img = toracle.render_image(torch.from_numpy(T), 96, 128, 0.6 * 128, 0.6 * 128)[0].numpy()
        u8 = np.clip(np.round((img + 1.0) * 127.5), 0, 255).astype(np.uint8)
        imgs.append(str(tmp_path / f"f{i}.png"))
        cv2.imwrite(imgs[-1], cv2.cvtColor(u8, cv2.COLOR_RGB2BGR))
    common = ["--img1", imgs[0], "--img2", imgs[1], "--checkpoint", str(ckpt)]
    outs = {}
    for name, script, pkg, np_mod, extra in (
            ("jax", "scripts/demo_pair.py", "monst3r_slam_tpu", "jax.numpy", []),
            ("torch", "scripts/demo_pair_torch.py", "monst3r_slam_torch", "torch",
             ["--device", "cpu"])):
        outs[name] = tmp_path / name
        stdout = _run([sys.executable, "-c", _F32.format(np=np_mod, pkg=pkg), script, *common,
                       "--out", str(outs[name]), *extra])
        assert "match fraction" in stdout
    stdout = _run([sys.executable, "scripts/demo_pair_torch.py", *common, "--device", "cpu",
                   "--out", str(tmp_path / "bf16")])
    assert "pointmaps: (1, 384, 512, 3)" in stdout

    ja, ta = np.load(outs["jax"] / "matches.npz"), np.load(outs["torch"] / "matches.npz")
    assert sorted(ta.files) == sorted(ja.files) == ["conf1", "conf2", "idx_1_to_2", "valid"]
    for other in (ta, np.load(tmp_path / "bf16" / "matches.npz")):
        for k in ja.files:
            assert other[k].dtype == ja[k].dtype and other[k].shape == ja[k].shape, k
    assert ja["idx_1_to_2"].shape == (1, 384 * 512)
    np.testing.assert_array_equal(ta["valid"], ja["valid"])
    assert (ta["idx_1_to_2"] != ja["idx_1_to_2"]).mean() < 1e-4
    for k in ("conf1", "conf2"):
        np.testing.assert_allclose(ta[k], ja[k], atol=1e-4 * np.abs(ja[k]).max())
    jh, jx, jc = _ply(outs["jax"] / "pair.ply")
    th, tx, tc = _ply(outs["torch"] / "pair.ply")
    assert th == jh and np.array_equal(tc, jc)
    np.testing.assert_allclose(tx, jx, atol=1e-4 * np.abs(jx).max())


def test_run_real_torch_synthetic_completes():
    out = _run(["bash", "scripts/run_real_torch.sh", "--synthetic", "--device", "cpu",
                "--max-frames", "3"], timeout=600)
    assert "SYNTHETIC smoke: stitching OK" in out, out
    assert "ate_rmse" in out and "(3 matched poses)" in out
