"""`main_easier_torch.py`, the port's Easi3R entry point, on the CPU, and the
live viewer of the three port CLIs.

* Against `main_easier_slam.py`, the reference CLI: both run `--no-viz` on
  three 8x64 RGB frames (64x512 after the readers' resize) with the same
  TINY-width MASt3R checkpoint and no-descriptor (DUSt3R-architecture)
  Easi3R checkpoint in the reference's layout, `config/base.yaml` as shipped
  (async backend), both computing in bf16 with bf16 weights. The exports
  must be well-formed and agree: the same keyframes, and the keyframe and
  full trajectories within 1e-3 (random weights lose every frame after the
  first on both sides, so the poses stay the first frame's).
* Without `--no-viz` each port CLI starts a `LiveViewer` (here on a free
  port from the system), prints the reference's line, attaches the viewer
  to its SLAMSystem, and stops it at the end; a `terminate` queued after the
  first snapshot ends the run before the second frame, and the export is
  still written.
"""

import pathlib
import sys

import cv2
import numpy as np
import pytest
import torch

import main_easier_torch
import main_monster_torch
import main_torch
from monst3r_slam_torch.dynamic import mask as dyn_mask
from monst3r_slam_torch.viz import live
from tests.test_torch_checkpoint import write_tiny_checkpoint
from tests.test_torch_main_monster import write_tiny_monst3r_checkpoint
from tests.test_torch_slam import close_backend_workers, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_FRAMES = 3


def _write_frames(d: pathlib.Path):
    d.mkdir()
    yy, xx = np.mgrid[0:8, 0:64].astype(np.float32)
    base = np.stack([np.sin(0.2 * xx), np.cos(0.6 * yy), np.sin(0.1 * (xx + yy))], -1)
    for i in range(N_FRAMES):
        img = np.uint8((np.roll(base, i, axis=1) * 0.5 + 0.5) * 255)
        cv2.imwrite(str(d / f"{i:04d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("easier")
    _write_frames(d / "seq")
    write_tiny_checkpoint(d / "mast3r.pth")
    write_tiny_monst3r_checkpoint(d / "easi3r.pth")
    return d


def _flags(d: pathlib.Path, *extra):
    return ["--dataset", str(d / "seq"), "--checkpoint", str(d / "mast3r.pth"),
            "--easi3r-checkpoint", str(d / "easi3r.pth"), *extra]


def _export(out: pathlib.Path):
    kf = np.atleast_2d(np.loadtxt(out / "seq.txt"))
    full = np.atleast_2d(np.loadtxt(out / "seq_full.txt"))
    header, body = (out / "seq.ply").read_bytes().split(b"end_header\n", 1)
    assert len(body) == 15 * int(header.split(b"element vertex ")[1].split(b"\n")[0])
    assert len(list((out / "keyframes").glob("*.png"))) == len(kf)
    assert np.isfinite(kf).all() and np.isfinite(full).all()
    return kf, full


def test_main_easier_torch_matches_main_easier_slam(inputs, tmp_path, monkeypatch, capsys):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    monkeypatch.chdir(port_dir)
    common = ("--config", str(ROOT / "config/base.yaml"), "--save-as", "run", "--no-viz")
    slam, frame_ms = main_easier_torch.main(_flags(inputs, *common, "--device", "cpu"))
    assert slam.easi3r is not None and slam.easi3r.easi3r_cfg.desc_dim is None
    assert slam.easi3r.k_mad == 2.0 and not slam.use_dynamic_mask and slam.viewer is None
    assert slam.dtype == torch.bfloat16
    assert slam.easi3r.easi3r["enc_blocks"][0]["attn"]["qkv"]["w"].dtype == torch.bfloat16
    assert slam._worker is not None and len(frame_ms) == N_FRAMES

    import main_easier_slam

    monkeypatch.chdir(ref_dir)
    monkeypatch.setattr(sys, "argv", ["main_easier_slam.py", *_flags(inputs, *common)])
    main_easier_slam.main()
    printed = capsys.readouterr().out
    assert printed.count("loaded checkpoint") == 4  # two per CLI

    kf, full = _export(port_dir / "logs" / "run")
    kf_ref, full_ref = _export(ref_dir / "logs" / "run")
    assert full.shape == full_ref.shape == (N_FRAMES, 8)
    np.testing.assert_array_equal(kf[:, 0], kf_ref[:, 0])  # the same keyframes
    np.testing.assert_allclose(kf, kf_ref, atol=1e-3)
    np.testing.assert_allclose(full, full_ref, atol=1e-3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_easier_torch_refuses_a_missing_card(tmp_path):
    with pytest.raises(SystemExit, match="no CUDA device"):
        main_easier_torch.main(["--dataset", str(tmp_path), "--no-viz"])


class _TerminatingViewer(live.LiveViewer):
    """A LiveViewer on a free port that queues `terminate` after its first
    snapshot, as the page's terminate button would."""

    instances = []

    def start(self, port: int = 8089):
        _TerminatingViewer.instances.append(self)
        return super().start(port=0)

    def update(self, *a, **k):
        super().update(*a, **k)
        self.push_control({"terminate": True})


def _cli(name, d: pathlib.Path):
    if name == "main_torch":
        return main_torch.main, ["--dataset", str(d / "seq"), "--checkpoint", str(d / "mast3r.pth")]
    if name == "main_monster_torch":
        return main_monster_torch.main, [
            "--dataset", str(d / "seq"), "--checkpoint", str(d / "mast3r.pth"),
            "--monst3r-checkpoint", str(d / "easi3r.pth"), "--raft-checkpoint",
            str(d / "missing.pth"), "--sam2-checkpoint", str(d / "missing.pt")]
    return main_easier_torch.main, _flags(d)


@pytest.mark.parametrize("name", ["main_torch", "main_monster_torch", "main_easier_torch"])
def test_cli_attaches_the_viewer_and_stops_on_terminate(inputs, tmp_path, monkeypatch, capsys,
                                                        name):
    monkeypatch.setattr(live, "LiveViewer", _TerminatingViewer)
    monkeypatch.chdir(tmp_path)
    _TerminatingViewer.instances.clear()
    main, argv = _cli(name, inputs)
    try:
        slam, frame_ms = main([*argv, "--config", str(ROOT / "config/base.yaml"), "--save-as",
                               "run", "--device", "cpu"])
    finally:
        dyn_mask.set_flow_estimator(None)
        dyn_mask.set_flow_error_program(None)
        dyn_mask.set_mask_refiner(None)
    printed = capsys.readouterr().out
    (viewer,) = _TerminatingViewer.instances
    assert f"live viewer: http://127.0.0.1:{viewer.port}/ (disable with --no-viz)" in printed
    assert "terminated from viewer" in printed and slam.terminate_requested
    assert slam.viewer is viewer and viewer._server is None  # stopped at the end
    assert viewer._seq == 1 and len(frame_ms) == 1  # terminated before the second frame
    kf, full = _export(tmp_path / "logs" / "run")
    assert full.shape == (1, 8) and len(kf) == 1
