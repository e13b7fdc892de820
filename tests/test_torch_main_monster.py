"""`main_monster_torch.py`, the port's dynamic-scene entry point, on the CPU:
TINY-width MASt3R and no-descriptor MonST3R checkpoints in the reference's
layout, nine 8x64 RGB frames (64x512 after the readers' resize) with a
calibration of their own, `config/dynamic_mask_test.yaml` (masking without
refinement, every fourth frame, both debug overlays on) and `--raft-checkpoint
random`, through `main(argv)` with `--device cpu --no-viz`. The export and the
overlays must be written and well-formed. The JAX-vs-port comparison of the
dynamic pipeline is tests/test_torch_pipeline_dynamic.py's; here the
entry point's plumbing, its refusals of SAM2 and its flow fallbacks."""

import argparse
import dataclasses
import pathlib

import cv2
import numpy as np
import pytest
import torch

import main_monster_torch
from monst3r_slam_torch.app.config import load_config
from monst3r_slam_torch.app.pipeline import SLAMSystem
from monst3r_slam_torch.dynamic import mask as dyn_mask
from monst3r_slam_torch.dynamic.inference import DualParams
from monst3r_slam_torch.models.config import MONST3R_512, TINY
from monst3r_slam_torch.models.convert import config_from_arch_string
from tests.test_torch_checkpoint import TINY_ARCH, tiny_state_dict, write_tiny_checkpoint
from tests.test_torch_slam import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
MONST3R_ARCH = (
    "AsymmetricCroCo3DStereo(pos_embed='RoPE100', patch_embed_cls='ManyAR_PatchEmbed', "
    "img_size=(512, 512), head_type='dpt', output_mode='pts3d', "
    "depth_mode=('exp', -inf, inf), conf_mode=('exp', 1, inf), enc_embed_dim=1024, "
    "enc_depth=24, enc_num_heads=16, dec_embed_dim=768, dec_depth=12, dec_num_heads=12)"
)


def write_tiny_monst3r_checkpoint(path, seed: int = 1):
    """A TINY-width MonST3R (DUSt3R-style: no descriptor head, one
    confidence) checkpoint in the reference's layout."""
    sd, _ = tiny_state_dict(seed)
    sd = {k: v for k, v in sd.items() if "head_local_features" not in k}
    arch = (TINY_ARCH.replace("AsymmetricMASt3R", "AsymmetricCroCo3DStereo")
            .replace("catmlp+dpt", "dpt").replace("pts3d+desc24", "pts3d")
            .replace(", two_confs=True, desc_conf_mode=('exp', 0, inf)", ""))
    torch.save({"args": argparse.Namespace(model=arch), "model": sd}, path)


def test_monst3r_arch_string_parses_to_monst3r_512():
    cfg = config_from_arch_string(MONST3R_ARCH)
    # without a descriptor head no head reads desc_conf_mode (the parser
    # copies conf_mode into it, as the JAX package's does)
    assert dataclasses.replace(cfg, desc_conf_mode=MONST3R_512.desc_conf_mode) == MONST3R_512
    assert MONST3R_512.desc_dim is None and not MONST3R_512.two_confs


def _write_frames(d: pathlib.Path, n: int = 9):
    d.mkdir()
    yy, xx = np.mgrid[0:8, 0:64].astype(np.float32)
    base = np.stack([np.sin(0.2 * xx), np.cos(0.6 * yy), np.sin(0.1 * (xx + yy))], -1)
    for i in range(n):
        img = np.uint8((np.roll(base, i, axis=1) * 0.5 + 0.5) * 255)
        cv2.imwrite(str(d / f"{i:04d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def test_main_monster_torch_writes_the_export_and_overlays(tmp_path, monkeypatch, capsys):
    seq = tmp_path / "seq"
    _write_frames(seq)
    mast3r, monst3r = tmp_path / "mast3r.pth", tmp_path / "monst3r.pth"
    write_tiny_checkpoint(mast3r)
    write_tiny_monst3r_checkpoint(monst3r)
    calib = tmp_path / "calib.yaml"
    calib.write_text("width: 64\nheight: 8\nfx: 60.0\nfy: 60.0\ncx: 32.0\ncy: 4.0\n")
    monkeypatch.chdir(tmp_path)  # logs/ lands under tmp_path
    try:
        slam, frame_ms = main_monster_torch.main([
            "--dataset", str(seq), "--config", str(ROOT / "config/dynamic_mask_test.yaml"),
            "--calib", str(calib), "--checkpoint", str(mast3r), "--monst3r-checkpoint",
            str(monst3r), "--raft-checkpoint", "random", "--save-as", "run", "--device", "cpu",
            "--no-viz",
        ])
        program = dyn_mask._flow_error_program
    finally:
        dyn_mask.set_flow_estimator(None)
        dyn_mask.set_flow_error_program(None)
    printed = capsys.readouterr().out
    assert "RAFT flow estimator installed (random init" in printed
    assert "using the native hysteresis+GrabCut refiner" in printed
    assert program[0] is not None and program[1]  # the fused program takes overlap_cb
    assert slam.dual is not None and slam.dual.monst3r_cfg.desc_dim is None
    assert slam.use_calib and slam.use_dynamic_mask and not slam.dyn_refine
    assert len(frame_ms) == 3  # every fourth of nine frames
    n_masked = len(slam.prof.get("mask_share", []))
    assert n_masked >= 1  # frame 1 is tracked with its mask

    out = tmp_path / "logs" / "run"
    full = np.atleast_2d(np.loadtxt(out / "seq_full.txt"))
    kf = np.atleast_2d(np.loadtxt(out / "seq.txt"))
    assert full.shape == (3, 8) and kf.shape == (slam.n_kf, 8) and np.isfinite(full).all()
    header, body = (out / "seq.ply").read_bytes().split(b"end_header\n", 1)
    assert len(body) == 15 * int(header.split(b"element vertex ")[1].split(b"\n")[0])
    assert len(list((out / "keyframes").glob("*.png"))) == slam.n_kf
    dbg = tmp_path / "logs" / "unknown_dataset" / "unknown_video"
    masks = sorted((dbg / "debug_dynamic_mask").glob("frame_*.png"))
    valid = sorted((dbg / "debug_final_valid_opt_mask").glob("frame_*_final_opt.png"))
    assert len(masks) == n_masked and len(valid) == n_masked
    assert cv2.imread(str(masks[0])).shape == (*slam.img_size, 3)


@pytest.mark.parametrize("setting", ["random", "file", "video"])
def test_main_monster_torch_refuses_sam2(tmp_path, setting):
    ckpt = tmp_path / "sam2.pt"
    ckpt.write_bytes(b"")
    cfg = tmp_path / "video.yaml"
    cfg.write_text(f"inherit: {ROOT / 'config/base.yaml'}\nsam2_video_predictor: true\n")
    argv = ["--dataset", str(tmp_path), "--device", "cpu", "--no-viz",
            "--sam2-checkpoint", {"random": "random", "file": str(ckpt)}.get(setting, "none.pt")]
    if setting == "video":
        argv += ["--config", str(cfg)]
    with pytest.raises(NotImplementedError, match="SAM2"):
        main_monster_torch.main(argv)


def test_install_flow_fallbacks(tmp_path, capsys):
    """A missing RAFT file falls back to OpenCV DIS and says so; a RAFT
    file that does not load raises."""
    try:
        dyn_mask.set_flow_error_program(lambda *a: None)
        main_monster_torch.install_flow(str(tmp_path / "missing.pth"), 0, "cpu")
        assert "falling back to OpenCV DIS" in capsys.readouterr().out
        assert dyn_mask._flow_error_program == (None, False) and dyn_mask._flow_estimator is None
        bad = tmp_path / "bad.pth"
        bad.write_bytes(b"not a checkpoint")
        with pytest.raises(Exception):
            main_monster_torch.install_flow(str(bad), 0, "cpu")
    finally:
        dyn_mask.set_flow_estimator(None)
        dyn_mask.set_flow_error_program(None)


def test_dual_system_refuses_the_pointmap_debug_dumps():
    dual = DualParams({}, dataclasses.replace(TINY, desc_dim=None, two_confs=False), {}, TINY)
    for key in ("debug_save_pointmap_visualization", "debug_save_3d_pointclouds"):
        cfg = load_config("config/base.yaml", set_global=False)
        cfg.update({"single_thread": True, key: True})
        with pytest.raises(NotImplementedError, match="pointmap debug dumps"):
            SLAMSystem(params={}, model_cfg=TINY, cfg=cfg, img_size=(64, 80), kf_capacity=2,
                       device="cpu", dual=dual)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_monster_torch_refuses_a_missing_card(tmp_path):
    with pytest.raises(SystemExit, match="no CUDA device"):
        main_monster_torch.main(["--dataset", str(tmp_path), "--no-viz"])
