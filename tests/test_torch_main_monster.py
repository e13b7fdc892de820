"""`main_monster_torch.py`, the port's dynamic-scene entry point, on the CPU:
TINY-width MASt3R and no-descriptor MonST3R checkpoints in the reference's
layout, nine 8x64 RGB frames (64x512 after the readers' resize) with a
calibration of their own, `config/dynamic_mask_test.yaml` (masking without
refinement, every fourth frame, both debug overlays on) and `--raft-checkpoint
random`, through `main(argv)` with `--device cpu --no-viz`. The export and the
overlays must be written and well-formed. The JAX-vs-port comparison of the
dynamic pipeline is tests/test_torch_pipeline_dynamic.py's; here the
entry point's plumbing, its SAM2 installs and its flow fallbacks."""

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


def _sam2_run(tmp_path, monkeypatch, setting, n_frames=5, extra=""):
    """main_monster_torch.main on the CPU with TINY checkpoints, random RAFT,
    the calibration, base.yaml's refinement under the temporal propagator
    and the SAM2 `setting`; returns (slam, the installed refiner, stdout
    lines). A synthetic checkpoint file is read at SAM2_TEST / VIDEO_TEST
    width (the CLI reads a file at Hiera-B+ width, 80 M weights: here its
    configs are patched to the test ones, which the file is made at)."""
    from monst3r_slam_torch.dynamic import sam2 as sam2_mod
    from monst3r_slam_torch.dynamic import sam2_video as sam2v

    seq = tmp_path / "seq"
    _write_frames(seq, n_frames)
    mast3r, monst3r = tmp_path / "mast3r.pth", tmp_path / "monst3r.pth"
    write_tiny_checkpoint(mast3r)
    write_tiny_monst3r_checkpoint(monst3r)
    calib = tmp_path / "calib.yaml"
    calib.write_text("width: 64\nheight: 8\nfx: 60.0\nfy: 60.0\ncx: 32.0\ncy: 4.0\n")
    cfg = tmp_path / "cfg.yaml"
    video = setting.startswith("video")
    cfg.write_text(f"inherit: {ROOT / 'config/base.yaml'}\nsingle_thread: True\n"
                   f"sam2_video_predictor: {video}\n"
                   f"sam2_carry_memory: {setting == 'video_carry'}\n{extra}")
    ckpt = "random"
    if setting in ("file", "video_file"):
        monkeypatch.setattr(sam2_mod, "SAM2_BASE_PLUS", sam2_mod.SAM2_TEST)
        monkeypatch.setattr(sam2v, "VIDEO_BASE_PLUS", sam2v.VIDEO_TEST)
        gen = torch.Generator().manual_seed(5)
        sd = sam2_state_dict(sam2_mod.init_sam2_params(gen, sam2_mod.SAM2_TEST),
                             sam2v.init_video_params(gen, sam2_mod.SAM2_TEST, sam2v.VIDEO_TEST))
        ckpt = str(tmp_path / "sam2.pt")
        torch.save({"model": sd}, ckpt)
    monkeypatch.chdir(tmp_path)
    try:
        slam, _ = main_monster_torch.main([
            "--dataset", str(seq), "--config", str(cfg), "--calib", str(calib), "--checkpoint",
            str(mast3r), "--monst3r-checkpoint", str(monst3r), "--raft-checkpoint", "random",
            "--sam2-checkpoint", ckpt, "--device", "cpu", "--no-viz"])
        refiner = dyn_mask._mask_refiner
    finally:
        dyn_mask.set_flow_estimator(None)
        dyn_mask.set_flow_error_program(None)
        dyn_mask.set_mask_refiner(None)
    return slam, refiner


def sam2_state_dict(params, vparams) -> dict:
    """An official-layout SAM2 state dict of the port's image and video
    parameters (the reverse of `sam2_params_from_torch` and
    `video_params_from_torch`)."""
    from tests.test_sam2 import _fabricate_torch_sd
    from tests.test_torch_sam2_video import _video_sd

    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(np_tree(v) for v in t)
        return t.numpy()

    return _video_sd(np_tree(vparams), _fabricate_torch_sd(np_tree(params), None))


@pytest.mark.parametrize("setting", ["random", "file", "video", "video_carry", "video_file"])
def test_main_monster_torch_installs_sam2(tmp_path, monkeypatch, capsys, setting):
    """Wherever main_monster_slam.py installs SAM2: `random` (SAM2_TEST from
    --seed + 3, the video weights from --seed + 4) and a checkpoint file, as
    the image refiner or, with `sam2_video_predictor`, the video refiner with
    or without `sam2_carry_memory`. The refiner runs on the masked frames."""
    from monst3r_slam_torch.dynamic import sam2 as sam2_mod
    from monst3r_slam_torch.dynamic import sam2_video as sam2v

    slam, refiner = _sam2_run(tmp_path, monkeypatch, setting)
    printed = capsys.readouterr().out
    video = setting.startswith("video")
    kind = "SAM2 VIDEO-predictor refiner" if video else "SAM2 refiner"
    origin = f"from {tmp_path / 'sam2.pt'}" if setting.endswith("file") else "(random init"
    assert f"{kind} installed {origin}" in printed
    assert slam.dyn_refine and slam._mask_propagator is not None
    if video:
        assert isinstance(refiner, sam2v.Sam2VideoRefiner)
        assert refiner.pred.cfg == sam2_mod.SAM2_TEST and refiner.pred.vcfg == sam2v.VIDEO_TEST
        assert refiner.carry_memory == (setting == "video_carry")
        params = refiner.pred.params
    else:
        assert isinstance(refiner, sam2_mod.Sam2Refiner) and refiner.cfg == sam2_mod.SAM2_TEST
        params = refiner.params
    assert refiner.calls >= 1 and len(slam.prof["mask_share"]) >= 1
    if setting == "random":  # SAM2_TEST from --seed + 3 (--seed 0)
        want = sam2_mod.init_sam2_params(torch.Generator().manual_seed(3), sam2_mod.SAM2_TEST)
        assert torch.equal(params["trunk"]["patch_embed"]["w"], want["trunk"]["patch_embed"]["w"])
    if setting == "video":  # VIDEO_TEST from --seed + 4
        want = sam2v.init_video_params(torch.Generator().manual_seed(4), sam2_mod.SAM2_TEST,
                                       sam2v.VIDEO_TEST)
        assert torch.equal(refiner.pred.vparams["no_obj_ptr"], want["no_obj_ptr"])
    if setting == "video_carry":
        # the bank outlives the call, its consumed image dropped
        assert refiner._state is not None and refiner._state["images"][-1] is None


@pytest.mark.parametrize("bf16_params", [True, False])
def test_main_monster_torch_computes_in_bf16_on_the_cpu(tmp_path, monkeypatch, bf16_params):
    """As `main_monster_slam.py` on every device: both models compute in
    bf16, and `bf16_params` (base.yaml: on) stores their weights in bf16."""
    slam, refiner = _sam2_run(tmp_path, monkeypatch, "random", n_frames=2,
                              extra=f"bf16_params: {bf16_params}\n")
    assert slam.dtype == torch.bfloat16
    want = torch.bfloat16 if bf16_params else torch.float32
    for params in (slam.dual.mast3r, slam.dual.monst3r):
        assert params["enc_blocks"][0]["attn"]["qkv"]["w"].dtype == want
        assert params["head1"]["dpt"]["head"]["conv3"]["w"].dtype == want


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
