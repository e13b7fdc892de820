"""`main_torch.py`, the port's entry point, on the CPU: a 3-frame RGB folder
and a synthetic TINY-width checkpoint in the reference's layout, run with
`config/base.yaml` as shipped (async backend, `solver: auto`, a
bootstrapping retrieval database) through `main(argv)` with `--device cpu
--no-viz`. The export must be written and well-formed (TUM keyframe and
full trajectories, a binary PLY, one PNG per keyframe), and the trajectory
must equal that of the port's SLAMSystem driven directly on the same frames
with the same weights, both in bf16 as `main.py` computes on every device.
The JAX-vs-port comparison of the pipeline is the
oracle twins' (tests/test_torch_slam.py and the tests beside it)."""

import pathlib

import cv2
import numpy as np
import pytest
import torch

import main_torch
from monst3r_slam_torch.app.config import load_config
from monst3r_slam_torch.app.pipeline import SLAMSystem
from monst3r_slam_torch.data.datasets import load_dataset
from monst3r_slam_torch.data.preprocess import resize_img
from monst3r_slam_torch.models.convert import cast_params_for_inference, load_checkpoint
from monst3r_slam_torch.slam import retrieval
from tests.test_torch_checkpoint import write_tiny_checkpoint
from tests.test_torch_slam import close_backend_workers, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_FRAMES = 3


def _write_frames(d: pathlib.Path):
    """Three 8x64 frames of one smooth pattern, shifted a pixel each. The
    readers resize the long side to 512, so these become 64x512 frames: as
    many pixels as 8 of the twins' 64x80 frames, a ninth of 384x512."""
    d.mkdir()
    yy, xx = np.mgrid[0:8, 0:64].astype(np.float32)
    base = np.stack([np.sin(0.2 * xx), np.cos(0.6 * yy), np.sin(0.1 * (xx + yy))], -1)
    for i in range(N_FRAMES):
        img = np.uint8((np.roll(base, i, axis=1) * 0.5 + 0.5) * 255)
        cv2.imwrite(str(d / f"{i:04d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def _drive_directly(dataset_dir: pathlib.Path, ckpt: pathlib.Path):
    """The SLAMSystem of `main_torch.run`, driven frame by frame by hand, in
    bf16 with the weights cast (base.yaml's `bf16_params`) as the CLI runs."""
    cfg = load_config(str(ROOT / "config/base.yaml"))
    params, model_cfg = load_checkpoint(str(ckpt))
    params = cast_params_for_inference(params)
    dataset = load_dataset(str(dataset_dir))
    slam = SLAMSystem(
        params=params, model_cfg=model_cfg, cfg=dict(cfg),
        img_size=tuple(dataset.get_img_shape()[0]),
        retrieval_params=retrieval.init_retrieval_params(
            torch.Generator().manual_seed(1), model_cfg.enc_dim, device="cpu"),
        retrieval_db=retrieval.ASMKDatabase.from_config(cfg), device="cpu",
    )
    for i in range(N_FRAMES):
        ts, img = dataset[i]
        out = resize_img(img, dataset.img_size)
        slam.process_frame(i, ts, out["img"], uimg=out["unnormalized_img"])
    slam.finalize()
    return slam


def test_main_torch_writes_the_export(tmp_path, monkeypatch):
    seq = tmp_path / "seq"
    _write_frames(seq)
    ckpt = tmp_path / "tiny.pth"
    write_tiny_checkpoint(ckpt)
    monkeypatch.chdir(tmp_path)  # logs/ lands under tmp_path
    slam, frame_ms = main_torch.main([
        "--dataset", str(seq), "--config", str(ROOT / "config/base.yaml"),
        "--checkpoint", str(ckpt), "--save-as", "run", "--device", "cpu", "--no-viz",
    ])
    assert slam._worker is not None and slam.host_solve and slam.retrieval_db is not None
    assert len(frame_ms) == N_FRAMES

    out = tmp_path / "logs" / "run"
    kf = np.atleast_2d(np.loadtxt(out / "seq.txt"))
    full = np.atleast_2d(np.loadtxt(out / "seq_full.txt"))
    assert kf.shape == (slam.n_kf, 8) and full.shape == (N_FRAMES, 8)
    assert np.isfinite(full).all() and np.isfinite(kf).all()
    np.testing.assert_allclose(np.linalg.norm(full[:, 4:8], axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(full[:, 0], np.arange(N_FRAMES) / 30.0, atol=1e-6)
    ply = (out / "seq.ply").read_bytes()
    header, body = ply.split(b"end_header\n", 1)
    n_vert = int(header.split(b"element vertex ")[1].split(b"\n")[0])
    assert header.startswith(b"ply\nformat binary_little_endian 1.0\n")
    assert len(body) == n_vert * 15  # x, y, z float32 and r, g, b uchar
    pngs = sorted((out / "keyframes").glob("*.png"))
    assert len(pngs) == slam.n_kf
    h, w = slam.img_size
    assert cv2.imread(str(pngs[0])).shape == (h, w, 3)

    ref = _drive_directly(seq, ckpt)
    np.testing.assert_array_equal(slam.full_trajectory()[1], ref.full_trajectory()[1])
    for a, b in zip(slam.keyframe_trajectory(), ref.keyframe_trajectory()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bf16_params", [True, False])
def test_main_torch_computes_in_bf16_on_the_cpu(tmp_path, monkeypatch, bf16_params):
    """As `main.py` on every device: the model computes in bf16, and
    `bf16_params` (base.yaml: on) stores its weights in bf16."""
    seq = tmp_path / "seq"
    _write_frames(seq)
    ckpt = tmp_path / "tiny.pth"
    write_tiny_checkpoint(ckpt)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"inherit: {ROOT / 'config/base.yaml'}\nbf16_params: {bf16_params}\n"
                   "single_thread: True\n")
    monkeypatch.chdir(tmp_path)
    slam, _ = main_torch.main(["--dataset", str(seq), "--config", str(cfg), "--checkpoint",
                               str(ckpt), "--max-frames", "1", "--device", "cpu", "--no-viz"])
    assert slam.dtype == torch.bfloat16
    weights = {slam.params["enc_blocks"][0]["attn"]["qkv"]["w"].dtype,
               slam.params["head1"]["dpt"]["head"]["conv3"]["w"].dtype}
    assert weights == {torch.bfloat16 if bf16_params else torch.float32}
    assert slam.params["enc_blocks"][0]["attn"]["qkv"]["b"].dtype == torch.float32


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_torch_refuses_a_missing_card(tmp_path):
    """`--device cuda` (the default) fails without a card: no fallback."""
    with pytest.raises(SystemExit, match="no CUDA device"):
        main_torch.main(["--dataset", str(tmp_path), "--no-viz"])
