"""Runs of each cell at TINY on the CPU (64x80 frames, a window of a few
seconds) through everything but the look for a chip: the contract's last
line, the control put in the program's place, and each fault that a cell
can have planted in the program underneath the timed path. The limits are
the cells' own."""

import copy
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import cli

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345  # more than 32 signed bits hold
SLAM = "mast3r512-slam-oracle"
TRAIN = "monst3r512-train-384x512-b12"
TINY = dict(enc_depth=4, enc_dim=64, enc_heads=4, dec_depth=4, dec_dim=48, dec_heads=4,
            feature_dim=32, last_dim=16, layer_dims=[16, 24, 32, 48], img_size=[64, 80])
OVERRIDES = {
    # kernel B's semantics through its dispatch, which runs the plain version
    # on CPU tensors; 12-frame episodes; the scene's texture at this size
    SLAM: dict(config=TINY, traffic=dict(
        episode_frames=12, warmup_frames=4, trace_frames=3, check_frame_range=[2, 6],
        rff_scale=1.5, slam_overrides={"matching": {"mode": "kernel"}})),
    TRAIN: dict(config=TINY, traffic=dict(batch=2, pool_batches=4, trace_steps=1, ref_rows=1)),
}
SECONDS = {SLAM: 9.0, TRAIN: 3.0}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload: str, trace: bool = False, control=None) -> dict:
    return cli.run_cell(workload, SEED, SECONDS[workload], trace, "cpu",
                        overrides=copy.deepcopy(OVERRIDES[workload]), control=control)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", [SLAM, TRAIN])
def test_a_run_prints_the_contract_line(workload, trace, capsys):
    cli.emit(run(workload, trace))
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in cli.metrics_for(manifest, workload, trace)}
    got = set(line["metrics"])
    if trace:  # no device on the CPU: the trace's readers have nothing to read
        assert got <= want and got, got
        assert set(line["device"]) >= {"busy_s", "window_s"} and "breakdown" in line
    else:
        assert got == want, (got, want)
    for name, c in line["checks"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in captured.err
    assert captured.err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("workload", [SLAM, TRAIN])
def test_the_control_is_not_correct(workload):
    import benchmark.control as control

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = {w["name"]: w["traffic"] for w in manifest["workloads"]}[workload]
    kind = json.loads((ROOT / "benchmark" / "traffic" / f"{traffic}.json").read_text())["kind"]
    out = run(workload, control=control.CONTROLS[kind])
    assert out["correct"] is False, out["checks"]


def unchanged_pose(monkeypatch):
    from monst3r_slam_torch.core import lie
    from monst3r_slam_torch.slam import tracker

    track_pose = tracker.track_pose

    @functools.wraps(track_pose)
    def stuck(*args, **kwargs):
        T_WCf, T_WCk = args[11:13]  # the frame's pose estimate and the keyframe's
        res = track_pose(*args, **kwargs)
        return res._replace(T_WCf=T_WCf, T_CkCf=lie.sim3_rel(T_WCk, T_WCf))

    monkeypatch.setattr(tracker, "track_pose", stuck)


def altered_match(monkeypatch):
    from monst3r_slam_torch.ops import matching_tiled

    tile_match = matching_tiled.tile_match

    def altered(*args, **kwargs):
        u, v, conv = tile_match(*args, **kwargs)
        u = u.clone()
        u[0, 0] = u[0, 0] + 3 if u[0, 0] < 40 else u[0, 0] - 3
        return u, v, conv

    monkeypatch.setattr(matching_tiled, "tile_match", altered)


def altered_decode(monkeypatch):
    from monst3r_slam_torch.models import mast3r

    decode = mast3r.decode

    def altered(*args, **kwargs):
        out = decode(*args, **kwargs)
        X1 = out.X1.clone()
        X1[:, 0, 0] = 10 * X1.abs().max()
        return out._replace(X1=X1)

    monkeypatch.setattr(mast3r, "decode", altered)


def unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def half_batch(monkeypatch):
    from monst3r_slam_torch.train import step

    loss_fn = step.loss_fn

    def half(params, cfg, batch, *args, **kwargs):
        n = batch["img1"].shape[0] // 2
        return loss_fn(params, cfg, {k: v[:n] for k, v in batch.items()}, *args, **kwargs)

    monkeypatch.setattr(step, "loss_fn", half)


@pytest.mark.parametrize("workload, fault", [
    (SLAM, unchanged_pose), (SLAM, altered_match), (SLAM, altered_decode),
    (TRAIN, unchanged_state), (TRAIN, half_batch)])
def test_a_fault_under_the_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = run(workload)
    assert out["correct"] is False, out["checks"]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """The entry exits with another code than 0 and prints no result on a
    machine without the cell's CUDA devices, and in a directory that holds
    only BENCHMARK.json and the benchmark's own files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", SLAM, "--seed",
                              str(SEED), "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [SLAM, TRAIN])
def test_a_short_run_on_the_card(workload, cuda):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                          str(SEED), "--seconds", "5", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
