"""Chunked tracking in the port (`monst3r_slam_torch/app/chunked.py`,
`SLAMSystem.process_chunk`) against the port's own per-frame path with
`defer_tracking_sync: 0`, which tests/test_torch_slam.py and
tests/test_torch_slam_model.py hold to the JAX package's per-frame path.
(JAX's chunked path is no oracle: its keyframe tests fail on the reference
tree, and after a synchronous keyframe event it keeps the tracked pose where
its per-frame path reads the solved one back.)

TINY tied weights from the port's own draw, f32, 32x48 frames, the gates
open. Each scenario asserts the same decisions (modes, keyframes at the same
frames, relocalization attempts, the same number of poses) and the poses,
keyframe poses and keyframe pointmaps within 1e-6 (measured equal: both
paths run the same operations in the same order on the CPU), and the same
Gauss-Newton iterations frame by frame in the recorder's `track.gn_iters`
(counted at the chunk's read, and in the per-frame loop):

* no event: two chunks of 4, one host read each;
* a keyframe at every second frame (each synthetic frame twice, gate 0.9):
  events inside chunks, the done flag and re-dispatches from k0;
* a keyframe at every frame, 7 frames in chunks of 4: the short tail chunk;
* uint8 chunks normalized on the device, bit for bit the host formula;
* a scene cut inside a chunk: RELOC there and the per-frame fallback after.

Also the `supports_chunking` gate, `ChunkPrefetcher`'s order, short tail
and error, and the tracker's masked fixed-iteration GN loop (the chunk's,
with no host read) against its per-frame loop, equal bit for bit.
"""

import numpy as np
import pytest
import torch

from monst3r_slam_torch.app import chunked
from monst3r_slam_torch.app.config import load_config
from monst3r_slam_torch.app.pipeline import SLAMSystem
from monst3r_slam_torch.dynamic.inference import DualParams
from monst3r_slam_torch.models.config import TINY
from monst3r_slam_torch.models.init import init_params
from monst3r_slam_torch.slam import tracker
from monst3r_slam_torch.slam.frame import Mode
from monst3r_slam_torch.utils import timing
from tests.test_pipeline import synth_video
from tests.test_torch_slam import one_torch_thread  # noqa: F401

H, W = 32, 48


@pytest.fixture(scope="module")
def params():
    p = init_params(torch.Generator().manual_seed(0), TINY)
    p["dec_blocks2"], p["head2"] = p["dec_blocks"], p["head1"]
    return p


def smooth(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = sum(np.sin(rng.uniform(0.05, 0.3) * xx[..., None] + rng.uniform(0.05, 0.3)
                     * yy[..., None] + rng.uniform(0, 6.3, 3)) for _ in range(6))
    return (img / np.abs(img).max()).astype(np.float32)


def _cfg(**tracking):
    c = load_config("config/base.yaml", set_global=False)
    c["single_thread"] = True
    c["tracking"].update(Q_conf=0.0, C_conf=0.0, min_match_frac=0.0)
    c["local_opt"].update(Q_conf=0.0, min_match_frac=0.0, solver="device")
    c["parallel"] = {"mesh": "off"}
    c["tracking"].update(tracking)
    return c


def _make(params, cfg, **kw):
    return SLAMSystem(params=params, model_cfg=TINY, cfg=cfg, img_size=(H, W), kf_capacity=16,
                      device="cpu", dtype=torch.float32, **kw)


def _u8(frames):
    return [np.clip((f * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8) for f in frames]


def _run_perframe(params, cfg, frames):
    s = _make(params, cfg)
    modes = []
    for i, img in enumerate(frames):
        s.process_frame(i, i / 30.0, img)
        modes.append(int(s.mode))
    s.finalize()
    return s, modes


def _run_chunked(params, cfg, frames, chunk):
    s = _make(params, cfg)
    modes = []
    for c0 in range(0, len(frames), chunk):
        sl = frames[c0 : c0 + chunk]
        ids = list(range(c0, c0 + len(sl)))
        assert s.process_chunk(ids, [i / 30.0 for i in ids], torch.from_numpy(np.stack(sl)),
                               uimgs=sl if sl[0].dtype == np.uint8 else None)
        modes.append(int(s.mode))
    s.finalize()
    return s, modes


SCENARIOS = {
    "no_event": (lambda: [smooth(0)] * 8, dict(match_frac_thresh=0.0), 4),
    "events_in_chunks": (lambda: [f for f in synth_video(5, H, W) for _ in (0, 1)],
                         dict(match_frac_thresh=0.9), 4),
    "short_tail": (lambda: synth_video(7, H, W), dict(match_frac_thresh=0.9), 4),
    "uint8": (lambda: _u8([f for f in synth_video(4, H, W) for _ in (0, 1)]),
              dict(match_frac_thresh=0.9), 3),
    "reloc": (lambda: [smooth(0)] * 4 + [smooth(5)] * 4,
              dict(match_frac_thresh=0.0, min_match_frac=0.3), 4),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_chunked_decides_as_the_perframe_path(params, name):
    make_frames, tracking, chunk = SCENARIOS[name]
    frames = make_frames()
    host = frames
    if frames[0].dtype == np.uint8:  # the per-frame path takes the host's normalization
        host = [(u.astype(np.float32) / 255.0 - 0.5) / 0.5 for u in frames]
    timing.reset()
    ref, ref_modes = _run_perframe(params, _cfg(**tracking), host)
    ref_iters = [c.n for c in timing.counts("track.gn_iters")]
    timing.reset()
    got, got_modes = _run_chunked(params, _cfg(**tracking), frames, chunk)
    assert [c.n for c in timing.counts("track.gn_iters")] == ref_iters and ref_iters
    assert got_modes == ref_modes[chunk - 1 :: chunk] + ([ref_modes[-1]] if len(frames) % chunk
                                                         else [])
    assert got.frame_ids == ref.frame_ids == list(range(len(frames)))
    n = ref.n_kf
    assert got.n_kf == n and got.mem.frame_id[:n].tolist() == ref.mem.frame_id[:n].tolist()
    assert got.n_reloc_attempts == ref.n_reloc_attempts and got.mode == ref.mode
    assert got.graph.edge_list() == ref.graph.edge_list()
    np.testing.assert_allclose(np.stack(got.frame_poses), np.stack(ref.frame_poses), atol=1e-6)
    np.testing.assert_allclose(got.mem.T_WC[:n].numpy(), ref.mem.T_WC[:n].numpy(), atol=1e-6)
    np.testing.assert_allclose(got.mem.X_canon[:n].numpy(), ref.mem.X_canon[:n].numpy(),
                               atol=1e-6)
    reads = len(got.prof["chunk_sync"])
    if name == "no_event":
        assert n == 1 and reads == 2  # one host read per event-free chunk
    elif name == "reloc":
        assert ref.n_reloc_attempts == 3 and ref_modes[4:] == [int(Mode.RELOC)] * 4
    else:
        assert n >= len(frames) // 2 and reads > len(frames) // chunk  # events re-dispatch


def test_decode_hook_replaces_each_enqueued_frames_decode(params):
    """`decode_hook(out, hook_x)` replaces a frame's decode outputs inside the
    dispatch (a test's way in): called for each frame the dispatch enqueues
    (those after an event too, whose updates the done flag freezes) with
    that frame's `hook_xs` entry, and its outputs are what the chunk tracks
    on."""
    seen = []

    def hook(out, hook_x):
        seen.append(int(hook_x))
        return out._replace(C1=out.C1 * 0.0)  # no confidence: every match gated out

    s = _make(params, _cfg(match_frac_thresh=0.0, min_match_frac=0.05))
    frames = np.stack([smooth(0)] * 4)
    assert s.process_chunk([0, 1, 2, 3], [0.0, 0.1, 0.2, 0.3], torch.from_numpy(frames),
                           hook_xs=torch.arange(10, 14), decode_hook=hook)
    assert seen == [11, 12, 13]  # frame 0 initializes per frame, one dispatch enqueues 1-3
    # frame 1 loses tracking on the zeroed C1; 2 and 3 relocalize per frame
    assert s.mode == Mode.RELOC and s.n_reloc_attempts == 2 and len(s.prof["chunk_sync"]) == 1


def test_uint8_chunks_normalize_on_the_device_as_the_host_does():
    u8 = np.stack(_u8(synth_video(3, H, W)))
    u8[0, 0, :4, 0] = [0, 1, 254, 255]
    for i in range(3):
        dev = chunked._norm_slice(torch.from_numpy(u8), i)[0].numpy()
        host = (u8[i].astype(np.float32) / 255.0 - 0.5) / 0.5  # data/preprocess.py's formula
        assert dev.dtype == np.float32
        np.testing.assert_array_equal(dev, host)
    f = torch.from_numpy(host[None])
    assert chunked._norm_slice(f, 0).data_ptr() == f.data_ptr()  # normalized input passes


def test_supports_chunking_gate(params):
    lm = _make(params, {**_cfg(), "matching": {"mode": "lm"}})
    assert not lm.supports_chunking
    with pytest.raises(RuntimeError, match="chunked tracking requires"):
        lm.process_chunk([0], [0.0], torch.zeros((1, H, W, 3)))
    dual = _make({}, _cfg(), dual=DualParams({}, TINY, {}, TINY))
    assert not dual.supports_chunking
    assert _make(params, {**_cfg(), "use_dynamic_mask": True}).supports_chunking


class _Frames:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == 99:
            raise OSError("unreadable frame")
        return i / 30.0, np.full((H, W, 3), i, np.uint8)


def test_chunk_prefetcher_order_and_tail():
    pre = chunked.ChunkPrefetcher(_Frames(7), lambda img: {"unnormalized_img": img}, chunk=3,
                                  device="cpu")
    got = list(pre)
    assert [ids for ids, *_ in got] == [[0, 1, 2], [3, 4, 5], [6]]
    for ids, tss, imgs, uimgs in got:
        assert tss == [i / 30.0 for i in ids] and imgs.dtype == torch.uint8
        assert imgs.shape == (len(ids), H, W, 3) and imgs[:, 0, 0, 0].tolist() == ids
        assert [int(u[0, 0, 0]) for u in uimgs] == ids
    pre = chunked.ChunkPrefetcher(_Frames(101), lambda img: {"unnormalized_img": img}, chunk=4,
                                  lo=96, device="cpu")
    with pytest.raises(RuntimeError, match="chunk prefetch failed at frame 99"):
        list(pre)
    pre.stop()


@pytest.mark.parametrize("use_calib", [False, True])
def test_masked_gn_loop_equals_the_perframe_loop(use_calib):
    """`fixed_iters` runs all `max_iters` steps with no host read; once the
    stop rule fires, its steps keep the pose: the result equals the
    per-frame loop's, which stops there."""
    rng = np.random.default_rng(0)
    hw = H * W
    Xk = torch.from_numpy(rng.uniform(-1, 1, (hw, 3)).astype(np.float32) + np.float32([0, 0, 3]))
    Xf = Xk + 0.01 * torch.from_numpy(rng.standard_normal((hw, 3)).astype(np.float32))
    T_WCf = torch.tensor([0.02, -0.01, 0.03, 0.0, 0.0, 0.01, 1.0, 1.02])
    T_WCf[3:7] /= T_WCf[3:7].norm()
    K = torch.tensor([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    args = (torch.arange(hw), torch.ones((hw, 1), dtype=torch.bool), torch.full((hw, 1), 2.0),
            torch.full((hw, 1), 2.0), Xf, torch.full((hw, 1), 2.0), Xk, torch.full((hw, 1), 2.0),
            T_WCf, torch.tensor([0, 0, 0, 0, 0, 0, 1.0, 1.0]), K)
    for max_iters in (2, 50):
        cfg = tracker.TrackingConfig(max_iters=max_iters)
        a = tracker.track_pose(cfg, (H, W), use_calib, *args)
        b = tracker.track_pose(cfg, (H, W), use_calib, *args, fixed_iters=True)
        assert torch.equal(a.T_WCf, b.T_WCf) and torch.equal(a.T_CkCf, b.T_CkCf)
        assert bool(a.solver_failed) == bool(b.solver_failed) and int(b.iters) == a.iters
        assert a.iters == 2 if max_iters == 2 else a.iters < max_iters  # 50: stopped early
