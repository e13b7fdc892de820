"""The dynamic cell (`monst3r512-dynamic-oracle`) at TINY, SAM2_TEST and
RAFT at 3 iterations on the CPU (64x80 frames, 12-frame episodes, a window
of a few seconds) through everything but the look for a chip: the
contract's last line, the control put in the program's place, and each
fault that can be planted underneath the timed path; the cell's new
readers on a synthetic store and without a recorder; and its files' imports."""

import copy
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import cli, counts_dynamic, spans, trace_spans
from benchmark.tests.test_port_benchmark_cells import TINY, few_threads  # noqa: F401
from benchmark.tests.test_port_benchmark_imports import imported_top_names
from benchmark.tests.test_port_benchmark_spans import MS, Store, reader

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 23
DYN = "monst3r512-dynamic-oracle"
SPAN_METRICS = ("decode_device_ms.dyn", "flow_device_ms.dyn", "sam2_device_ms.dyn",
                "refine_host_ms.dyn")
NEW_FILES = ("harness/slam_dynamic_oracle.py", "harness/scene_dynamic.py",
             "harness/trace_spans.py", "harness/weights_dynamic.py", "harness/counts_dynamic.py",
             "reference/raft.py", "reference/sam2.py", "reference/dynamic_mask.py")


def overrides() -> dict:
    from monst3r_slam_torch.dynamic.sam2 import SAM2_TEST

    mcfg = json.loads((ROOT / "benchmark/configs/monst3r-slam-dyn512.json").read_text())["mast3r"]
    sam = {k: list(v) if isinstance(v, tuple) else v for k, v in SAM2_TEST._asdict().items()}
    tiny = {k: v for k, v in TINY.items() if k != "img_size"}
    return dict(
        config=dict(TINY, mast3r=dict(mcfg, **tiny), sam2=dict(sam, max_objects=8, iou_floor=0.3),
                    raft=dict(feature_dim=256, hidden_dim=128, context_dim=128, corr_levels=4,
                              corr_radius=4, iters=3, flow_out_std=0.003)),
        # the scene's texture at this size; kernel B's semantics through its
        # dispatch, which runs the plain version on CPU tensors
        traffic=dict(episode_frames=12, warmup_frames=4, trace_frames=2, check_frame_range=[2, 6],
                     rff_scale=1.5, slam_overrides={"matching": {"mode": "kernel"}}))


def run(trace: bool = False, control=None, seconds: float = 8.0) -> dict:
    return cli.run_cell(DYN, SEED, seconds, trace, "cpu", overrides=copy.deepcopy(overrides()),
                        control=control)


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_the_contract_line(trace, capsys):
    cli.emit(run(trace, seconds=16.0))  # an episode completes: `ate_pct`
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == {"decode_rel_rms", "decode_rel_max", "flow_rel_rms",
                                   "mask_flip", "sam2_rel_max", "sam2_flip", "mask_err",
                                   "match_gap", "track_gap"}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in cli.metrics_for(manifest, DYN, trace)}
    got = set(line["metrics"])
    if trace:  # no device trace on the CPU: the device-time readers have nothing to read
        assert got <= want and {"frame_ms.dyn", "mfu.dyn", "refine_host_ms.dyn"} <= got, got
    else:
        assert got == want == {"setup_s", "ate_pct"}, got
    assert "dynamic slam window" in captured.out


def test_the_control_is_not_correct():
    sys.path.insert(0, str(ROOT / "scripts"))
    import control_dynamic

    out = run(control=control_dynamic.CONTROL)
    assert out["correct"] is False, out["checks"]
    for name in ("decode_rel_max", "flow_rel_rms", "sam2_rel_max"):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"], name


def altered_flow(monkeypatch):
    from monst3r_slam_torch.dynamic import raft

    raft_flow = raft.raft_flow
    monkeypatch.setattr(raft, "raft_flow", lambda *a, **k: raft_flow(*a, **k) * 1.01)


def ego_motion_left_out(monkeypatch):
    from monst3r_slam_torch.dynamic import mask

    error_map = mask.flow_error_map
    monkeypatch.setattr(mask, "flow_error_map", lambda f, e: error_map(f, torch.zeros_like(e)))


def altered_sam2(monkeypatch):
    from monst3r_slam_torch.dynamic import sam2

    decoder = sam2.mask_decoder

    def shifted(*args, **kwargs):
        masks, iou, tok = decoder(*args, **kwargs)
        return masks + 0.05 * masks.abs().max(), iou, tok

    monkeypatch.setattr(sam2, "mask_decoder", shifted)


def altered_monst3r(monkeypatch):
    from monst3r_slam_torch.models import mast3r

    decode = mast3r.decode

    def altered(params, cfg, *args, **kwargs):
        out = decode(params, cfg, *args, **kwargs)
        if cfg.desc_dim is not None:
            return out
        X1 = out.X1.clone()
        X1[:, 0, 0] = 10 * X1.abs().max()
        return out._replace(X1=X1)

    monkeypatch.setattr(mast3r, "decode", altered)


def unmasked(monkeypatch):
    from monst3r_slam_torch.dynamic import mask

    monkeypatch.setattr(mask, "apply_dynamic_mask_native", lambda C, D, Q, m: (C, D, Q))


@pytest.mark.parametrize("fault", [altered_flow, ego_motion_left_out, altered_sam2,
                                   altered_monst3r, unmasked])
def test_a_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run()
    assert out["correct"] is False, out["checks"]


def test_the_planted_fault_of_the_control_script_is_not_correct():
    out = run(control={"fault": "unmasked"})
    assert out["correct"] is False
    assert out["checks"]["mask_err"]["value"] > 0.05  # about the object's share


def dyn_store():
    """Six frames (a warm-up frame, two in the window, the traced run's
    first frame, which starts the profiler, and two traced frames): each
    frame's decode with its two decodes and its flow program, a
    `mask_refine` with a `sam2` child."""
    st = Store()
    for fid in range(6):
        t = 1000 * fid
        f = st.span("frame", t, t + 900, rid=fid)
        d = st.span("decode", t, t + 600, f)
        st.span("decode_monst3r", t, t + 100, d, device_ms=90.0 + fid)
        st.span("flow_program", t + 100, t + 150, d, device_ms=100.0 + fid)
        st.span("decode_mast3r", t + 150, t + 250, d, device_ms=95.0 + fid)
        r = st.span("mask_refine", t + 250, t + 580, d)
        st.span("sam2", t + 300, t + 360, r, device_ms=40.0 + fid)
        st.count("sam2.calls", 1, t + 300)
    return st


def dyn_launched():
    """The traced frames' device operations, (launch, start, end) in ms:
    two overlapping ones from `decode_monst3r` (60 ms of device time), one
    from `flow_program`, one from `decode_mast3r` that runs after its span
    has closed, one from `sam2`, and one launched outside every span."""
    rows = []
    for fid in (4, 5):
        t = 1000 * fid
        rows += [(t + 10, t + 30, t + 60 + fid), (t + 20, t + 50, t + 90),
                 (t + 120, t + 130, t + 170 + fid), (t + 160, t + 260, t + 300 + fid),
                 (t + 310, t + 400, t + 430 + fid), (t + 700, t + 700, t + 800)]
    a = np.array(rows, np.int64) * MS
    return dict(launch=a[:, 0], start=a[:, 1], end=a[:, 2])


def test_the_readers_on_a_synthetic_store(monkeypatch):
    monkeypatch.setattr(spans, "store", dyn_store)
    run_ = dict(frames=2, traced_frames=2, launched=dyn_launched())
    got = {name: reader(name)(run_) for name in SPAN_METRICS}
    # the device times are those of the traced frames 4 and 5: 60 + 44 and
    # 60 + 45 ms of decodes, flows of 44 and 45, SAM2 calls of 34 and 35
    assert got["decode_device_ms.dyn"] == pytest.approx(104.5)
    assert got["flow_device_ms.dyn"] == pytest.approx(44.5)
    assert got["sam2_device_ms.dyn"] == pytest.approx(34.5)
    # the host time is the window's, frames 1 and 2
    assert got["refine_host_ms.dyn"] == pytest.approx(330.0 - 60.0)
    tr = dict(busy_s=0.3, launches=60000, window_s=1.0)
    run_t = dict(frames=10, traced_frames=2, window_s=5.0, trace=tr)
    assert reader("launches_per_frame.dyn")(run_t) == pytest.approx(30000.0)
    assert reader("device_idle.dyn")(run_t) == pytest.approx(70.0)
    assert reader("frame_ms.dyn")(run_t) == pytest.approx(500.0)


class Event:
    """A raw profiler event, as `kineto_results.events()` gives them."""

    def __init__(self, name, s, e, corr, tid=0, device=False):
        self.n, self.s, self.e, self.corr, self.tid, self.device = name, s, e, corr, tid, device

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def correlation_id(self):
        return self.corr

    def start_thread_id(self):
        return self.tid

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.device else torch.autograd.DeviceType.CPU


def test_launches_are_tied_to_the_marker_thread():
    """Each device operation is tied by its correlation id to the runtime
    call that launched it; only the marker's thread's, from the window's
    start on, are kept."""
    ev = [Event("cudaLaunchKernel", 5, 6, 1, tid=7), Event("spin_kernel", 8, 9, 1, device=True),
          Event("cudaLaunchKernel", 20, 21, 2, tid=7), Event("gemm", 30, 40, 2, device=True),
          Event("cudaLaunchKernel", 22, 23, 3, tid=9), Event("gemm", 41, 50, 3, device=True),
          Event("cudaMemcpyAsync", 24, 25, 4, tid=7), Event("Memcpy DtoH", 50, 55, 4,
                                                             device=True)]
    got = trace_spans.launched_ops(ev, (4, 7), 10)
    assert got["launch"].tolist() == [20, 24]
    assert got["start"].tolist() == [30, 50] and got["end"].tolist() == [40, 55]
    assert trace_spans.busy_ms(dict(launch=np.array([0, 1, 2]), start=np.array([0, 5, 20]) * MS,
                                    end=np.array([10, 12, 30]) * MS), 0, 1) == 12.0
    # no marker in the window given, or launched by two threads: nothing to tie
    assert trace_spans.launched_ops(ev, (100, 200), 10) is None
    ev.append(Event("cudaLaunchKernel", 5, 6, 5, tid=9))
    ev.append(Event("spin_kernel", 9, 10, 5, device=True))
    assert trace_spans.launched_ops(ev, (4, 7), 10) is None


def test_no_recorder_no_number(monkeypatch):
    """A program without the recorder, a run without a trace that ties
    launches to threads (the CPU), or a program without the spans (a
    checkout before the SAM2 span)."""
    monkeypatch.setattr(spans, "store", lambda: None)
    for name in SPAN_METRICS:
        assert reader(name)(dict(frames=2, traced_frames=2, launched=dyn_launched())) is None
    monkeypatch.setattr(spans, "store", dyn_store)
    for name in SPAN_METRICS[:3]:
        assert reader(name)(dict(frames=2, traced_frames=2, launched=None)) is None
    st = dyn_store()
    st.rows = [s for s in st.rows if s.name not in ("sam2", "decode_monst3r", "flow_program")]
    monkeypatch.setattr(spans, "store", lambda: st)
    for name in SPAN_METRICS:
        assert reader(name)(dict(frames=2, traced_frames=2, launched=dyn_launched())) is None
    assert reader("mfu.dyn")(dict(counted=None)) is None
    assert reader("launches_per_frame.dyn")(dict(trace=None, traced_frames=2)) is None


def test_the_flop_counts_match_torchs_counter():
    """`counts_dynamic` against `torch.utils.flop_counter` on the CPU, RAFT
    at 64x80 and SAM2 at SAM2_TEST: within 2% (the counter adds a few
    products the shape count leaves out: the upsampling's combination is
    elementwise here and a matmul there)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.harness import weights_dynamic
    from benchmark.reference import raft as ref_raft
    from benchmark.reference import sam2 as ref_sam2
    from monst3r_slam_torch.dynamic.sam2 import SAM2_TEST

    rc = dict(feature_dim=256, hidden_dim=128, context_dim=128, corr_levels=4, corr_radius=4,
              iters=3, flow_out_std=0.003)
    params = weights_dynamic.raft_params(rc, 1, "cpu")
    img = torch.rand((64, 80, 3)) * 255
    with FlopCounterMode(display=False) as fc:
        ref_raft.flow(params, rc, img, img)
    assert counts_dynamic.raft_flops(rc, 64, 80) == pytest.approx(fc.get_total_flops(), rel=0.02)
    sc = dict(SAM2_TEST._asdict(), max_objects=3)
    sp = weights_dynamic.sam2_params(sc, 1, "cpu")
    with FlopCounterMode(display=False) as fc:
        emb = ref_sam2.encode(sp, sc, torch.rand((1, 128, 128, 3)))
    assert counts_dynamic.sam2_encode_flops(sc) == pytest.approx(fc.get_total_flops(), rel=0.02)
    with FlopCounterMode(display=False) as fc:
        ref_sam2.decode(sp, sc, *emb, torch.rand((3, 1, 2)), torch.ones((3, 1), dtype=torch.long))
    assert counts_dynamic.sam2_decode_flops(sc, 3) == pytest.approx(fc.get_total_flops(),
                                                                   rel=0.02)


def test_the_new_files_import_no_jax_and_the_references_no_program():
    for rel in NEW_FILES:
        names = imported_top_names(ROOT / "benchmark" / rel)
        assert not names & set(cli.FORBIDDEN), rel
        if rel.startswith("reference/"):
            assert names <= {"__future__", "math", "torch", "benchmark"}, (rel, names)


def test_the_configuration_file_states_its_cut_and_precisions():
    cfg = json.loads((ROOT / "benchmark/configs/monst3r-slam-dyn512.json").read_text())
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in manifest["configs"]}["monst3r-slam-dyn512"]
    assert cfg["reduced"] == entry["reduced"] == [] and len(entry["source"]) <= 200
    assert cfg["desc_dim"] is None and cfg["mast3r"]["desc_dim"] == 24
    assert set(cfg["precision"]) == {"monst3r", "mast3r", "raft", "mask", "sam2"}
    assert cfg["raft"]["iters"] == 20 and cfg["sam2"]["img_size"] == 1024
    from monst3r_slam_torch.dynamic.sam2 import SAM2_BASE_PLUS

    assert all((tuple(v) if isinstance(v, list) else v) == getattr(SAM2_BASE_PLUS, k)
               for k, v in cfg["sam2"].items() if k in SAM2_BASE_PLUS._fields)
    assert cfg["mask"] == {"threshold": 0.35, "min_area": 20, "temporal_propagation": True}
