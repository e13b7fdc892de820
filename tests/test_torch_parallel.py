"""Twins of the JAX package's multi-device mesh on the SLAM path in the port
(`monst3r_slam_torch/parallel/`, `backend.gauss_newton_sharded`, the mesh
branch of `SLAMSystem`).

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py), as its
own tests do; the port's mesh is a grid of 8 entries of `cpu`
(`make_mesh(devices=[cpu] * 8)`: dp 4, tp 2), which splits the work into
the same shards and sums them the same way. Inputs come from numpy seeds
and JAX's TINY weights go through `params_from_jax`.

Tolerances:
* mesh shapes and `param_spec` (JAX's spec moved through the converter's
  layout change): exact;
* the sharded edge decode against the port's unsharded decode: equal in
  bf16, within 2e-4 / 1e-3 in f32 (the matmuls of a smaller batch sum in
  another order: measured 2.2e-5); and against JAX's sharded decode: in bf16 (JAX's
  `sharded_edge_decode` decodes at its bf16 default) within twice JAX's
  own bf16 distance from its f32 decode, per output, the bound of the bf16
  model twin (tests/test_torch_models_bf16.py; measured 0.73-1.55 times
  that distance, up to 0.35 on pointmaps of scale 10, so JAX's 2e-2 for
  its sharded-against-unsharded decode cannot hold across the two
  packages); and in f32 (JAX's decode patched to f32) within 2e-4 / 1e-3;
* the dual decode on two devices: within 2e-4 / 1e-3 of JAX's
  (tests/test_parallel.py's tolerance), in f32 on both sides: JAX's decode
  is patched to f32 for the test, since the port's bf16 model is held to
  JAX's bf16 only within twice JAX's own bf16 distance
  (tests/test_torch_models_bf16.py);
* the sharded Gauss-Newton: within 1e-4 of JAX's sharded solve and of the
  port's unsharded one (tests/test_torch_backend.py's tolerance);
* SLAMSystem under `parallel.mesh: auto` (JAX) and the port's 8-entry mesh,
  in f32 on both sides (JAX's encode and decode patched to f32, which keeps
  its plain decoder, so that it still shards the edge decode): the same
  modes, keyframes and edges, poses within 1e-4 (the TINY SLAM twin's
  tolerance, tests/test_torch_slam_model.py);
* the port's asynchronous mesh run (the worker solves through the sharded
  GN) against its synchronous mesh run: the same keyframes and edges,
  poses within 1e-4.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.app import pipeline as jpipe
from monst3r_slam_tpu.app.config import load_config as jload_config
from monst3r_slam_tpu.dynamic.inference import DualParams as JDualParams
from monst3r_slam_tpu.dynamic.inference import EasiParams as JEasiParams
from monst3r_slam_tpu.models import init as jinit
from monst3r_slam_tpu.models import mast3r as jmodel
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.parallel import inference as jpinf
from monst3r_slam_tpu.parallel import mesh as jmesh
from monst3r_slam_tpu.slam import backend as jb
from monst3r_slam_tpu.slam import factor_graph as jfg
from monst3r_slam_torch.app import pipeline as tpipe
from monst3r_slam_torch.app.config import load_config as tload_config
from monst3r_slam_torch.dynamic.inference import DualParams, EasiParams
from monst3r_slam_torch.models import mast3r as tmodel
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.models.convert import params_from_jax
from monst3r_slam_torch.parallel import inference as tpinf
from monst3r_slam_torch.parallel import mesh as tmesh
from monst3r_slam_torch.slam import backend as tb
from monst3r_slam_torch.slam import factor_graph as tfg
from tests.test_backend import build_graph
from tests.test_torch_slam import close_backend_workers  # noqa: F401

CPU = torch.device("cpu")
POSE_TOL = 1e-4


def cpu_mesh(n=8):
    return tmesh.make_mesh(devices=[CPU] * n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_factorization_matches_jax(n):
    jm, tm = jmesh.make_mesh(n), cpu_mesh(n)
    assert dict(tm.shape) == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names) and tm.devices.shape == jm.devices.shape
    assert tm.size == n and tm.shard_devices("dp") == [CPU] * jm.shape["dp"]



def test_on_card_enters_no_context_off_the_card():
    """`ops.build.on_card`, the one helper that makes a card current around
    a launch (the kernel wrappers, each shard of the sharded decode, the
    dual decode), gives no context and asks no card for a CPU device or a
    CPU tensor's index (-1), so the mesh's CPU shards run as they are."""
    from monst3r_slam_torch.ops.build import on_card

    for dev in (CPU, -1):
        assert isinstance(on_card(dev), contextlib.nullcontext)

def _port_layout(jspec, keys, nd, stacked):
    """JAX's spec of a leaf moved to the port's layout, as `params_from_jax`
    moves the leaf: the depth axis of a stacked block dropped, a linear
    weight transposed, a conv weight HWIO -> OIHW (a transposed conv ->
    (I, O, kh, kw))."""
    spec = list(jspec) + [None] * (nd - len(jspec))
    if stacked:
        spec = spec[1:]
    if keys[-1] == "w" and len(spec) == 2:
        spec = spec[::-1]
    elif keys[-1] == "w" and len(spec) == 4:
        spec = [spec[k] for k in ((2, 3, 0, 1) if keys[-2] == "up" else (3, 2, 0, 1))]
    return tuple(spec)


def test_param_spec_matches_jax():
    jp = jinit.init_params(jax.random.PRNGKey(0), JTINY)
    tp = params_from_jax(_np(jp))
    n_leaves = n_split = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        jspec = jmesh.param_spec(path, leaf)
        stacked = keys[0] in ("enc_blocks", "dec_blocks", "dec_blocks2")
        want = _port_layout(jspec, keys, leaf.ndim, stacked)
        for i in range(leaf.shape[0]) if stacked else [None]:
            tpath = keys[:1] + [i] + keys[1:] if stacked else keys
            node = tp
            for k in tpath:
                node = node[k]
            assert tmesh.param_spec(tpath, node) == want, (tpath, jspec)
            n_leaves += 1
            n_split += "tp" in want
    assert n_split == 6 * JTINY.enc_depth + 2 * 13 * JTINY.dec_depth + 2 * 3  # blocks, heads
    assert n_leaves > n_split


def _edge_inputs(E, H, W, seed=1):
    rng = np.random.default_rng(seed)
    n = (H // 16) * (W // 16)
    feat1 = rng.standard_normal((E, n, JTINY.enc_dim)).astype(np.float32)
    feat2 = rng.standard_normal((E, n, JTINY.enc_dim)).astype(np.float32)
    yy, xx = np.mgrid[0 : H // 16, 0 : W // 16]
    pos = np.broadcast_to(np.stack([yy.ravel(), xx.ravel()], -1)[None], (E, n, 2))
    return feat1, pos.astype(np.int32).copy(), feat2


def _f32_jax_model(monkeypatch):
    """JAX's encode and decode at f32 for every caller (its pipeline and
    parallel/inference read `model_api.encode` / `.decode` at call time)."""
    monkeypatch.setattr(jmodel, "decode", functools.partial(jmodel.decode, dtype=jnp.float32))
    monkeypatch.setattr(jmodel, "encode", functools.partial(jmodel.encode, dtype=jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sharded_edge_decode_matches_jax(dtype, monkeypatch):
    H, W, E = 32, 48, 3  # E is not a dp multiple: the pad rows are added and stripped
    jp = jinit.init_params(jax.random.PRNGKey(0), JTINY)
    tp = params_from_jax(_np(jp))
    feat1, pos, feat2 = _edge_inputs(E, H, W)
    jf32 = jmodel.decode(jp, JTINY, feat1, pos, feat2, pos, (H, W), dtype=jnp.float32)
    if dtype == "float32":
        _f32_jax_model(monkeypatch)
    jm = jmesh.make_mesh(8)
    jout = jpinf.sharded_edge_decode(jm, jpinf.place_replicated(jp, jm), JTINY, feat1, pos, feat2,
                                     pos, (H, W))
    tm = cpu_mesh()
    t_in = [torch.from_numpy(a) for a in (feat1, pos, feat2, pos)]
    tdtype = getattr(torch, dtype)
    tout = tpinf.sharded_edge_decode(tm, tpinf.place_replicated(tp, tm), TTINY, *t_in, (H, W),
                                     tdtype)
    tref = tmodel.decode(tp, TTINY, *t_in, (H, W), tdtype)
    for name, j, t, r, f in zip(jout._fields, jout, tout, tref, jf32):
        if j is None:
            assert t is None and r is None
            continue
        assert tuple(t.shape) == j.shape == tuple(r.shape)
        assert t.stride() == r.stride()  # the matcher's reductions read the layout
        j, t, r = np.asarray(j, np.float32), t.float().numpy(), r.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(t, r, atol=2e-4, rtol=1e-3)
            np.testing.assert_allclose(t, j, atol=2e-4, rtol=1e-3)
        else:
            np.testing.assert_array_equal(t, r)
            own = np.abs(j - np.asarray(f)).max()
            assert 0 < np.abs(t - j).max() <= 2.0 * own, (name, np.abs(t - j).max(), own)


def test_dual_decode_two_device_matches_jax(monkeypatch):
    H, W = 32, 48
    jcfg_m = dataclasses.replace(JTINY, desc_dim=None, two_confs=False)
    tcfg_m = dataclasses.replace(TTINY, desc_dim=None, two_confs=False)
    jm, ja = (jinit.init_params(jax.random.PRNGKey(k), c) for k, c in ((0, jcfg_m), (1, JTINY)))
    jdual = JDualParams(monst3r=jm, monst3r_cfg=jcfg_m, mast3r=ja, mast3r_cfg=JTINY)
    tdual = DualParams(params_from_jax(_np(jm)), tcfg_m, params_from_jax(_np(ja)), TTINY)
    feat_i, pos, feat_j = (a[:1] for a in _edge_inputs(1, H, W, seed=2))
    _f32_jax_model(monkeypatch)
    jdevs = jpinf.dual_device_pair(jax.devices())
    jout = jpinf.dual_decode_two_device(jpinf.place_dual(jdual, *jdevs), *jdevs, feat_i, pos,
                                        feat_j, pos, (H, W))
    devs = tpinf.dual_device_pair(cpu_mesh())
    assert devs == (CPU, CPU)
    assert tpinf.dual_device_pair([CPU]) is None
    t_in = [torch.from_numpy(a) for a in (feat_i, pos, feat_j, pos)]
    tout = tpinf.dual_decode_two_device(tpinf.place_dual(tdual, *devs), *devs, *t_in, (H, W),
                                        torch.float32)
    for j, t in zip(jout, tout):
        if j is None:
            assert t is None
            continue
        assert t.device == devs[0]
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-4, rtol=1e-3)


def _graph(seed, P=5, calib=None):
    hw = 512 if calib is None else calib[1] * calib[2]
    return [np.asarray(a) for a in build_graph(jax.random.PRNGKey(seed), P=P, hw=hw,
                                               calib=calib)]


K_CALIB = np.asarray([[30.0, 0, 16.0], [0, 30.0, 12.0], [0, 0, 1.0]], np.float32)


@pytest.mark.parametrize("calibrated", [False, True])
def test_gauss_newton_sharded_matches_jax(calibrated):
    """The P=5, E=8 graph of tests/test_backend.py (E divides dp 4), and its
    calibrated form at 24x32."""
    h, w = 24, 32
    calib = (jnp.asarray(K_CALIB), h, w) if calibrated else None
    T_true, T_init, *args = _graph(4, calib=calib)
    kw = dict(n_poses=5, use_calib=calibrated)
    if calibrated:
        kw.update(img_size=(h, w))
    jm = jmesh.make_mesh(8)
    T_j, _ = jb.gauss_newton_sharded(jm, *(jnp.asarray(a) for a in [T_init] + args),
                                     jb.BackendConfig(max_iters=10, chunk=512),
                                     K=calib and calib[0], **kw)
    t_args = [torch.from_numpy(a.copy()) for a in [T_init] + args]
    tcfg = tb.BackendConfig(max_iters=10)
    K = torch.from_numpy(K_CALIB) if calibrated else None
    T_s, it_s = tb.gauss_newton_sharded(cpu_mesh(), *t_args, tcfg, K=K, **kw)
    T_u, it_u = tb.gauss_newton(*t_args, tcfg, K=K, **kw)
    assert it_s >= 1 and abs(it_s - it_u) <= 1  # the stop test reads a step norm near 1e-8
    np.testing.assert_allclose(T_s.numpy(), np.asarray(T_j), atol=POSE_TOL)
    np.testing.assert_allclose(T_s.numpy(), T_u.numpy(), atol=POSE_TOL)
    with pytest.raises(ValueError, match="must divide"):
        tb.gauss_newton_sharded(cpu_mesh(6), *t_args, tcfg, K=K, **kw)  # dp 3 and E 8


def test_yaml_mesh_off_builds_no_mesh(tmp_path):
    """A config file's bare `mesh: off` reaches the system as YAML's false
    (as JAX reads it, no mesh); the port once refused it as an unknown
    setting."""
    f = tmp_path / "off.yaml"
    f.write_text("inherit: config/base.yaml\nsingle_thread: True\nparallel:\n  mesh: off\n")
    tcfg, jcfg = tload_config(str(f), set_global=False), jload_config(str(f))
    assert tcfg["parallel"]["mesh"] is False and jcfg["parallel"]["mesh"] is False
    j = jpipe.SLAMSystem(params={}, model_cfg=JTINY, cfg=jcfg, img_size=(64, 80), kf_capacity=2)
    t = tpipe.SLAMSystem(params={}, model_cfg=TTINY, cfg=tcfg, img_size=(64, 80), kf_capacity=2,
                         device="cpu")
    assert j.mesh is None and t.mesh is None and t._mesh_params is None


def test_factor_graph_pads_edges_to_dp(monkeypatch):
    """`solve_poses` with a 6-device mesh (dp 3): the 8 edges pad to 8 (the
    power-of-two bucket), then to 9, a multiple of dp, in both packages."""
    T_true, T_init, Xs, Cs, ii, jj, idx, valid, Q, ev = _graph(5)
    hw = idx.shape[1]
    jg, tg = jfg.FactorGraph(hw), tfg.FactorGraph(hw, device=CPU)
    t = torch.from_numpy
    half = ii.shape[0] // 2
    for e in range(half):  # build_graph stores (p, p+1) first, then (p+1, p)
        r = e + half
        jg.add_edge_pair(int(ii[e]), int(jj[e]), jnp.asarray(idx[e]), jnp.asarray(valid[e]),
                         jnp.asarray(Q[e]), jnp.asarray(idx[r]), jnp.asarray(valid[r]),
                         jnp.asarray(Q[r]))
        tg.add_edge_pair(int(ii[e]), int(jj[e]), *(t(a.copy()) for a in (
            idx[e], valid[e], Q[e], idx[r], valid[r], Q[r])))
    P = 8  # the pose bucket of 5 keyframes
    pad = lambda a: np.concatenate([a, np.repeat(a[-1:], P - a.shape[0], 0)])  # noqa: E731
    Twc, X, C = pad(T_init), pad(Xs), pad(Cs)
    calls = []
    sharded = tb.gauss_newton_sharded

    def counted(mesh, *a, **k):
        calls.append(a[3].shape[0])  # the padded edge count
        return sharded(mesh, *a, **k)

    monkeypatch.setattr(tb, "gauss_newton_sharded", counted)
    T_t = tg.solve_poses(t(Twc), t(X), t(C), 5, tb.BackendConfig(max_iters=10), mesh=cpu_mesh(6))
    T_u = tg.solve_poses(t(Twc), t(X), t(C), 5, tb.BackendConfig(max_iters=10))
    assert calls == [9]
    T_j = jg.solve_poses(jnp.asarray(Twc), jnp.asarray(X), jnp.asarray(C), 5,
                         jb.BackendConfig(max_iters=10, chunk=512), mesh=jmesh.make_mesh(6))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=POSE_TOL)
    np.testing.assert_allclose(T_t.numpy(), T_u.numpy(), atol=POSE_TOL)


H, W = 64, 80
N_FRAMES, KF_AT = 5, (2, 4)  # two keyframe events: edge decodes and global solves


def _slam_cfg(load, **over):
    """config/base.yaml (`parallel.mesh: auto`) with the gates opened as
    __graft_entry__.py opens them for its mesh run, so that random tied
    weights track a repeated frame; the tiled matcher on both sides."""
    c = load("config/base.yaml")
    c["tracking"].update(Q_conf=-1e9, C_conf=-1e9, min_match_frac=0.0)
    c["local_opt"].update(Q_conf=-1e9, min_match_frac=0.0)
    c["matching"]["mode"] = "tiled"
    c["single_thread"] = True
    c.update(over)
    return c


def _tload(path):
    return tload_config(path, set_global=False)


@pytest.fixture(scope="module")
def tied_tiny():
    """JAX's TINY draw with both decoder streams and heads tied (the smoke's
    `tied_params`), and its port copy: the draw of the TINY SLAM twin
    (tests/test_torch_slam_model.py). __graft_entry__.py's draw (key 11)
    is ill-conditioned for a twin, with the mesh or without: the two
    packages' f32 edge decodes, 1e-5 apart, pick different matches on ~6%
    of the pixels of the first edge, and the solve, not converged after its
    10 iterations, moves the new keyframe's scale to 1.031 in JAX and 1.099
    in the port (JAX's own mesh-against-off distance on those frames:
    4.8e-7)."""
    jp = jinit.init_params(jax.random.PRNGKey(0), JTINY)
    jp["dec_blocks2"], jp["head2"] = jp["dec_blocks"], jp["head1"]
    return jp, params_from_jax(_np(jp))


def _frame():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = sum(np.sin(rng.uniform(0.05, 0.3) * xx[..., None] + rng.uniform(0.05, 0.3)
                     * yy[..., None] + rng.uniform(0, 6.3, 3)) for _ in range(6))
    return (img / np.abs(img).max()).astype(np.float32)


def _drive(slam, wait_for_worker=False):
    """Every frame the same image, keyframes forced at KF_AT; the modes and
    each frame's tracked pose (the INIT frame's: its recorded pose)."""
    modes, tracked, img = [], [], _frame()
    for i in range(N_FRAMES):
        slam.process_frame(i, i / 30.0, img, force_kf=True if i in KF_AT else None)
        if wait_for_worker:
            slam._backend_jobs.join()
        modes.append(int(slam.mode))
        tracked.append(np.asarray(slam.last_summary[:8]).copy() if i else slam.frame_poses[0])
    slam.finalize()
    return modes, np.stack(tracked)


def _count(monkeypatch, module, name, calls, key):
    fn = getattr(module, name)

    def counted(*a, **k):
        calls[key] = calls.get(key, 0) + 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)


def test_slam_system_mesh_matches_jax(tied_tiny, monkeypatch):
    jp, tp = tied_tiny
    _f32_jax_model(monkeypatch)
    calls = {}
    _count(monkeypatch, jpinf, "sharded_edge_decode", calls, "jax_decode")
    _count(monkeypatch, jb, "gauss_newton_sharded", calls, "jax_gn")
    _count(monkeypatch, tpipe, "sharded_edge_decode", calls, "port_decode")
    _count(monkeypatch, tb, "gauss_newton_sharded", calls, "port_gn")
    js = jpipe.SLAMSystem(params=jp, model_cfg=JTINY, cfg=_slam_cfg(jload_config),
                          img_size=(H, W), kf_capacity=8)
    ts = tpipe.SLAMSystem(params=tp, model_cfg=TTINY, cfg=_slam_cfg(_tload), img_size=(H, W),
                          kf_capacity=8, device="cpu", dtype=torch.float32, mesh=cpu_mesh())
    assert dict(js.mesh.shape) == ts.mesh.shape == {"dp": 4, "tp": 2}
    assert js._mesh_params is not None and ts._mesh_params is not None
    assert not js.host_solve and not ts.host_solve  # the device solve under `solver: auto`
    j_modes, j_tracked = _drive(js)
    t_modes, t_tracked = _drive(ts)
    assert t_modes == j_modes and j_modes[1:] == [1] * (N_FRAMES - 1)  # every frame tracked
    assert ts.keyframe_trajectory()[1].tolist() == np.asarray(js.keyframe_trajectory()[1]).tolist()
    assert ts.graph.edge_list() == js.graph.edge_list() and ts.n_kf == 3
    assert calls == {"jax_decode": 2, "jax_gn": 2, "port_decode": 2, "port_gn": 2}
    np.testing.assert_allclose(t_tracked, j_tracked, atol=POSE_TOL)
    np.testing.assert_allclose(np.stack(ts.frame_poses), np.stack(js.frame_poses), atol=POSE_TOL)
    np.testing.assert_allclose(ts.keyframe_trajectory()[0], np.asarray(js.keyframe_trajectory()[0]),
                               atol=POSE_TOL)
    # the dual and Easi3R pipelines keep their own decoders: a mesh, no replicas
    jd = dict(dual=JDualParams({}, JTINY, {}, JTINY))
    je = dict(easi3r=JEasiParams({}, JTINY, {}, JTINY))
    for jkw, tkw in ((jd, dict(dual=DualParams({}, TTINY, {}, TTINY))),
                     (je, dict(easi3r=EasiParams({}, TTINY, {}, TTINY)))):
        j = jpipe.SLAMSystem(params={}, model_cfg=JTINY, cfg=_slam_cfg(jload_config),
                             img_size=(H, W), kf_capacity=2, **jkw)
        t = tpipe.SLAMSystem(params={}, model_cfg=TTINY, cfg=_slam_cfg(_tload), img_size=(H, W),
                             kf_capacity=2, device="cpu", mesh=cpu_mesh(), **tkw)
        assert j.mesh is not None and t.mesh is not None
        assert j._mesh_params is None and t._mesh_params is None


def test_async_mesh_run_matches_synchronous(tied_tiny, monkeypatch):
    """The worker solves through the sharded GN (`solver: auto` takes the
    device solve under a mesh); every frame resolved at once and the worker
    waited for after each, so its poses fold in before the next frame."""
    _, tp = tied_tiny
    calls = {}
    _count(monkeypatch, tb, "gauss_newton_sharded", calls, "gn")

    def system(single_thread):
        return tpipe.SLAMSystem(params=tp, model_cfg=TTINY,
                                cfg=_slam_cfg(_tload, single_thread=single_thread,
                                              defer_tracking_sync=0),
                                img_size=(H, W), kf_capacity=8, device="cpu",
                                dtype=torch.float32, mesh=cpu_mesh())

    sync, asyn = system(True), system(False)
    assert asyn._worker is not None and not asyn.host_solve
    s_modes, s_tracked = _drive(sync)
    a_modes, a_tracked = _drive(asyn, wait_for_worker=True)
    assert a_modes == s_modes
    assert asyn.n_async_solves == 2 and calls == {"gn": 4}
    assert asyn.keyframe_trajectory()[1].tolist() == sync.keyframe_trajectory()[1].tolist()
    assert asyn.graph.edge_list() == sync.graph.edge_list()
    np.testing.assert_allclose(a_tracked, s_tracked, atol=POSE_TOL)
    np.testing.assert_allclose(asyn.keyframe_trajectory()[0], sync.keyframe_trajectory()[0],
                               atol=POSE_TOL)
