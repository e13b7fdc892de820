"""The port's dynamic pipeline against the benchmark's plain references
(`benchmark/reference/`), on the CPU, on seeded random weights drawn by the
benchmark's own code (`benchmark/harness/weights.py`, `weights_dynamic.py`):

* RAFT at its published widths on a 64x80 pair, at 3 and 20 iterations;
* SAM2 at SAM2_TEST: the encode, the prompt decode and the selection;
* the ego-motion flow, the error map and the coarse mask at 48x64;
* the dual decode (MonST3R's encoder and decoder, MASt3R's decoder and
  heads on MonST3R's features) at TINY;
* the dynamic oracle scene's exact flow and object mask against
  reprojection.

Each tolerance says why it holds, and the same comparison with the
reference computed with bf16 operands fails it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import scene, scene_dynamic, weights, weights_dynamic
from benchmark.reference import dynamic_mask as ref_mask
from benchmark.reference import model as ref_model
from benchmark.reference import raft as ref_raft
from benchmark.reference import sam2 as ref_sam2
from monst3r_slam_torch.dynamic import mask as dyn_mask
from monst3r_slam_torch.dynamic import raft as raft_mod
from monst3r_slam_torch.dynamic import sam2 as sam2_mod
from monst3r_slam_torch.dynamic.inference import DualParams, monst3r_asymmetric_inference
from monst3r_slam_torch.models import mast3r as model_api
from monst3r_slam_torch.models.config import TINY

RAFT = dict(feature_dim=256, hidden_dim=128, context_dim=128, corr_levels=4, corr_radius=4,
            flow_out_std=0.003)
OBJ = dict(radius=0.5, amp_x=0.8, freq_x=0.25, amp_y=0.4, freq_y=0.17, phase_y=1.0, z=1.8,
           spin=0.1)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("iters", [3, 20])
def test_raft_matches_the_reference(iters):
    """Both sides are f32 over the same operations; their sums differ in
    order only (the port's gathers and padding against unfold and
    F.instance_norm): 3.6e-6 of the flow measured at 3 iterations and 2.4e-6
    at 20 (the benchmark's weights, whose flow head contracts the
    recurrence). 1e-4 holds both; bf16 operands read 2.8e-2 and 2.1e-2."""
    rc = dict(RAFT, iters=iters)
    params = weights_dynamic.raft_params(rc, 2**31 + 7, "cpu")
    g = torch.Generator().manual_seed(iters)
    a, b = (255 * torch.rand((64, 80, 3), generator=g) for _ in range(2))
    got = raft_mod.raft_flow(params, a, b, raft_mod.RAFTConfig(iters=iters))
    ref = ref_raft.flow(params, rc, a, b)
    assert ref_raft.rel_rms(got, ref) < 1e-4
    assert ref_raft.rel_rms(ref_raft.flow(params, rc, a, b, ref_raft.bf16), ref) > 1e-4


def test_sam2_matches_the_reference():
    """f32 on both sides: the encode's three maps and the decode's logits
    and IoUs agree within 1e-5 of their largest magnitude (at most 4e-7 for
    the maps and the logits and 1.2e-6 for the IoUs measured: sums in
    another order), and the selected masks pixel for pixel, where bf16
    operands move the logits by 1.3e-2 of their scale."""
    cfg = sam2_mod.SAM2_TEST
    sc = dict(cfg._asdict(), max_objects=3)
    params = weights_dynamic.sam2_params(sc, 2**31 + 3, "cpu")
    g = torch.Generator().manual_seed(0)
    img = torch.rand((1, cfg.img_size, cfg.img_size, 3), generator=g)
    pts = torch.rand((3, 1, 2), generator=g)
    lbs = torch.tensor([[1], [1], [-1]])
    got_emb = sam2_mod.sam2_encode(params, cfg, img)
    ref_emb = ref_sam2.encode(params, sc, img)
    for a, b in zip(got_emb, ref_emb):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-5
    logits, iou, _ = sam2_mod._decode(params, cfg, *got_emb, pts, lbs)
    r_logits, r_iou = ref_sam2.decode(params, sc, *ref_emb, pts, lbs)
    assert float((logits - r_logits).abs().max() / r_logits.abs().max()) < 1e-5
    assert float((iou - r_iou).abs().max() / r_iou.abs().max()) < 1e-5
    sel, best_iou = sam2_mod.sam2_decode_select(params, cfg, *got_emb, pts, lbs)
    r_sel, r_best = ref_sam2.select(r_logits, r_iou)
    assert torch.equal(sel, r_sel)
    torch.testing.assert_close(best_iou, r_best, rtol=0, atol=1e-5 * float(r_iou.abs().max()))
    b_logits, _ = ref_sam2.decode(params, sc, *ref_sam2.encode(params, sc, img, ref_raft.bf16),
                                  pts, lbs, ref_raft.bf16)
    assert float((b_logits - r_logits).abs().max() / r_logits.abs().max()) > 1e-5


def test_ego_motion_mask_matches_the_reference():
    """The ego-motion flow, the min-max-normalized error map and its
    threshold on a 48x64 pair: the maps within 1e-5 (f32 on both sides over
    the same arithmetic: a relative pose and a pinhole projection; 4e-7
    measured, and 1.5e-5 px on the ego-motion flow, held to 1e-4), no
    decision flips outside the 1e-3 band the benchmark leaves out; bf16
    operands move the map by 6e-3."""
    h, w, f = 48, 64, 40.0
    K = scene_dynamic.intrinsics(h, w, f, "cpu")
    poses = torch.from_numpy(scene.trajectory(3, 4, 0.12))
    T_i, T_j = poses[3], poses[0]
    depth = scene.render_frame(T_i, h, w, f)[0][:, 2].reshape(h, w)
    g = torch.Generator().manual_seed(1)
    flow = 6 * torch.randn((h, w, 2), generator=g)
    ego = dyn_mask.ego_motion_flow(T_i, T_j, depth, K)
    assert float((ego - ref_mask.ego_flow(T_i, T_j, depth, K)).abs().max()) < 1e-4
    got = dyn_mask.flow_error_map(flow, ego)
    ref = ref_mask.coarse(flow, T_i, T_j, depth, K)
    assert float((got - ref).abs().max()) < 1e-5
    assert ref_mask.flip_share(got, ref, 0.35) == 0.0
    assert torch.equal(dyn_mask.flow_error_mask(flow, ego, 0.35)[(ref - 0.35).abs() > 1e-3],
                       (ref > 0.35)[(ref - 0.35).abs() > 1e-3])
    low = ref_mask.coarse(flow, T_i, T_j, depth, K, ref_raft.bf16)
    assert float((low - ref).abs().max()) > 1e-5


def tiny_dict(**kw) -> dict:
    d = dataclasses.asdict(dataclasses.replace(TINY, **kw))
    return dict(d, head_out_std=0.001)


def test_dual_decode_matches_the_reference():
    """MonST3R's X and C, MASt3R's D and Q on MonST3R's encoder features,
    both views, in f32: within 1e-4 of the reference's RMS (1e-6
    measured; the port's attention and RoPE against plain matmuls and the
    reference's rotation), where bf16 operands read 1.3e-2."""
    mcfg, acfg = tiny_dict(desc_dim=None, two_confs=False), tiny_dict()
    pm = weights.make_params(mcfg, 11, "cpu", served=False)
    pa = weights.make_params(acfg, 12, "cpu", served=False)
    mon, mas = (dataclasses.replace(TINY, desc_dim=None, two_confs=False), TINY)
    dual = DualParams(pm, mon, pa, mas)
    g = torch.Generator().manual_seed(2)
    img = torch.rand((2, 64, 80, 3), generator=g) * 2 - 1
    fi, pi = model_api.encode(pm, mon, img[:1], torch.float32)
    fj, pj = model_api.encode(pm, mon, img[1:], torch.float32)
    got = monst3r_asymmetric_inference(dual, fi, pi, fj, pj, (64, 80), torch.float32)

    def ref(P):
        f1, p1 = ref_model.encode(pm, mcfg, img[:1], P)
        f2, p2 = ref_model.encode(pm, mcfg, img[1:], P)
        out = {}
        for name, params, cfg in (("m", pm, mcfg), ("a", pa, acfg)):
            h1, h2 = ref_model.decode(params, cfg, f1, p1, f2, p2, P)
            out[name] = (ref_model.head(params["head1"], cfg, h1, 4, 5, P),
                         ref_model.head(params["head2"], cfg, h2, 4, 5, P))
        (m1, m2), (a1, a2) = out["m"], out["a"]
        return dict(X1=m1["pts3d"], C1=m1["conf"], D1=a1["desc"], Q1=a1["desc_conf"],
                    X2=m2["pts3d"], C2=m2["conf"], D2=a2["desc"], Q2=a2["desc_conf"])

    exact = ref(ref_model.F32)
    errs = ref_model.rel_errors(got._asdict(), exact)
    assert max(e[0] for e in errs.values()) < 1e-4, errs
    low = ref_model.rel_errors(ref(ref_raft.bf16), exact)
    assert max(e[0] for e in low.values()) > 1e-4


def test_dynamic_scene_flow_and_mask_reproject():
    """The exact flow moves each pixel's point to where frame j sees it: a
    surface pixel's target in frame j shows the same world point, an object
    pixel's target the same point of the object's body (both read by
    bilinear interpolation of frame j's rendered maps, within 2e-2 of a
    unit: the maps' curvature over one pixel), away from the silhouettes and
    where nothing hides the point at time j; and the object mask is where
    the frame's ray meets the sphere before the surface."""
    h, w, f = 96, 128, 76.8
    poses = torch.from_numpy(scene.trajectory(10, 3, 0.12))
    idx = torch.arange(10, 13).float()
    Ti, Tj, ii, ij = poses[2], poses[0], idx[2], idx[0]
    _, Xw_i, on_i, Xb_i = scene_dynamic.render_frame(Ti, ii, OBJ, h, w, f)
    Xc_j, Xw_j, on_j, Xb_j = scene_dynamic.render_frame(Tj, ij, OBJ, h, w, f)
    flow = scene_dynamic.flow(Ti, Tj, ii, ij, OBJ, h, w, f).reshape(-1, 2)
    v, u = torch.meshgrid(torch.arange(h).float(), torch.arange(w).float(), indexing="ij")
    tu, tv = u.reshape(-1) + flow[:, 0], v.reshape(-1) + flow[:, 1]

    def sample(field):  # bilinear read of frame j's (h*w, c) map at the targets
        grid = torch.stack([2 * (tu + 0.5) / w - 1, 2 * (tv + 0.5) / h - 1], -1)[None, None]
        img = field.reshape(1, h, w, -1).permute(0, 3, 1, 2)
        return torch.nn.functional.grid_sample(img, grid, align_corners=False)[0, :, 0].T

    on_j_t = sample(on_j.float()[:, None])[:, 0]
    inside = (tu > 1) & (tu < w - 2) & (tv > 1) & (tv < h - 2)
    # a surface point still visible at j, and an object point on the object at j
    surf = ~on_i & inside & (on_j_t == 0)
    obj = on_i & inside & (on_j_t == 1)
    assert surf.float().mean() > 0.5 and obj.sum() > 100
    assert float((sample(Xw_j)[surf] - Xw_i[surf]).norm(dim=-1).median()) < 2e-2
    assert float((sample(Xb_j)[obj] - Xb_i[obj]).norm(dim=-1).median()) < 2e-2
    # the mask: depth on the object is the sphere's, in front of the surface
    mask = scene_dynamic.object_mask(Ti, ii, OBJ, h, w, f).reshape(-1)
    assert torch.equal(mask, on_i)
    c = scene_dynamic.centre(OBJ, ii, Ti)
    assert np.allclose((Xw_i[mask] - c).norm(dim=-1).numpy(), OBJ["radius"], atol=1e-4)
    share = float(mask.float().mean())
    assert 0.05 < share < 0.35
