"""The port's SAM2 image pipeline (`monst3r_slam_torch/dynamic/sam2.py`)
against the JAX package's, at SAM2_TEST (128 px, Hiera widths 16-128, d_model
32), with JAX's `init_sam2_params` carried over by `sam2_params_from_numpy`,
on the same numpy inputs. Both sides in f32.

Tolerances: the resizes within 1e-5 of their scale (the weight matrices in
f32, applied in another summation order); each Hiera stage, the neck, the
prompt encoder, the mask decoder and the entry functions within 1e-5 of their
scale (measured at most 1.3e-6: f32 summation order through five blocks and
the two-way transformer); the selected boolean masks and the refiners'
masks equal on every pixel. The frozen self-golden is replayed at
tests/test_golden.py's tolerances (atol and rtol 2e-3 on the mask probe,
atol 1e-3 on the IoUs).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from monst3r_slam_tpu.dynamic import sam2 as J
from monst3r_slam_torch.dynamic import mask as tmask
from monst3r_slam_torch.dynamic import sam2 as T
from tests.test_sam2 import _fabricate_torch_sd
from tests.test_torch_slam import one_torch_thread  # noqa: F401

CFG = J.SAM2_TEST
S = CFG.img_size
REL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(J.init_sam2_params, static_argnums=1)(jax.random.PRNGKey(0), CFG)
    return jp, T.sam2_params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(1).uniform(0, 1, (1, S, S, 3)).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rel=REL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * float(np.abs(ref).max()), rtol=0)


def _points():
    pts = np.array([[[0.3, 0.4]], [[0.6, 0.5]], [[0.0, 0.0]]], np.float32)
    lbs = np.array([[1], [1], [-1]], np.int32)
    return pts, lbs


def test_configs_match_jax():
    for name in ("SAM2_BASE_PLUS", "SAM2_SMALL", "SAM2_TINY", "SAM2_TEST"):
        assert getattr(T, name)._asdict() == getattr(J, name)._asdict()


# (input shape, output spatial size, method, spatial axes): the pos_embed
# resize at SAM2_TEST and at SAM2_BASE_PLUS, the decoder's 4x mask upsampling
# (B, M, h, w), the video memory encoder's (1, h, w) mask upsampling, and the
# neck's 2x nearest
RESIZES = [((1, 14, 14, 16), (32, 32), "bicubic", (1, 2)),
           ((1, 14, 14, 8), (256, 256), "bicubic", (1, 2)),
           ((3, 4, 32, 32), (128, 128), "bilinear", (2, 3)),
           ((1, 32, 32), (128, 128), "bilinear", (1, 2)),
           ((1, 4, 4, 32), (8, 8), "nearest", (1, 2))]


@pytest.mark.parametrize("shape,out_hw,method,axes", RESIZES)
def test_resize_matches_jax_image_resize(shape, out_hw, method, axes):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    out_shape = list(shape)
    out_shape[axes[0]], out_shape[axes[1]] = out_hw
    ref = jax.image.resize(jnp.asarray(x), tuple(out_shape), method=method)
    _close(T.resize(torch.from_numpy(x), out_hw, method, axes=axes), ref)
    if method == "bicubic":  # torch's bicubic (a = -0.75, clamped) is another resize
        tb = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=out_hw, mode="bicubic",
                           align_corners=False).permute(0, 2, 3, 1)
        assert float((tb - torch.from_numpy(np.array(ref))).abs().max()) > 1e-2


@pytest.mark.parametrize("stride,padding", [(4, ((3, 3), (3, 3))), (2, "SAME"), (1, "SAME")])
def test_conv2d_pads_as_the_reference(stride, padding):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 32, 30, 4)).astype(np.float32)
    p = {"w": rng.standard_normal((7 if stride == 4 else 3, 3, 4, 6)).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    ref = J._conv2d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride=stride, padding=padding)
    got = T._conv2d(T.sam2_params_from_numpy(p), torch.from_numpy(x), stride=stride,
                    padding=padding)
    _close(got, ref)


def test_conv2d_transpose_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    p = {"w": rng.standard_normal((2, 2, 6, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    _close(T._conv2d_transpose(T.sam2_params_from_numpy(p), torch.from_numpy(x)),
           J._conv2d_transpose(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))


@pytest.fixture(scope="module")
def stages(weights, image):
    jp, tp = weights
    x = (image - np.asarray([0.485, 0.456, 0.406], np.float32)) / np.asarray(
        [0.229, 0.224, 0.225], np.float32)
    return (jax.jit(J.hiera_forward, static_argnums=1)(jp["trunk"], CFG, jnp.asarray(x)),
            T.hiera_forward(tp["trunk"], CFG, torch.from_numpy(x)))


@pytest.mark.parametrize("stage", range(4))
def test_hiera_stage_matches_jax(stages, stage):
    ref, got = stages[0][stage], stages[1][stage]
    assert tuple(got.shape) == (1, S // 2 ** (stage + 2), S // 2 ** (stage + 2), 16 * 2**stage)
    _close(got, ref)


def test_neck_matches_jax(weights, stages):
    jp, tp = weights
    for got, ref in zip(T.neck_forward(tp["neck"], CFG, stages[1]),
                        J.neck_forward(jp["neck"], CFG, stages[0])):
        _close(got, ref)


def test_prompt_encoder_matches_jax(weights):
    jp, tp = weights
    pts, lbs = _points()
    lbs = np.array([[1], [0], [-1]], np.int32)  # positive, negative, padding
    _close(T.encode_points(tp["prompt"], CFG, torch.from_numpy(pts), torch.from_numpy(lbs)),
           J.encode_points(jp["prompt"], CFG, jnp.asarray(pts), jnp.asarray(lbs)))
    _close(T.dense_pe(tp["prompt"], (8, 6)), J.dense_pe(jp["prompt"], (8, 6)))


@pytest.fixture(scope="module")
def encoded(weights, image):
    jp, tp = weights
    return (J.sam2_encode(jp, CFG, jnp.asarray(image)),
            T.sam2_encode(tp, CFG, torch.from_numpy(image)))


def test_sam2_encode_matches_jax(encoded):
    for got, ref in zip(encoded[1], encoded[0]):
        _close(got, ref)


def test_mask_decoder_matches_jax(weights, encoded):
    jp, tp = weights
    pts, lbs = _points()
    je, te = encoded
    ref = jax.jit(J.mask_decoder, static_argnums=1)(
        jp["dec"], CFG, jnp.broadcast_to(je[0], (3, *je[0].shape[1:])),
        J.dense_pe(jp["prompt"], je[0].shape[1:3]),
        J.encode_points(jp["prompt"], CFG, jnp.asarray(pts), jnp.asarray(lbs)),
        [jnp.broadcast_to(t, (3, *t.shape[1:])) for t in je[1:]])
    got = T.mask_decoder(tp["dec"], CFG, te[0].expand(3, -1, -1, -1),
                         T.dense_pe(tp["prompt"], te[0].shape[1:3]),
                         T.encode_points(tp["prompt"], CFG, torch.from_numpy(pts),
                                         torch.from_numpy(lbs)),
                         [t.expand(3, -1, -1, -1) for t in te[1:]])
    for g, r in zip(got, ref):  # masks, iou, tokens_f
        _close(g, r)


def test_sam2_image_forward_matches_jax(weights, image):
    jp, tp = weights
    pts, lbs = _points()
    ref = J.sam2_image_forward(jp, CFG, jnp.asarray(image), jnp.asarray(pts), jnp.asarray(lbs))
    got = T.sam2_image_forward(tp, CFG, torch.from_numpy(image), torch.from_numpy(pts),
                               torch.from_numpy(lbs))
    assert tuple(got[0].shape) == (3, CFG.num_mask_tokens, S, S)
    for g, r in zip(got, ref):
        _close(g, r)


def test_sam2_decode_select_matches_jax(weights, encoded):
    jp, tp = weights
    pts, lbs = _points()
    je, te = encoded
    ref_m, ref_iou = J.sam2_decode_select(jp, CFG, *je, jnp.asarray(pts), jnp.asarray(lbs))
    got_m, got_iou = T.sam2_decode_select(tp, CFG, *te, torch.from_numpy(pts),
                                          torch.from_numpy(lbs))
    assert got_m.dtype == torch.bool and tuple(got_m.shape) == (3, S // 4, S // 4)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    _close(got_iou, ref_iou)


def test_decode_select_takes_the_first_of_equal_ious(weights, encoded, monkeypatch):
    """Among the multimask tokens 1..3 (never token 0, whatever its IoU),
    ties go to the first, as jnp.argmax's do: token m's logits are m - 1.5
    here, so token 1 thresholds to False and tokens 2 and 3 to True."""
    _, tp = weights
    iou = torch.tensor([[9.0, 0.5, 0.7, 0.7], [9.0, 0.2, 0.2, 0.2]])
    masks = (torch.arange(4.0) - 1.5)[None, :, None, None].expand(2, 4, 3, 3)
    monkeypatch.setattr(T, "mask_decoder", lambda *a: (masks, iou, None))
    pts, lbs = _points()
    sel, best = T.sam2_decode_select(tp, CFG, *encoded[1], torch.from_numpy(pts[:2]),
                                     torch.from_numpy(lbs[:2]))
    assert sel[0].all() and not sel[1].any() and best.tolist() == pytest.approx([0.7, 0.2])


def _refiner_case(case):
    h, w = 48, 64
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (h, w, 3), np.uint8)
    raw = np.zeros((h, w), bool)
    if case == "unprompted":  # tests/test_sam2.py::test_refiner_keeps_unprompted_components
        raw[10:20, 12:22] = True
        raw[34:40, 44:52] = True
        return img, raw, dict(max_objects=1, iou_floor=-1e9), 8
    raw[10:20, 12:22] = True
    raw[30:40, 40:52] = True
    kw = dict(max_objects=3, iou_floor=-1e9) if case == "replace" else {}
    return img, raw, kw, 20


@pytest.mark.parametrize("case", ["replace", "unprompted", "iou_floor"])
def test_refiner_matches_jax(weights, case):
    """Two components: all replaced (no IoU floor); the reference's
    unprompted-component case (a prompt budget of one); the default IoU
    floor of 0.3, which the random weights' IoUs decide."""
    jp, tp = weights
    img, raw, kw, min_area = _refiner_case(case)
    err = np.zeros(raw.shape, np.float32)
    ref = J.Sam2Refiner(jp, CFG, **kw)(img, err, raw, 0.35, min_area)
    tr = T.Sam2Refiner(tp, CFG, **kw)
    got = tr(img, err, raw, 0.35, min_area)
    assert got.dtype == bool and got.shape == raw.shape
    np.testing.assert_array_equal(got, ref)
    assert tr.calls == 1 and tr.replaced + tr.rejected == (1 if case == "unprompted" else 2)
    if case == "unprompted":
        assert got[34:40, 44:52].all()
    if case == "replace":
        assert tr.replaced == 2


def test_refiner_passes_an_empty_mask_and_installs(weights):
    _, tp = weights
    ref = T.Sam2Refiner(tp, CFG, max_objects=2, iou_floor=-1e9)
    h, w = 32, 32
    img = np.random.default_rng(1).integers(0, 255, (h, w, 3), np.uint8)
    empty = np.zeros((h, w), bool)
    np.testing.assert_array_equal(ref(img, np.zeros((h, w), np.float32), empty, 0.35, 20), empty)
    from monst3r_slam_torch.core import lie

    err_img = img.copy()
    err_img[8:16, 8:16] = 255
    tmask.set_mask_refiner(ref)
    try:
        T_id = lie.sim3_identity()
        m = tmask.get_dynamic_mask(img, err_img, T_id, T_id, torch.full((h, w), 2.0),
                                   torch.tensor([[32.0, 0, 16], [0, 32.0, 16], [0, 0, 1]]),
                                   threshold=0.35, refine=True)
        assert m.shape == (h, w) and m.dtype == bool
    finally:
        tmask.set_mask_refiner(None)


def test_sam2_self_golden(monkeypatch):
    """tests/fixtures/sam2_self_golden.npz, the JAX package's frozen SAM2
    numerics, through the port: scripts/gen_self_goldens.py's own recipe
    (weights and image drawn by JAX from its fixed keys), with the forward
    it calls replaced by the port's on those weights."""
    spec = importlib.util.spec_from_file_location("gen_self_goldens",
                                                  ROOT / "scripts" / "gen_self_goldens.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)

    def port_forward(params, cfg, img, pts, lbs):
        return T.sam2_image_forward(T.sam2_params_from_numpy(jax.tree.map(np.asarray, params)),
                                    cfg, *(torch.from_numpy(np.array(a)) for a in (img, pts, lbs)))

    monkeypatch.setattr(J, "sam2_image_forward", port_forward)
    masks, iou = gen.compute_sam2()
    gold = np.load(ROOT / "tests" / "fixtures" / "sam2_self_golden.npz")
    assert masks.shape == (2, CFG.num_mask_tokens, S, S)
    np.testing.assert_allclose(masks[:, :, ::37, ::41], gold["mask_probe"], atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(iou, gold["iou"], atol=1e-3)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_sam2_params_from_torch_on_a_synthetic_state_dict(tmp_path, weights):
    """The reference's test state dict (official names, torch layouts, with
    memory entries the image converter must skip) -> the same tree as the
    numpy parameters it was built from."""
    jp, tp = weights
    path = tmp_path / "sam2.pt"
    torch.save({"model": _fabricate_torch_sd(jp, CFG)}, path)
    got = _flat(T.sam2_params_from_torch(str(path), CFG))
    want = _flat(tp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


def test_init_sam2_params_has_the_reference_tree():
    want = jax.eval_shape(lambda k: J.init_sam2_params(k, CFG), jax.random.PRNGKey(0))
    assert _shapes(T.init_sam2_params(torch.Generator().manual_seed(0), CFG)) == _shapes(want)
