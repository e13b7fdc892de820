"""The port's SAM2 video predictor (`monst3r_slam_torch/dynamic/sam2_video.py`)
against the JAX package's, at SAM2_TEST + VIDEO_TEST (128 px, d_model 32,
mem_dim 16, 2 memory-attention layers, 4 pointer slots), with JAX's
`init_sam2_params` / `init_video_params` carried over by
`sam2_params_from_numpy` / `video_params_from_numpy`. Both sides in f32.

Tolerances: the positional codes within 1e-6 (the same f32 formulas); the
memory encoder, memory attention and the per-frame step within 1e-5 of
their scale (f32 summation order; measured at most 1.1e-6); the
three-frame propagation's logits within 1e-5 of their scale, with equal
signs; the refiners' masks equal on every pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.dynamic import sam2 as J
from monst3r_slam_tpu.dynamic import sam2_video as JV
from monst3r_slam_torch.dynamic import sam2 as T
from monst3r_slam_torch.dynamic import sam2_video as TV
from tests.test_sam2 import _fabricate_torch_sd
from tests.test_torch_sam2 import _close, _flat, _shapes
from tests.test_torch_slam import one_torch_thread  # noqa: F401

CFG = J.SAM2_TEST
VCFG = JV.VIDEO_TEST
S = CFG.img_size


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(J.init_sam2_params, static_argnums=1)(jax.random.PRNGKey(0), CFG)
    jvp = jax.jit(JV.init_video_params, static_argnums=(1, 2))(jax.random.PRNGKey(1), CFG, VCFG)
    return (jp, jvp, T.sam2_params_from_numpy(jax.tree.map(np.asarray, jp)),
            TV.video_params_from_numpy(jax.tree.map(np.asarray, jvp)))


def _frames(n):
    """tests/test_sam2_video.py's frames: a pattern with a moving block."""
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
    out = []
    for i in range(n):
        img = np.stack([np.sin(0.05 * xx + i), np.cos(0.07 * yy), 0 * xx + 0.5], -1) * 0.5 + 0.5
        img[40:70, 30 + 10 * i:60 + 10 * i] = [0.9, 0.1, 0.1]
        out.append(img.astype(np.float32))
    return out


def test_configs_match_jax():
    assert TV.VIDEO_BASE_PLUS._asdict() == JV.VIDEO_BASE_PLUS._asdict()
    assert TV.VIDEO_TEST._asdict() == JV.VIDEO_TEST._asdict()


def test_positional_codes_match_jax():
    np.testing.assert_allclose(TV.sine_pe_2d(8, 12, 64).numpy(), JV.sine_pe_2d(8, 12, 64),
                               atol=1e-6)
    cos, sin = TV.axial_rope_freqs(4, 6, 16, 10000.0)
    jcos, jsin = JV.axial_rope_freqs(4, 6, 16, 10000.0)
    np.testing.assert_allclose(cos.numpy(), jcos, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), jsin, atol=1e-6)
    x = np.random.default_rng(0).standard_normal((1, 2, 24, 16)).astype(np.float32)
    got = TV.apply_rope(torch.from_numpy(x), cos, sin).numpy()
    np.testing.assert_allclose(got, JV.apply_rope(jnp.asarray(x), jcos, jsin), atol=1e-6)
    # the pair layout: rotating (x[0], x[1]) at position 1 by its first angle
    c, s = float(cos[1, 0]), float(sin[1, 0])
    np.testing.assert_allclose(got[0, 0, 1, :2], [x[0, 0, 1, 0] * c - x[0, 0, 1, 1] * s,
                                                  x[0, 0, 1, 0] * s + x[0, 0, 1, 1] * c],
                               rtol=1e-6)


def test_memory_encoder_matches_jax(weights):
    _, jvp, _, tvp = weights
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((1, S // 16, S // 16, CFG.d_model)).astype(np.float32)
    mask = (20 / (1 + np.exp(-rng.standard_normal((1, S, S, 1)))) - 10).astype(np.float32)
    # nonzero gamma, so that the ConvNeXt blocks show (init puts 1e-6)
    jme = dict(jvp["mem_enc"], fuser=[dict(b, gamma=jnp.full_like(b["gamma"], 0.5))
                                      for b in jvp["mem_enc"]["fuser"]])
    tme = dict(tvp["mem_enc"], fuser=[dict(b, gamma=torch.full_like(b["gamma"], 0.5))
                                      for b in tvp["mem_enc"]["fuser"]])
    ref = jax.jit(JV.memory_encoder_forward)(jme, jnp.asarray(feat), jnp.asarray(mask))
    got = TV.memory_encoder_forward(tme, torch.from_numpy(feat), torch.from_numpy(mask))
    for g, r in zip(got, ref):
        _close(g, r)


def _bank(rng, hw16):
    """A partly filled bank: 3 of 7 spatial slots and 2 of 4 pointer slots."""
    nm, npt, md, d = VCFG.num_maskmem, VCFG.max_obj_ptrs, VCFG.mem_dim, CFG.d_model
    mem_valid = np.zeros(nm, bool)
    mem_valid[[0, 2, 5]] = True
    ptr_valid = np.zeros(npt, bool)
    ptr_valid[[0, 1]] = True
    return dict(mem_feat=rng.standard_normal((nm, hw16, md)).astype(np.float32),
                mem_pos=rng.standard_normal((nm, hw16, md)).astype(np.float32),
                mem_valid=mem_valid, mem_tpos=np.asarray([6, 0, 1, 2, 3, 4, 5], np.int32),
                obj_ptrs=rng.standard_normal((npt, d)).astype(np.float32), ptr_valid=ptr_valid)


def test_memory_attention_matches_jax_with_a_partly_filled_bank(weights):
    _, jvp, _, tvp = weights
    rng = np.random.default_rng(2)
    h = w = S // 16
    d, md = CFG.d_model, VCFG.mem_dim
    bank = _bank(rng, h * w)
    tokens = rng.standard_normal((1, h * w, d)).astype(np.float32)
    tok_pe = np.array(JV.sine_pe_2d(h, w, d)).reshape(h * w, d)
    n_spatial = VCFG.num_maskmem * h * w
    mem = np.concatenate([bank["mem_feat"].reshape(1, -1, md),
                          bank["obj_ptrs"].reshape(1, -1, md)], axis=1)
    pos = rng.standard_normal(mem.shape).astype(np.float32)
    bias = np.concatenate([np.where(np.repeat(bank["mem_valid"], h * w), 0.0, -1e9),
                           np.where(np.repeat(bank["ptr_valid"], d // md), 0.0, -1e9)])
    bias = bias.astype(np.float32)
    ref = jax.jit(JV.memory_attention_forward, static_argnums=(1, 7, 8))(
        jvp["mem_attn"], VCFG, jnp.asarray(tokens), jnp.asarray(tok_pe), jnp.asarray(mem),
        jnp.asarray(pos), jnp.asarray(bias), (h, w), n_spatial)
    got = TV.memory_attention_forward(
        tvp["mem_attn"], VCFG, torch.from_numpy(tokens), torch.from_numpy(tok_pe),
        torch.from_numpy(mem), torch.from_numpy(pos), torch.from_numpy(bias), (h, w), n_spatial)
    _close(got, ref)


@pytest.fixture(scope="module")
def features(weights):
    jp, _, tp, _ = weights
    img = _frames(1)[0][None]
    return (JV._encode_video_frame(jp, CFG, jnp.asarray(img)),
            T.encode_features(tp, CFG, torch.from_numpy(img)))


@pytest.mark.parametrize("is_cond", [True, False])
def test_condition_and_decode_matches_jax(weights, features, is_cond):
    """One step with a partly filled bank. On the conditioning frame the
    reference runs memory attention on that bank and discards the result;
    the port skips it, and the outputs agree all the same."""
    jp, jvp, tp, tvp = weights
    bank = _bank(np.random.default_rng(3), (S // 16) ** 2)
    pts, lbs = np.asarray([[[0.45, 0.4]]], np.float32), np.ones((1, 1), np.int32)
    ref = JV._condition_and_decode(jp, jvp, CFG, VCFG, *features[0],
                                   *(jnp.asarray(v) for v in bank.values()), jnp.asarray(pts),
                                   jnp.asarray(lbs), jnp.asarray(is_cond), jnp.asarray(True))
    got = TV._condition_and_decode(tp, tvp, CFG, VCFG, *features[1],
                                   *(torch.from_numpy(v) for v in bank.values()),
                                   torch.from_numpy(pts), torch.from_numpy(lbs),
                                   is_cond=is_cond, multimask=True)
    for g, r in zip(got, ref):  # mask logits, object score, pointer, memory, its code
        _close(g, r)


def _propagate(pred, frames, to_np):
    state = pred.init_state(frames)
    pred.add_new_points(state, 0, 1, np.asarray([[[60.0, 55.0]]], np.float32),
                        np.ones((1, 1), np.int32))
    outs = [to_np(logits[0]) for _, _, logits in pred.propagate_in_video(state)]
    return outs, state


def test_propagate_in_video_matches_jax_over_three_frames(weights):
    jp, jvp, tp, tvp = weights
    frames = _frames(3)
    ref, jstate = _propagate(JV.Sam2VideoPredictor(jp, jvp, CFG, VCFG), frames, np.asarray)
    got, tstate = _propagate(TV.Sam2VideoPredictor(tp, tvp, CFG, VCFG), frames,
                             lambda t: t.numpy())
    assert len(got) == 3
    for g, r in zip(got, ref):
        _close(g, r)
        np.testing.assert_array_equal(g > 0, r > 0)
    for key in ("mem_valid", "mem_frame", "ptr_valid", "ptr_frame"):
        np.testing.assert_array_equal(tstate[key], jstate[key])
    _close(tstate["mem_feat"], jstate["mem_feat"])
    _close(tstate["obj_ptrs"], jstate["obj_ptrs"])


def test_tpos_indices_follow_recency(weights):
    """The same bank views as the reference's on a bank whose round-robin
    slots are out of frame order (tests/test_sam2_video.py's case)."""
    jp, jvp, tp, tvp = weights
    views = []
    for pred in (JV.Sam2VideoPredictor(jp, jvp, CFG, VCFG),
                 TV.Sam2VideoPredictor(tp, tvp, CFG, VCFG)):
        state = pred.init_state(_frames(1))
        nm = VCFG.num_maskmem
        state["mem_valid"][:] = False
        for t in [7, 8, 9, 10, 11]:
            state["mem_valid"][1 + t % (nm - 1)] = True
            state["mem_frame"][1 + t % (nm - 1)] = t
        state["mem_valid"][0], state["mem_frame"][0] = True, 0
        _, _, valid, tpos, _, ptr_valid = pred._bank_views(state, t=12, cond_idx=0)
        views.append([np.asarray(valid), np.asarray(tpos), np.asarray(ptr_valid)])
    for a, b in zip(*views):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("carry_memory", [False, True])
def test_video_refiner_matches_jax(weights, carry_memory):
    """Three SLAM frames through each side's refiner; with carry_memory the
    second and third are conditioned on the bank of the earlier ones."""
    jp, jvp, tp, tvp = weights
    h, w = 48, 64
    jr = JV.Sam2VideoRefiner(jp, jvp, CFG, VCFG, carry_memory=carry_memory)
    tr = TV.Sam2VideoRefiner(tp, tvp, CFG, VCFG, carry_memory=carry_memory)
    for i, frame in enumerate(_frames(3)):
        img = np.ascontiguousarray((frame[: 2 * h : 2, : 2 * w : 2] * 255).astype(np.uint8))
        raw = np.zeros((h, w), bool)
        raw[10:30, 16 + 4 * i : 40 + 4 * i] = True
        raw[36:44, 50:60] = True
        err = raw.astype(np.float32)
        ref = jr(img, err, raw, 0.35, 20)
        got = tr(img, err, raw, 0.35, 20)
        assert got.dtype == bool and got.shape == (h, w)
        np.testing.assert_array_equal(got, ref)
    assert tr.calls == tr.replaced == 3
    if carry_memory:
        assert len(tr._state["images"]) == 3 and tr._state["images"][:2] == [None, None]
        assert tr._state["mem_valid"].sum() == 3
    else:
        assert tr._state is None
    empty = np.zeros((h, w), bool)
    np.testing.assert_array_equal(tr(img, err * 0, empty, 0.35, 20), empty)


def _video_sd(jvp, sd):
    """Add the official names of the memory modules to a state dict, each
    leaf in its torch layout (the reverse of the converter)."""
    def put(name, a, layout=None):
        a = np.asarray(a)
        sd[name] = torch.from_numpy(np.array(a if layout is None else layout(a)))

    def lin(name, p):
        put(f"{name}.weight", p["w"], lambda a: a.T)
        put(f"{name}.bias", p["b"])

    def ln(name, p):
        put(f"{name}.weight", p["w"])
        put(f"{name}.bias", p["b"])

    def cv(name, p):
        put(f"{name}.weight", p["w"], lambda a: a.transpose(3, 2, 0, 1))
        put(f"{name}.bias", p["b"])

    me, ma = "memory_encoder", "memory_attention"
    sd.pop(f"{me}.out_proj.weight", None)
    cv(f"{me}.pix_feat_proj", jvp["mem_enc"]["pix_feat_proj"])
    for i, (conv, norm) in enumerate(jvp["mem_enc"]["downsampler"]):
        cv(f"{me}.mask_downsampler.encoder.{3 * i}", conv)
        ln(f"{me}.mask_downsampler.encoder.{3 * i + 1}", norm)
    cv(f"{me}.mask_downsampler.encoder.12", jvp["mem_enc"]["down_out"])
    for i, blk in enumerate(jvp["mem_enc"]["fuser"]):
        b = f"{me}.fuser.layers.{i}"
        cv(f"{b}.dwconv", blk["dwconv"])
        ln(f"{b}.norm", blk["norm"])
        lin(f"{b}.pwconv1", blk["pwconv1"])
        lin(f"{b}.pwconv2", blk["pwconv2"])
        put(f"{b}.gamma", blk["gamma"])
    cv(f"{me}.out_proj", jvp["mem_enc"]["out_proj"])
    for i, L in enumerate(jvp["mem_attn"]["layers"]):
        b = f"{ma}.layers.{i}"
        for name, ap in (("self_attn", L["self_attn"]), ("cross_attn_image", L["cross_attn"])):
            for k in ("q", "k", "v", "out"):
                lin(f"{b}.{name}.{k}_proj", ap[k])
        for k in ("norm1", "norm2", "norm3"):
            ln(f"{b}.{k}", L[k])
        lin(f"{b}.linear1", L["linear1"])
        lin(f"{b}.linear2", L["linear2"])
    ln(f"{ma}.norm", jvp["mem_attn"]["norm"])
    for j, lp in enumerate(jvp["obj_ptr_proj"]):
        lin(f"obj_ptr_proj.layers.{j}", lp)
    for j, lp in enumerate(jvp["obj_score_head"]):
        lin(f"sam_mask_decoder.pred_obj_score_head.layers.{j}", lp)
    put("no_obj_ptr", jvp["no_obj_ptr"], lambda a: a[None])
    put("maskmem_tpos_enc", jvp["maskmem_tpos_enc"], lambda a: a[:, None, None, :])
    return sd


def test_video_params_from_torch_on_a_synthetic_state_dict(tmp_path, weights):
    jp, jvp, tp, tvp = weights
    path = tmp_path / "sam2_video.pt"
    torch.save({"model": _video_sd(jvp, _fabricate_torch_sd(jp, CFG))}, path)
    # the reference's converter reads the same file to the same trees
    jimg, jvid = JV.video_params_from_torch(str(path), CFG, VCFG)
    img, vid = TV.video_params_from_torch(str(path), CFG, VCFG)
    for got, want, ref in ((img, tp, jimg), (vid, tvp, jvid)):
        got, want, ref = _flat(got), _flat(want), _flat(ref)
        assert set(got) == set(want) == set(ref)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_init_video_params_has_the_reference_tree():
    want = jax.eval_shape(lambda k: JV.init_video_params(k, CFG, VCFG), jax.random.PRNGKey(0))
    got = TV.init_video_params(torch.Generator().manual_seed(0), T.SAM2_TEST, VCFG)
    assert _shapes(got) == _shapes(want)
