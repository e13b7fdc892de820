"""The port's RAFT (`monst3r_slam_torch/dynamic/raft.py`) against the JAX
package's, at RAFT's full widths (hidden and context 128, 4 levels, radius
4) with 2-3 iterations, on 64x80 images from a numpy seed, with the JAX
weights carried over by `raft_params_from_numpy`. Both sides in f32.

Tolerances: a single convolution within 1e-5 (f32 summation order); the
encoders' 1/8-res outputs within 1e-4 of their scale (13 convolutions and
instance norms); the correlation lookup within 1e-5 (the JAX package's
default one-hot matmul form against the port's gather form, the bound
tests/test_raft.py holds the two forms of the JAX package to);
`convex_upsample` within 1e-5; the flow within 1e-3 px after 2 iterations;
the fused error map within 1e-4 in f32 and one uint8 step (1/255) in u8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.core import lie as jlie
from monst3r_slam_tpu.dynamic import raft as jraft
from monst3r_slam_torch.dynamic import raft as traft
from tests.test_torch_slam import one_torch_thread  # noqa: F401

H, W = 64, 80
CFG = (2, 3)


@pytest.fixture(scope="module")
def weights():
    jp = jraft.init_raft_params(jax.random.PRNGKey(0), jraft.RAFTConfig())
    return jp, traft.raft_params_from_numpy(jax.tree.map(np.asarray, jp))


def _images(seed=0, shift=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = sum(np.sin(rng.uniform(0.05, 0.4) * xx[..., None] + rng.uniform(0.05, 0.4)
                     * yy[..., None] + rng.uniform(0, 6.3, 3)) for _ in range(5))
    u0 = np.uint8(np.clip((img / np.abs(img).max() * 0.5 + 0.5) * 255, 0, 255))
    return u0, np.roll(u0, shift, axis=1)


def _nhwc(x):  # port NCHW -> JAX NHWC numpy
    return x.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("size", [(H, W), (33, 47)])
def test_stem_conv_pads_as_xla_same(weights, size):
    """The 7x7 stride-2 stem alone, with XLA's asymmetric SAME padding: on
    an even size (2 before, 3 after), not torch RAFT's (3, 3)."""
    jp, tp = weights
    x = np.random.default_rng(1).standard_normal((1, *size, 3)).astype(np.float32)
    ref = np.asarray(jraft.conv(jp["fnet"]["conv1"], jnp.asarray(x), stride=2))
    got = traft.conv(tp["fnet"]["conv1"], torch.from_numpy(x).permute(0, 3, 1, 2), stride=2)
    np.testing.assert_allclose(_nhwc(got), ref, atol=1e-5)
    assert traft._same_pad(64, 7, 2) == (2, 3) and traft._same_pad(64, 3, 2) == (0, 1)


@pytest.mark.parametrize("net", ["fnet", "cnet"])
def test_encoders_match_jax(weights, net):
    jp, tp = weights
    x = np.random.default_rng(2).uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    ref = np.asarray(jraft.encoder(jp[net], jnp.asarray(x)))
    got = _nhwc(traft.encoder(tp[net], torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == ref.shape == (1, H // 8, W // 8, 256)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_corr_pyramid_and_lookup_match_jax():
    rng = np.random.default_rng(3)
    f1, f2 = (rng.standard_normal((H // 8, W // 8, 256)).astype(np.float32) for _ in range(2))
    jpyr = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    tpyr = traft.corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    for a, b in zip(tpyr, jpyr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # flows that push the radius-4 window past every border at every level
    flow = (4.0 * rng.standard_normal((H // 8, W // 8, 2))).astype(np.float32)
    ref = np.asarray(jraft.corr_lookup(jpyr, jnp.asarray(flow), 4))
    got = traft.corr_lookup(tpyr, torch.from_numpy(flow), 4).numpy()
    assert got.shape == ref.shape == (H // 8, W // 8, 4 * 81)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_convex_upsample_matches_jax():
    rng = np.random.default_rng(4)
    flow = rng.standard_normal((5, 7, 2)).astype(np.float32)
    mask = rng.standard_normal((5, 7, 9 * 64)).astype(np.float32)
    ref = np.asarray(jraft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = traft.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("iters", CFG)
def test_raft_flow_matches_jax(weights, iters):
    jp, tp = weights
    u0, u1 = _images()
    ref = np.asarray(jraft.raft_flow(jp, jnp.asarray(u0, jnp.float32), jnp.asarray(u1, jnp.float32),
                                     jraft.RAFTConfig(iters=iters)))
    got = traft.raft_flow(tp, torch.from_numpy(u0).float(), torch.from_numpy(u1).float(),
                          traft.RAFTConfig(iters=iters)).numpy()
    assert got.shape == (H, W, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-3)


def _pose_pair():
    T_i = np.asarray(jlie.sim3_identity())
    T_j = np.asarray(jlie.sim3_retr(jnp.asarray(T_i),
                                    jnp.asarray([0.02, 0.0, 0.0, 0.0, 0.01, 0.0, 0.0])))
    K = np.asarray([[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]], np.float32)
    depth = (2.0 + np.random.default_rng(5).uniform(0, 1, (H, W))).astype(np.float32)
    return T_i, T_j, depth, K


@pytest.mark.parametrize("out_u8", [False, True])
def test_fused_flow_error_program_matches_jax(weights, out_u8):
    jp, tp = weights
    u0, u1 = _images()
    T_i, T_j, depth, K = _pose_pair()
    cfg_j, cfg_t = jraft.RAFTConfig(iters=2), traft.RAFTConfig(iters=2)
    ref = jraft.make_fused_flow_error_program(jp, cfg_j, out_u8=out_u8)(
        u0, u1, jnp.asarray(T_i), jnp.asarray(T_j), jnp.asarray(depth), jnp.asarray(K))
    calls = []
    got = traft.make_fused_flow_error_program(tp, cfg_t, out_u8=out_u8)(
        u0, u1, T_i, T_j, depth, K, overlap_cb=lambda: calls.append(1))
    assert calls == [1]
    assert got.shape == (H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1.0 / 255 + 1e-6 if out_u8 else 1e-4)


def test_fused_program_device_input_is_bit_identical(weights):
    """The normalized image the encoder consumed, with or without its batch
    dim, gives the error map of the uint8 upload bit for bit; a repeated
    host array (the keyframe) hits the device cache, an equal copy too."""
    _, tp = weights
    u0, u1 = _images(seed=6)
    T_i, T_j, depth, K = _pose_pair()
    fused = traft.make_fused_flow_error_program(tp, traft.RAFTConfig(iters=2))
    ref = fused(u0, u1, T_i, T_j, depth, K)
    norm = torch.from_numpy((u0.astype(np.float32) / 255.0 - 0.5) / 0.5)
    np.testing.assert_array_equal(fused(norm, u1, T_i, T_j, depth, K), ref)
    np.testing.assert_array_equal(fused(norm[None], u1, T_i, T_j, depth, K), ref)
    np.testing.assert_array_equal(fused(u0, u1, T_i, T_j, depth, K), ref)
    np.testing.assert_array_equal(fused(u0.copy(), u1.copy(), T_i, T_j, depth, K), ref)
    assert (traft._to_255(norm) == torch.from_numpy(u0).float()).all()


def test_raft_params_from_torch_matches_jax_converter(tmp_path, weights):
    """A synthetic torch RAFT state dict in the official naming (module.
    prefix, OIHW weights, cnet norms as affine weights): the port's
    converter gives the JAX converter's weights on the same file."""
    jp, _ = weights
    sd = {}

    def put_conv(name, p):
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(p["w"]).transpose(3, 2, 0, 1).copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["b"]).copy())

    def put_norm(name, p):
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(p["w"]).copy() + 0.5)
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["b"]).copy() - 0.25)

    for pfx in ("fnet", "cnet"):
        enc = jp[pfx]
        put_conv(f"{pfx}.conv1", enc["conv1"])
        put_conv(f"{pfx}.conv2", enc["conv2"])
        if pfx == "cnet":  # a batch-norm context net: running stats are dropped
            put_norm(f"{pfx}.norm1", enc["norm1"])
            sd[f"{pfx}.norm1.running_mean"] = torch.zeros(64)
        for blk, (li, bi) in zip(enc["layers"], traft._TORCH_LAYERS):
            name = f"{pfx}.layer{li}.{bi}"
            put_conv(f"{name}.conv1", blk["conv1"])
            put_conv(f"{name}.conv2", blk["conv2"])
            if "downsample" in blk:
                put_conv(f"{name}.downsample.0", blk["downsample"])
    up = jp["update"]
    for k in traft._ENCODER_CONVS:
        put_conv(f"update_block.encoder.{k}", up["encoder"][k])
    for k in traft._GRU_CONVS:
        put_conv(f"update_block.gru.{k}", up["gru"][k])
    put_conv("update_block.flow_head.conv1", up["flow_head"]["conv1"])
    put_conv("update_block.flow_head.conv2", up["flow_head"]["conv2"])
    put_conv("update_block.mask.0", up["mask"]["conv1"])
    put_conv("update_block.mask.2", up["mask"]["conv2"])
    path = tmp_path / "raft.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)

    ref = traft.raft_params_from_numpy(jax.tree.map(np.asarray, jraft.raft_params_from_torch(str(path))))
    got = traft.raft_params_from_torch(str(path))
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_got.keys() == flat_ref.keys()
    assert got["cnet"]["norm1"]["w"].shape == (64,) and got["fnet"]["norm1"] == {}
    for k, v in flat_ref.items():
        assert torch.equal(flat_got[k], v), k
    u0, u1 = _images()
    f_ref = jraft.raft_flow(jraft.raft_params_from_torch(str(path)), jnp.asarray(u0, jnp.float32),
                            jnp.asarray(u1, jnp.float32), jraft.RAFTConfig(iters=2))
    f_got = traft.raft_flow(got, torch.from_numpy(u0).float(), torch.from_numpy(u1).float(),
                            traft.RAFTConfig(iters=2))
    np.testing.assert_allclose(f_got.numpy(), np.asarray(f_ref), atol=1e-3)


@pytest.mark.parametrize("padding", ["VALID", ((1, 2), (0, 3))])
def test_conv_padding_matches_jax(weights, padding):
    """`conv(padding=)` with XLA's VALID and explicit pads, a 3x3 stride-2
    and the 7x7 stem, within 1e-5."""
    jp, tp = weights
    x = np.random.default_rng(9).standard_normal((1, 17, 22, 64)).astype(np.float32)
    for jc, tc, stride in ((jp["fnet"]["layers"][2]["conv1"], tp["fnet"]["layers"][2]["conv1"], 2),
                           (jp["fnet"]["layers"][0]["conv1"], tp["fnet"]["layers"][0]["conv1"], 1)):
        ref = np.asarray(jraft.conv(jc, jnp.asarray(x), stride=stride, padding=padding))
        got = _nhwc(traft.conv(tc, torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride,
                               padding=padding))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5 * max(1.0, np.abs(ref).max()))
