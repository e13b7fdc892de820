"""Parity of the port's model (TINY config, 64x80 frames, float32) with the
JAX package, given the same weights carried over by `params_from_jax`.

Tolerance: each output within 1e-4 of its own max magnitude. Both run the
same f32 graph; the difference is summation order through ~20 layers
(measured ~5e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.models import convert as jconvert
from monst3r_slam_tpu.models import init as jinit
from monst3r_slam_tpu.models import mast3r as jmodel
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_torch.models import config as tconfig
from monst3r_slam_torch.models import init as tinit
from monst3r_slam_torch.models import mast3r as tmodel
from monst3r_slam_torch.models.convert import cast_params_for_inference, params_from_jax

H, W = 64, 80
REL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jp = jinit.init_params(jax.random.PRNGKey(0), JTINY)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def encoded(weights):
    jp, tp = weights
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32) for _ in range(2)]
    j = [jmodel.encode(jp, JTINY, jnp.asarray(im), dtype=jnp.float32) for im in imgs]
    t = [tmodel.encode(tp, tconfig.TINY, torch.from_numpy(im), dtype=torch.float32) for im in imgs]
    return j, t


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=REL * float(np.abs(ref).max()), rtol=0)


def test_config_copy_matches():
    from monst3r_slam_tpu.models.config import MAST3R_512 as JMAST3R

    assert vars(tconfig.TINY) == vars(JTINY)
    assert vars(tconfig.MAST3R_512) == vars(JMAST3R)


def test_encode_matches_jax(encoded):
    (jres, tres) = encoded
    for (fj, pj), (ft, pt) in zip(jres, tres):
        assert ft.dtype == torch.float32 and ft.shape == fj.shape
        _close(ft.numpy(), fj)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


@pytest.mark.parametrize("pair", ["cross", "mono"])
def test_decode_matches_jax(weights, encoded, pair):
    jp, tp = weights
    (jres, tres) = encoded
    b = 0 if pair == "mono" else 1
    oj = jmodel.decode(jp, JTINY, *jres[0], *jres[b], (H, W), dtype=jnp.float32)
    if pair == "mono":
        ot = tmodel.inference_mono(tp, tconfig.TINY, *tres[0], (H, W), dtype=torch.float32)
    else:
        ot = tmodel.decode(tp, tconfig.TINY, *tres[0], *tres[b], (H, W), dtype=torch.float32)
    for name in oj._fields:
        got, ref = getattr(ot, name), getattr(oj, name)
        assert tuple(got.shape) == tuple(ref.shape), name
        _close(got.numpy(), ref)


def test_decode_matches_jax_with_heads_wider_than_256():
    """TINY re-headed to one encoder head 320 wide and one decoder head 288
    wide (one encoder and two decoder blocks, the fewest whose DPT hooks
    are distinct), as a checkpoint's constructor string may give it: the
    encode and a cross decode against JAX's, the weights carried over by
    `params_from_jax`, within `REL` of each output's scale. The weights are
    drawn with numpy into the initializer's tree (its shapes from
    `jax.eval_shape`; JAX's own initializer takes ~18 s at these widths):
    normal with variance 1 / fan-in for matrices and kernels, 1 + 0.1 normal
    for vectors."""
    import dataclasses

    wide = dict(enc_depth=1, enc_dim=320, enc_heads=1, dec_depth=2, dec_dim=288, dec_heads=1)
    jcfg, tcfg = (dataclasses.replace(c, **wide) for c in (JTINY, tconfig.TINY))
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(lambda: jinit.init_params(jax.random.PRNGKey(1), jcfg))
    jp = jax.tree.map(
        lambda a: jnp.asarray((rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
                               if len(a.shape) > 1 else 1 + 0.1 * rng.standard_normal(a.shape)),
                              a.dtype), shapes)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    imgs = [rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32) for _ in range(2)]
    j = [jmodel.encode(jp, jcfg, jnp.asarray(im), dtype=jnp.float32) for im in imgs]
    t = [tmodel.encode(tp, tcfg, torch.from_numpy(im), dtype=torch.float32) for im in imgs]
    for (fj, _), (ft, _) in zip(j, t):
        _close(ft.numpy(), fj)
    oj = jmodel.decode(jp, jcfg, *j[0], *j[1], (H, W), dtype=jnp.float32)
    ot = tmodel.decode(tp, tcfg, *t[0], *t[1], (H, W), dtype=torch.float32)
    for name in oj._fields:
        got, ref = getattr(ot, name), getattr(oj, name)
        assert tuple(got.shape) == tuple(ref.shape) and bool(np.isfinite(ref).all()), name
        _close(got.numpy(), ref)


def test_init_params_matches_jax_tree(weights):
    """The port's own initializer builds the converted tree's structure,
    shapes and scales (not its numbers: the generators differ)."""
    _, tp = weights
    mine = tinit.init_params(torch.Generator().manual_seed(0), tconfig.TINY)

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            if a.numel() > 64:
                assert abs(float(a.std()) - float(b.std())) < 0.25 * float(b.std()) + 1e-6, path

    walk(mine, tp)


def test_cast_params_matches_jax_cast(weights):
    """bf16 where the reference casts (matmul/conv weights, block layernorm
    weights), f32 elsewhere; same values after the cast."""
    jp, tp = weights
    jc = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      jconvert.cast_params_for_inference(jp)))
    jdt = jax.tree.map(lambda a: a.dtype == jnp.bfloat16, jconvert.cast_params_for_inference(jp))
    tc = cast_params_for_inference(tp)
    flat_j = {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v
        for path, v in jax.tree_util.tree_flatten_with_path(jdt)[0]
    }
    n_bf16 = 0
    for name, is_bf16 in flat_j.items():
        parts = name.split("/")
        node = tc
        if parts[0] in ("enc_blocks", "dec_blocks", "dec_blocks2"):
            node = node[parts[0]][0]
            parts = parts[1:]
        for p in parts:
            node = node[int(p)] if isinstance(node, list) else node[p]
        assert (node.dtype == torch.bfloat16) == bool(is_bf16), name
        n_bf16 += bool(is_bf16)
    assert n_bf16 > 0
    # values: casting the converted tree equals converting the cast tree
    ref = jc["enc_blocks"][0]["attn"]["qkv"]["w"]
    got = tc["enc_blocks"][0]["attn"]["qkv"]["w"].float()
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
