"""The port's Easi3R (`dynamic/easi3r.py` and the biased cross-attention of
`models/blocks.py`) against the JAX package's, TINY without a descriptor
head (the DUSt3R architecture), 64x80 frames: the twins of
tests/test_easi3r.py's four tests on the port, then the same numpy inputs
through both packages.

* `cross_attention` with `mem_bias` and the column sums, with an identity
  output projection so that the attention output itself is compared: in f32
  within 2e-5 (the summation order of the f32 logits and products); in bf16
  each element within one bf16 rounding, 2^-8 of its magnitude (the
  bias-free attention's bound in tests/test_torch_models_bf16.py: the f32
  logits sum in another order, and the bf16 product may round the other
  way); the column sums in f32 within 1e-5 in both types.
* `attention_dynamic_mask` equal to the reference's on even and odd token
  counts and with ties, its median equal to `jnp.median` bit for bit.
* `_decode_pair_attn` in f32: the hook activations within 1e-4 of their
  scale and the received attention within 1e-5.
* `easi3r_double_inference_pair`: in f32 (the reference's decoder forced to
  f32) X and C within 2e-5 of their scale (measured 2.3e-6); in bf16, the
  reference's only mode, within twice the reference's own distance from its
  f32 run per output (the bound of tests/test_torch_models_bf16.py; measured
  0.74-1.56 times); the masks equal in both.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.dynamic import easi3r as jeasi3r
from monst3r_slam_tpu.models import blocks as jblocks
from monst3r_slam_tpu.models import mast3r as jmodel
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.models.init import init_params
from monst3r_slam_torch.dynamic import easi3r as teasi3r
from monst3r_slam_torch.models import blocks as tblocks
from monst3r_slam_torch.models import croco as tcroco
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.models.convert import params_from_jax
from tests.test_torch_slam import one_torch_thread  # noqa: F401

JCFG = dataclasses.replace(JTINY, desc_dim=None, two_confs=False)
TCFG = dataclasses.replace(TTINY, desc_dim=None, two_confs=False)
H, W = 64, 80


@pytest.fixture(scope="module")
def setup():
    """JAX's random weights carried over, and the JAX encoder's f32
    features of two frames fed to both decoders."""
    jp = init_params(jax.random.PRNGKey(0), JCFG)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    feats = []
    for key in (1, 2):
        img = jax.random.normal(jax.random.PRNGKey(key), (1, H, W, 3)) * 0.5
        feats += list(jmodel.encode(jp, JCFG, img, dtype=jnp.float32))
    tfeats = [torch.from_numpy(np.array(a)) for a in feats]
    return jp, tp, feats, tfeats


def test_attention_colsums_normalized(setup):
    _, tp, _, (f1, p1, f2, p2) = setup
    _, _, attn1, attn2 = teasi3r._decode_pair_attn(tp, TCFG, f1, p1, f2, p2, dtype=torch.float32)
    # each layer's attention rows sum to 1, so the normalized mean mass is 1
    assert abs(float(attn1.mean()) - 1.0) < 1e-3 and abs(float(attn2.mean()) - 1.0) < 1e-3


def test_unbiased_matches_plain_decode(setup):
    _, tp, _, (f1, p1, f2, p2) = setup
    dec1, _, _, _ = teasi3r._decode_pair_attn(tp, TCFG, f1, p1, f2, p2, dtype=torch.float32)
    ref1, _ = tcroco.decode_pair(tp, TCFG, f1, p1, f2, p2, torch.float32)
    for a, b in zip(dec1, ref1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-3)


def test_dynamic_mask_flags_low_attention():
    attn = torch.ones((1, 100))
    attn[0, 10:13] = 0.1
    mask = teasi3r.attention_dynamic_mask(attn, k_mad=2.0)
    assert bool(mask[0, 10]) and bool(mask[0, 11]) and int(mask.sum()) == 3


def test_double_inference_shapes(setup):
    _, tp, _, (f1, p1, f2, p2) = setup
    out = teasi3r.easi3r_double_inference_pair(tp, TCFG, f1, p1, f2, p2, (H, W))
    assert out.X1.shape == (1, H, W, 3) and out.dyn_mask1.shape == (1, H, W)
    assert out.dyn_mask1.dtype == torch.bool
    assert bool(torch.isfinite(out.X1).all()) and bool(torch.isfinite(out.C1).all())


def _cross_inputs(rng, dtype):
    """A cross-attention's parameters (identity output projection) and
    inputs, as JAX arrays and torch tensors of equal values."""
    d, nq, nk = 64, 20, 30
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    w = {n: (0.2 * rng.standard_normal((d, d))).astype(np.float32) for n in "qkv"}
    b = {n: (0.1 * rng.standard_normal(d)).astype(np.float32) for n in "qkv"}
    jp = {n: {"w": jnp.asarray(w[n], jdt), "b": jnp.asarray(b[n])} for n in "qkv"}
    tp = {n: {"w": torch.from_numpy(np.array(jp[n]["w"].astype(jnp.float32)).T.copy()).to(tdt),
              "b": torch.from_numpy(b[n])} for n in "qkv"}
    jp["proj"] = {"w": jnp.eye(d, dtype=jdt)}
    tp["proj"] = {"w": torch.eye(d, dtype=tdt)}
    x = jnp.asarray(rng.standard_normal((2, nq, d)), jdt)
    mem = jnp.asarray(rng.standard_normal((2, nk, d)), jdt)
    grid = np.stack(np.meshgrid(np.arange(5), np.arange(6), indexing="ij"), -1).reshape(30, 2)
    xpos, mpos = np.tile(grid[:nq], (2, 1, 1)), np.tile(grid, (2, 1, 1))
    bias = np.where(rng.uniform(size=(2, nk)) < 0.3, -10.0, 0.0).astype(np.float32)
    jargs = (x, mem, jnp.asarray(xpos), jnp.asarray(mpos))
    targs = tuple(torch.from_numpy(np.array(a.astype(jnp.float32) if a.dtype == jdt else a))
                  for a in jargs)
    targs = (targs[0].to(tdt), targs[1].to(tdt)) + targs[2:]
    return jp, tp, jargs, targs, bias


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("biased", [True, False])
def test_cross_attention_bias_and_colsum_match_jax(dtype, biased):
    jp, tp, jargs, targs, bias = _cross_inputs(np.random.default_rng(0), dtype)
    jb, tb = (jnp.asarray(bias), torch.from_numpy(bias)) if biased else (None, None)
    jy, jcs = jblocks.cross_attention(jp, *jargs, 4, 100.0, mem_bias=jb, return_attn_colsum=True)
    ty, tcs = tblocks.cross_attention(tp, *targs, 4, 100.0, mem_bias=tb, return_attn_colsum=True)
    assert ty.dtype == targs[0].dtype and tcs.dtype == torch.float32
    ref, got = np.asarray(jy.astype(jnp.float32)), ty.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    else:
        np.testing.assert_array_less(np.abs(got - ref), 2.0**-8 * np.abs(ref) + 1e-30)
    np.testing.assert_allclose(tcs.numpy(), np.asarray(jcs), atol=1e-5, rtol=0)
    if biased:  # the biased tokens draw almost no attention
        assert float(tcs[torch.from_numpy(bias) < 0].max()) < 1e-2
    # without the bias and the column sums the call takes sdpa's path
    y_plain = tblocks.cross_attention(tp, *targs, 4, 100.0)
    y_ref = jblocks.cross_attention(jp, *jargs, 4, 100.0)
    tol = 2e-5 if dtype == "f32" else 2.0**-8 * np.abs(np.asarray(y_ref.astype(jnp.float32)))
    assert (np.abs(y_plain.float().numpy() - np.asarray(y_ref.astype(jnp.float32))) <= tol).all()


def _mask_cases():
    rng = np.random.default_rng(3)
    cases = {f"random{n}": rng.standard_normal((3, n)).astype(np.float32) + 1.0
             for n in (20, 21, 768, 769)}
    # ties: values on a coarse grid, so the middle values repeat
    cases["ties_even"] = np.round(rng.uniform(0, 2, (4, 20)) * 4).astype(np.float32) / 4
    cases["ties_odd"] = np.round(rng.uniform(0, 2, (4, 21)) * 4).astype(np.float32) / 4
    # an even count whose two middle values differ: the lower one as the
    # median (torch.median) flags token 0, the midpoint (jnp.median) does not
    cases["midpoint"] = np.asarray([[0.45, 0.5, 1.0, 1.0, 1.5, 2.0]], np.float32)
    # all equal: MAD 0, clamped to 1e-6; nothing strictly under the median
    cases["constant"] = np.ones((2, 20), np.float32)
    return cases


@pytest.mark.parametrize("name", sorted(_mask_cases()))
def test_attention_dynamic_mask_matches_jax(name):
    attn = _mask_cases()[name]
    for k_mad in (0.5, 1.0, 2.0):
        ref = np.asarray(jeasi3r.attention_dynamic_mask(jnp.asarray(attn), k_mad))
        got = teasi3r.attention_dynamic_mask(torch.from_numpy(attn), k_mad).numpy()
        np.testing.assert_array_equal(got, ref)
    med = teasi3r._median(torch.from_numpy(attn)).numpy()
    np.testing.assert_array_equal(med, np.asarray(jnp.median(jnp.asarray(attn), axis=-1,
                                                             keepdims=True)))
    if name == "midpoint":
        assert not got[0, 0] and torch.median(torch.from_numpy(attn)).item() == 1.0


def test_decode_pair_attn_matches_jax_f32(setup):
    jp, tp, jf, tf = setup
    jd1, jd2, ja1, ja2 = jeasi3r._decode_pair_attn(jp, JCFG, *jf, dtype=jnp.float32)
    td1, td2, ta1, ta2 = teasi3r._decode_pair_attn(tp, TCFG, *tf, dtype=torch.float32)
    for a, b in zip(jd1 + jd2, td1 + td2):
        assert b.dtype == torch.float32
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4 * np.abs(a).max(), rtol=0)
    for a, b in ((ja1, ta1), (ja2, ta2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)


def _jax_double(jp, jf, dtype):
    """The reference's double inference; with f32 its decoder forced to f32
    (the reference's own dtype is bf16, fixed inside the function)."""
    if dtype == "bf16":
        return jeasi3r.easi3r_double_inference_pair(jp, JCFG, *jf, (H, W))
    orig = jeasi3r._decode_pair_attn
    jeasi3r._decode_pair_attn = functools.partial(orig, dtype=jnp.float32)
    try:  # a new function under jit traces the patched decoder (jit caches by function)
        fn = jax.jit(lambda p, *f: jeasi3r.easi3r_double_inference_pair.__wrapped__(
            p, JCFG, *f, (H, W)))
        return jax.block_until_ready(fn(jp, *jf))
    finally:
        jeasi3r._decode_pair_attn = orig


@pytest.fixture(scope="module")
def double_outputs(setup):
    jp, tp, jf, tf = setup
    out = {}
    for dtype, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        j = _jax_double(jp, jf, dtype)
        t = teasi3r.easi3r_double_inference_pair(tp, TCFG, *tf, (H, W), dtype=tdt)
        out["jax", dtype] = {n: np.asarray(getattr(j, n)).astype(np.float32) for n in j._fields}
        out["port", dtype] = {n: getattr(t, n).float().numpy() for n in t._fields}
    return out


@pytest.mark.parametrize("name", ["X1", "C1", "X2", "C2"])
def test_double_inference_matches_jax(double_outputs, name):
    ref32, got32 = double_outputs["jax", "f32"][name], double_outputs["port", "f32"][name]
    assert np.isfinite(got32).all()
    np.testing.assert_allclose(got32, ref32, atol=2e-5 * np.abs(ref32).max(), rtol=0)
    ref, got = double_outputs["jax", "bf16"][name], double_outputs["port", "bf16"][name]
    own = float(np.abs(ref - ref32).max())  # the reference's own bf16 rounding
    err = float(np.abs(got - ref).max())
    assert 0 < own and err <= 2.0 * own, (name, err, own)


def test_double_inference_masks_match_jax(double_outputs):
    for dtype in ("f32", "bf16"):
        for name in ("dyn_mask1", "dyn_mask2"):
            ref, got = double_outputs["jax", dtype][name], double_outputs["port", dtype][name]
            np.testing.assert_array_equal(got, ref)
    # a patch is flagged on one side at least, so the bias of pass 2 acts
    assert double_outputs["port", "bf16"]["dyn_mask1"].any()
