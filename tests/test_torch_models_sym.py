"""Twins of the JAX package's fused-head decode (`decode(fused_heads=True)`)
and symmetric inference (`inference_sym`) in the port, TINY config, 64x80
frames, the same weights carried over by `params_from_jax`:

* f32: every output within 1e-4 of its own max magnitude of JAX's, as
  tests/test_torch_models.py holds the decode; and the port's fused heads
  within 1e-4 of its unfused ones (a grouped convolution sums in another
  order);
* bf16 (weights cast by `cast_params_for_inference` on both sides): every
  output within twice JAX's own bf16 distance from its f32 run, the bound of
  tests/test_torch_models_bf16.py; the fused heads round at the unfused
  heads' places, so the port's fused and unfused bf16 outputs are held to
  the same bound;
* `inference_sym` splits its batch of 2b into the orders (i, j) and (j, i):
  each half equals the port's own decode of that order.
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
from monst3r_slam_torch.models import mast3r as tmodel
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.models.convert import cast_params_for_inference, params_from_jax
from tests.test_torch_slam import one_torch_thread  # noqa: F401

H, W = 64, 80
REL = 1e-4
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def setup():
    jp = jinit.init_params(jax.random.PRNGKey(0), JTINY)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32) for _ in range(2)]
    out = {}
    for name, (jdt, tdt) in DT.items():
        jpp = jp if name == "f32" else jconvert.cast_params_for_inference(jp)
        tpp = tp if name == "f32" else cast_params_for_inference(tp)
        jenc = [jmodel.encode(jpp, JTINY, jnp.asarray(im), dtype=jdt) for im in imgs]
        tenc = [tmodel.encode(tpp, TTINY, torch.from_numpy(im), dtype=tdt) for im in imgs]
        out[name] = dict(jp=jpp, tp=tpp, jenc=jenc, tenc=tenc)
    # JAX's own f32 run on the bf16 inputs' images, for the bf16 bound
    out["f32"]["jfused"] = jmodel.decode(jp, JTINY, *out["f32"]["jenc"][0],
                                         *out["f32"]["jenc"][1], (H, W), dtype=jnp.float32,
                                         fused_heads=True)
    return out


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, ref, own=None):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if own is None:
        np.testing.assert_allclose(got, ref, atol=REL * float(np.abs(ref).max()), rtol=0)
    else:
        err = float(np.abs(got - ref).max())
        assert 0 < own and err <= 2.0 * own, (err, own)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_heads_match_jax(setup, dt):
    s = setup[dt]
    jdt, tdt = DT[dt]
    oj = jmodel.decode(s["jp"], JTINY, *s["jenc"][0], *s["jenc"][1], (H, W), dtype=jdt,
                       fused_heads=True)
    ot = tmodel.decode(s["tp"], TTINY, *s["tenc"][0], *s["tenc"][1], (H, W), dtype=tdt,
                       fused_heads=True)
    ou = tmodel.decode(s["tp"], TTINY, *s["tenc"][0], *s["tenc"][1], (H, W), dtype=tdt)
    for name in oj._fields:
        own = None
        if dt == "bf16":  # JAX's own bf16 distance from its f32 fused run
            own = float(np.abs(_np(getattr(oj, name)) - _np(getattr(setup["f32"]["jfused"],
                                                                    name))).max())
        _close(getattr(ot, name), getattr(oj, name), own)
        _close(getattr(ot, name), getattr(ou, name), own)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_inference_sym_matches_jax(setup, dt, monkeypatch):
    s = setup[dt]
    jdt, tdt = DT[dt]
    dec = jmodel.decode
    monkeypatch.setattr(jmodel, "decode", lambda *a, **k: dec(*a, **{**k, "dtype": jdt}))
    (fi, pi), (fj, pj) = s["jenc"]
    jij, jji = jmodel.inference_sym(s["jp"], JTINY, fi, pi, fj, pj, (H, W))
    (ti, tpi), (tj, tpj) = s["tenc"]
    tij, tji = tmodel.inference_sym(s["tp"], TTINY, ti, tpi, tj, tpj, (H, W), tdt)
    own_ij = own_ji = None
    if dt == "bf16":
        monkeypatch.setattr(jmodel, "decode", lambda *a, **k: dec(*a, **{**k,
                                                                      "dtype": jnp.float32}))
        f32 = setup["f32"]
        (gi, qi), (gj, qj) = f32["jenc"]
        fij, fji = jmodel.inference_sym(f32["jp"], JTINY, gi, qi, gj, qj, (H, W))
    for name in tij._fields:
        if dt == "bf16":
            own_ij = float(np.abs(_np(getattr(jij, name)) - _np(getattr(fij, name))).max())
            own_ji = float(np.abs(_np(getattr(jji, name)) - _np(getattr(fji, name))).max())
        _close(getattr(tij, name), getattr(jij, name), own_ij)
        _close(getattr(tji, name), getattr(jji, name), own_ji)
    # each half is the port's own decode of its order
    oij = tmodel.decode(s["tp"], TTINY, ti, tpi, tj, tpj, (H, W), tdt)
    oji = tmodel.decode(s["tp"], TTINY, tj, tpj, ti, tpi, (H, W), tdt)
    for name in tij._fields:
        _close(getattr(tij, name), getattr(oij, name), own_ij)
        _close(getattr(tji, name), getattr(oji, name), own_ji)
