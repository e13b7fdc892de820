"""The port's model in bf16, as the entry points run it, against the JAX
package's bf16 model (its default): TINY config, 64x80 frames, the same
weights carried over by `params_from_jax` and cast by
`cast_params_for_inference` on both sides; the port's attention is its plain
version (`sdpa_plain`, what a CPU tensor takes).

Where each side rounds to bf16. The reference's bf16 program rounds every
product (matmul, convolution) to bf16 and then adds the bias in bf16, every
step of its erfc GELU, both RoPE products and their sum; it computes
layernorm and the softmax in f32 and rounds their outputs. The port must round
at the same places: `test_bf16_ops_round_where_the_reference_rounds` holds
each primitive to the reference bit for bit on the same bf16 inputs, except
attention, whose f32 logits and PV product may sum in another order: there
each element may differ by one bf16 rounding, 2^-8 of its magnitude.

The bound of the whole model follows. With the same rounding places, the two
sides differ only where an f32 sum taken in another order lands on the other
side of a bf16 rounding boundary; each such flip is a bf16 rounding error
like those either side already makes against the f32 model, and propagates
as they do. So the port's distance from the reference's bf16 output is at
most the two sides' distances from the f32 model added, and with equal
rounding places those two are of one size: the bound is twice the
reference's own distance from its f32 model on the same weights and inputs,
per output. (Measured: 0.83-1.45 times that distance.) An extra or a missing
rounding of the port shows in the primitive test; the model test catches a
rounding fault that compounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.models import blocks as jblocks
from monst3r_slam_tpu.models import convert as jconvert
from monst3r_slam_tpu.models import dpt as jdpt
from monst3r_slam_tpu.models import init as jinit
from monst3r_slam_tpu.models import mast3r as jmodel
from monst3r_slam_tpu.models import rope as jrope
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.ops import attention as jattn
from monst3r_slam_torch.models import blocks as tblocks
from monst3r_slam_torch.models import config as tconfig
from monst3r_slam_torch.models import dpt as tdpt
from monst3r_slam_torch.models import mast3r as tmodel
from monst3r_slam_torch.models import rope as trope
from monst3r_slam_torch.models.convert import cast_params_for_inference, params_from_jax
from monst3r_slam_torch.ops import attention as tattn
from tests.test_torch_slam import one_torch_thread  # noqa: F401

H, W = 64, 80


def _bf16(rng, shape, scale=1.0):
    """A bf16 array and the same values as a torch bf16 tensor."""
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _f32(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _ops(name, rng):
    """(reference output, port output) of one bf16 primitive on equal inputs."""
    if name == "linear":
        xj, xt = _bf16(rng, (2, 50, 64))
        w, b = _f32(rng, (64, 96), 0.125), _f32(rng, (96,))
        return (jblocks.linear({"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)}, xj),
                tblocks.linear({"w": torch.from_numpy(w.T.copy()).bfloat16(),
                                "b": torch.from_numpy(b)}, xt))
    if name == "mlp":
        xj, xt = _bf16(rng, (2, 50, 32))
        w1, b1, w2, b2 = (_f32(rng, (32, 64), 0.2), _f32(rng, (64,)), _f32(rng, (64, 32), 0.2),
                          _f32(rng, (32,)))
        pj = {"fc1": {"w": jnp.asarray(w1, jnp.bfloat16), "b": jnp.asarray(b1)},
              "fc2": {"w": jnp.asarray(w2, jnp.bfloat16), "b": jnp.asarray(b2)}}
        pt = {"fc1": {"w": torch.from_numpy(w1.T.copy()).bfloat16(), "b": torch.from_numpy(b1)},
              "fc2": {"w": torch.from_numpy(w2.T.copy()).bfloat16(), "b": torch.from_numpy(b2)}}
        return jblocks.mlp(pj, xj), tblocks.mlp(pt, xt)
    if name == "layernorm":
        xj, xt = _bf16(rng, (2, 50, 64), 3.0)
        g, b = _f32(rng, (64,)), _f32(rng, (64,))
        return (jblocks.layernorm({"w": jnp.asarray(g), "b": jnp.asarray(b)}, xj),
                tblocks.layernorm({"w": torch.from_numpy(g), "b": torch.from_numpy(b)}, xt))
    if name == "rope":
        xj, xt = _bf16(rng, (1, 2, 20, 16))
        pos = np.stack(np.meshgrid(np.arange(4), np.arange(5), indexing="ij"), -1)
        pos = pos.reshape(1, 20, 2).astype(np.int32)
        return (jrope.apply_rope2d(xj, jnp.asarray(pos), 100.0),
                trope.apply_rope2d(xt, torch.from_numpy(pos), 100.0))
    if name == "conv":
        xj, xt = _bf16(rng, (1, 12, 10, 16))
        w, b = _f32(rng, (3, 3, 16, 8), 0.1), _f32(rng, (8,))
        return (jdpt.conv2d({"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)}, xj,
                            padding=1),
                tdpt.conv2d({"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).bfloat16(),
                             "b": torch.from_numpy(b)}, _nchw(xt), padding=1).permute(0, 2, 3, 1))
    if name == "conv_transpose":
        xj, xt = _bf16(rng, (1, 6, 5, 16))
        w, b = _f32(rng, (2, 2, 16, 8), 0.2), _f32(rng, (8,))
        return (jdpt.conv_transpose_exact({"w": jnp.asarray(w, jnp.bfloat16),
                                           "b": jnp.asarray(b)}, xj, 2),
                tdpt.conv_transpose_exact(
                    {"w": torch.from_numpy(w.transpose(2, 3, 0, 1).copy()).bfloat16(),
                     "b": torch.from_numpy(b)}, _nchw(xt), 2).permute(0, 2, 3, 1))
    if name == "attention":
        (qj, qt), (kj, kt), (vj, vt) = (_bf16(rng, (1, 2, 60, 32)) for _ in range(3))
        return jattn.sdpa(qj, kj, vj), tattn.sdpa(qt, kt, vt)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["linear", "mlp", "layernorm", "rope", "conv", "conv_transpose",
                                  "attention"])
def test_bf16_ops_round_where_the_reference_rounds(name):
    ref, got = _ops(name, np.random.default_rng(0))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref, got = np.asarray(ref.astype(jnp.float32)), got.float().numpy()
    if name == "attention":
        np.testing.assert_array_less(np.abs(got - ref), 2.0**-8 * np.abs(ref) + 1e-30)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def bf16_outputs():
    jp = jinit.init_params(jax.random.PRNGKey(0), JTINY)
    tp = cast_params_for_inference(params_from_jax(jax.tree.map(np.asarray, jp)))
    jpb = jconvert.cast_params_for_inference(jp)
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32) for _ in range(2)]
    out = {}
    for side in ("jax_bf16", "jax_f32", "port_bf16"):
        if side == "port_bf16":
            enc = [tmodel.encode(tp, tconfig.TINY, torch.from_numpy(im)) for im in imgs]
            dec = tmodel.decode(tp, tconfig.TINY, *enc[0], *enc[1], (H, W))
            conv = lambda t: t.float().numpy()  # noqa: E731
        else:
            p, dt = (jpb, jnp.bfloat16) if side == "jax_bf16" else (jp, jnp.float32)
            enc = [jmodel.encode(p, JTINY, jnp.asarray(im), dtype=dt) for im in imgs]
            dec = jmodel.decode(p, JTINY, *enc[0], *enc[1], (H, W), dtype=dt)
            conv = lambda t: np.asarray(t, np.float32)  # noqa: E731
        res = {"feat1": conv(enc[0][0]), "feat2": conv(enc[1][0])}
        res.update({n: conv(getattr(dec, n)) for n in dec._fields})
        out[side] = res
    return out


@pytest.mark.parametrize("name", ["feat1", "feat2", "X1", "C1", "D1", "Q1", "X2", "C2", "D2",
                                  "Q2"])
def test_bf16_encode_decode_matches_jax(bf16_outputs, name):
    ref, got, f32 = (bf16_outputs[s][name] for s in ("jax_bf16", "port_bf16", "jax_f32"))
    assert got.shape == ref.shape and np.isfinite(got).all()
    own = float(np.abs(ref - f32).max())  # the reference's own bf16 rounding
    err = float(np.abs(got - ref).max())
    assert 0 < own and err <= 2.0 * own, (name, err, own)
