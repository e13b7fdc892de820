"""Parity of the PyTorch port's core (lie, geometry, robust) with the JAX
package on random batched float32 inputs.

Tolerance: atol 1e-5. Both sides evaluate the same closed forms in float32
on values of order 1; the two frameworks order a few operations differently
(cross products, norms), which moves results by a few float32 ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.core import geometry as jgeo
from monst3r_slam_tpu.core import lie as jlie
from monst3r_slam_tpu.core import robust as jrob
from monst3r_slam_torch.core import geometry as tgeo
from monst3r_slam_torch.core import lie as tlie
from monst3r_slam_torch.core import robust as trob

ATOL = 1e-5
RNG = np.random.default_rng(0)
B = (4, 5)


def _xi(scale=(0.5, 0.8, 0.3), batch=B):
    rng = np.random.default_rng(1)
    xi = np.concatenate([scale[0] * rng.normal(size=batch + (3,)),
                         scale[1] * rng.normal(size=batch + (3,)),
                         scale[2] * rng.normal(size=batch + (1,))], -1)
    # a few tiny tangents exercise the small-angle / small-scale switches
    xi[0, :2] *= 1e-5
    return xi.astype(np.float32)


def _sim3():
    return np.asarray(jlie.sim3_exp(jnp.asarray(_xi())))


def _quat():
    q = RNG.normal(size=B + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vec(n=3, scale=1.0):
    return (scale * RNG.normal(size=B + (n,))).astype(np.float32)


def _points():
    return (_vec() + np.asarray([0.0, 0.0, 3.0], np.float32)).astype(np.float32)


CASES = {  # name: (module, function, keyword arguments, inputs)
    "quat_mul": ("lie", "quat_mul", {}, lambda: (_quat(), _quat())),
    "quat_inv": ("lie", "quat_inv", {}, lambda: (_quat(),)),
    "quat_rotate": ("lie", "quat_rotate", {}, lambda: (_quat(), _vec())),
    "quat_normalize": ("lie", "quat_normalize", {}, lambda: (3.0 * _vec(4),)),
    "so3_exp": ("lie", "so3_exp", {}, lambda: (_xi()[..., 3:6],)),
    "so3_log": ("lie", "so3_log", {}, lambda: (_quat(),)),
    "so3_matrix": ("lie", "so3_matrix", {}, lambda: (_quat(),)),
    "skew": ("lie", "skew", {}, lambda: (_vec(),)),
    "sim3_act": ("lie", "sim3_act", {}, lambda: (_sim3(), _vec())),
    "sim3_mul": ("lie", "sim3_mul", {}, lambda: (_sim3(), _sim3()[::-1].copy())),
    "sim3_inv": ("lie", "sim3_inv", {}, lambda: (_sim3(),)),
    "sim3_rel": ("lie", "sim3_rel", {}, lambda: (_sim3(), _sim3()[:, ::-1].copy())),
    "sim3_exp": ("lie", "sim3_exp", {}, lambda: (_xi(),)),
    "sim3_log": ("lie", "sim3_log", {}, lambda: (_sim3(),)),
    "sim3_retr": ("lie", "sim3_retr", {}, lambda: (_sim3(), 0.1 * _xi())),
    "sim3_matrix": ("lie", "sim3_matrix", {}, lambda: (_sim3(),)),
    "sim3_adj_inv_T_apply": ("lie", "sim3_adj_inv_T_apply", {}, lambda: (_sim3(), _vec(7))),
    "se3_mul": ("lie", "se3_mul", {},
                lambda: (_sim3()[..., :7].copy(), _sim3()[::-1, :, :7].copy())),
    "se3_inv": ("lie", "se3_inv", {}, lambda: (_sim3()[..., :7].copy(),)),
    "se3_act": ("lie", "se3_act", {}, lambda: (_sim3()[..., :7].copy(), _vec())),
    "point_to_dist": ("geometry", "point_to_dist", {}, lambda: (_points(),)),
    "point_to_ray_dist": ("geometry", "point_to_ray_dist", {}, lambda: (_points(),)),
    "point_to_ray_dist_jac": ("geometry", "point_to_ray_dist", {"jacobian": True},
                              lambda: (_points(),)),
    "act_Sim3": ("geometry", "act_Sim3", {}, lambda: (_sim3(), _points())),
    "act_Sim3_jac": ("geometry", "act_Sim3", {"jacobian": True}, lambda: (_sim3(), _points())),
    "huber": ("robust", "huber", {}, lambda: (_vec(8, 2.0),)),
    "tukey": ("robust", "tukey", {}, lambda: (_vec(8, 4.0),)),
}
_MODULES = {
    "jax": {"lie": jlie, "geometry": jgeo, "robust": jrob},
    "torch": {"lie": tlie, "geometry": tgeo, "robust": trob},
}


def _call(side, name, args):
    module, fn, kwargs, _ = CASES[name]
    out = getattr(_MODULES[side][module], fn)(*args, **kwargs)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_core_function_matches_jax(name):
    args = CASES[name][3]()
    ref = _call("jax", name, [jnp.asarray(a) for a in args])
    got = _call("torch", name, [torch.tensor(a) for a in args])
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


def test_identities_and_pixel_grid_match_jax():
    np.testing.assert_array_equal(tlie.sim3_identity((3,)).numpy(),
                                  np.asarray(jlie.sim3_identity((3,))))
    np.testing.assert_array_equal(tlie.se3_identity((2,)).numpy(),
                                  np.asarray(jlie.se3_identity((2,))))
    np.testing.assert_array_equal(tgeo.get_pixel_coords(2, (5, 7)).numpy(),
                                  np.asarray(jgeo.get_pixel_coords(2, (5, 7))))


def test_converged_matches_jax():
    delta = RNG.normal(size=7).astype(np.float32) * 1e-4
    for old, new in ((np.inf, 3.0), (3.0, 2.999), (3.0, 1.0)):
        for d in (delta, 100 * delta):
            ref = jrob.converged(1e-3, 1e-3, jnp.float32(old), jnp.float32(new), jnp.asarray(d))
            got = trob.converged(1e-3, 1e-3, torch.tensor(old), torch.tensor(new),
                                 torch.from_numpy(d))
            assert bool(got) == bool(ref), (old, new)
