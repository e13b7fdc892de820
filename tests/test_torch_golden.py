"""The port replays tests/fixtures/model_golden.npz, the frozen probe values
of the original torch AsymmetricMASt3R, as tests/test_golden.py does for the
JAX package: the same ModelConfig, the state dict rebuilt from
tests/fixtures/model_manifest.json with the fill recipe of
scripts/gen_golden_fixtures.py, converted by the port's own
`params_from_state_dict` and `params_from_jax`, run in f32 through the
port's encode and decode on the same 64x80 inputs. Tolerances are
test_golden.py's: atol 2e-4 for feat1, 2e-3 for the rest, rtol 1e-2."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from monst3r_slam_torch.models import mast3r as tmodel
from monst3r_slam_torch.models.config import INF, ModelConfig
from monst3r_slam_torch.models.convert import params_from_jax, params_from_state_dict
from tests.test_torch_slam import one_torch_thread  # noqa: F401

FIX = pathlib.Path(__file__).parent / "fixtures"
SCRIPTS = pathlib.Path(__file__).parent.parent / "scripts"

if not (FIX / "model_golden.npz").is_file():  # pragma: no cover
    pytest.skip("golden fixtures not generated", allow_module_level=True)


def _gen_module():
    spec = importlib.util.spec_from_file_location("gen_golden_fixtures",
                                                  SCRIPTS / "gen_golden_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe(a, k=64):
    a = np.asarray(a, np.float64).ravel()
    step = max(1, a.size // k)
    return a[::step][:k].astype(np.float32)


def test_model_golden_values():
    gen = _gen_module()
    cfg = ModelConfig(enc_depth=2, enc_dim=64, enc_heads=4, dec_depth=12, dec_dim=48,
                      dec_heads=4, desc_dim=24, two_confs=True, desc_conf_mode=("exp", 0.0, INF))
    manifest = json.loads((FIX / "model_manifest.json").read_text())
    rng = np.random.default_rng(1234)
    sd = {name: gen.fill_value(name, shape, rng) for name, shape in manifest}
    params = params_from_jax(params_from_state_dict(sd, cfg))

    H, W = 64, 80
    rng_in = np.random.default_rng(99)
    img1 = rng_in.standard_normal((1, 3, H, W)).astype(np.float32) * 0.5
    img2 = rng_in.standard_normal((1, 3, H, W)).astype(np.float32) * 0.5
    feat1, pos1 = tmodel.encode(params, cfg, torch.from_numpy(img1.transpose(0, 2, 3, 1)),
                                dtype=torch.float32)
    feat2, pos2 = tmodel.encode(params, cfg, torch.from_numpy(img2.transpose(0, 2, 3, 1)),
                                dtype=torch.float32)
    out = tmodel.decode(params, cfg, feat1, pos1, feat2, pos2, (H, W), dtype=torch.float32)

    g = np.load(FIX / "model_golden.npz")
    got = {"feat1": feat1, "X1": out.X1, "C1": out.C1, "D1": out.D1, "Q1": out.Q1,
           "X2": out.X2, "C2": out.C2, "D2": out.D2, "Q2": out.Q2}
    for key, t in got.items():
        t = t.numpy()
        assert tuple(t.shape) == tuple(g[f"{key}_shape"]), key
        atol = 2e-4 if key == "feat1" else 2e-3
        np.testing.assert_allclose(_probe(t), g[f"{key}_probe"], atol=atol, rtol=1e-2,
                                   err_msg=f"golden mismatch: {key}")
        np.testing.assert_allclose(t.mean(), g[f"{key}_mean"], atol=atol, rtol=1e-2, err_msg=key)
        np.testing.assert_allclose(t.std(), g[f"{key}_std"], atol=atol, rtol=1e-2, err_msg=key)
