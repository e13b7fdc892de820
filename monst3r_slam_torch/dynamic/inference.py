"""Dual-model inference for the dynamic pipelines.

Port of the JAX package's `dynamic/inference.py`. MonST3R: both decoders
run on the same MonST3R encoder features; the pointmaps X and confidences C
come from the MonST3R decoder (no descriptor head), the descriptors D and
their confidences Q from the MASt3R decoder and its catMLP head. Easi3R: X
and C come from the two-pass attention-reweighted inference of a
DUSt3R-architecture model (`dynamic/easi3r.py`), D and Q from MASt3R on the
same Easi3R encoder features, and the attention-derived dynamic masks zero C
and Q on the dynamic pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monst3r_slam_torch.dynamic.easi3r import easi3r_double_inference_pair
from monst3r_slam_torch.models import mast3r as model_api
from monst3r_slam_torch.models.config import ModelConfig


class DualParams(NamedTuple):
    monst3r: dict
    monst3r_cfg: ModelConfig
    mast3r: dict
    mast3r_cfg: ModelConfig


def combine(out_m: model_api.PairOutput, out_a: model_api.PairOutput) -> model_api.PairOutput:
    """X/C of the MonST3R decode with D/Q of the MASt3R decode."""
    return model_api.PairOutput(
        X1=out_m.X1, C1=out_m.C1, D1=out_a.D1, Q1=out_a.Q1,
        X2=out_m.X2, C2=out_m.C2, D2=out_a.D2, Q2=out_a.Q2,
    )


def monst3r_asymmetric_inference(dual: DualParams, feat_i, pos_i, feat_j, pos_j, shape,
                                 dtype=torch.bfloat16) -> model_api.PairOutput:
    """Both decoders on the ordered pair (i, j) of MonST3R encoder features."""
    out_m = model_api.decode(dual.monst3r, dual.monst3r_cfg, feat_i, pos_i, feat_j, pos_j,
                             shape, dtype)
    out_a = model_api.decode(dual.mast3r, dual.mast3r_cfg, feat_i, pos_i, feat_j, pos_j,
                             shape, dtype)
    return combine(out_m, out_a)


def monst3r_inference_mono(dual: DualParams, feat, pos, shape,
                           dtype=torch.bfloat16) -> model_api.PairOutput:
    return monst3r_asymmetric_inference(dual, feat, pos, feat, pos, shape, dtype)


# ---------------------------------------------------------------------------
# Easi3R pipeline: pointmaps from the two-pass attention-reweighted DUSt3R
# inference, descriptors from MASt3R, the attention masks gating C and Q.
# ---------------------------------------------------------------------------


class EasiParams(NamedTuple):
    easi3r: dict  # DUSt3R-architecture weights (no descriptor head)
    easi3r_cfg: ModelConfig
    mast3r: dict
    mast3r_cfg: ModelConfig
    k_mad: float = 2.0


def easi3r_asymmetric_inference(ep: EasiParams, feat_i, pos_i, feat_j, pos_j, shape,
                                dtype=torch.bfloat16) -> model_api.PairOutput:
    """X/C from the Easi3R double inference (its second, re-weighted pass)
    and D/Q from MASt3R, on the ordered pair (i, j) of Easi3R encoder
    features; the per-pixel dynamic masks of pass 1 zero C and Q."""
    out_e = easi3r_double_inference_pair(ep.easi3r, ep.easi3r_cfg, feat_i, pos_i, feat_j, pos_j,
                                         shape, k_mad=ep.k_mad, dtype=dtype)
    out_a = model_api.decode(ep.mast3r, ep.mast3r_cfg, feat_i, pos_i, feat_j, pos_j, shape,
                             dtype)
    keep1 = (~out_e.dyn_mask1).to(out_e.C1.dtype)
    keep2 = (~out_e.dyn_mask2).to(out_e.C2.dtype)
    return model_api.PairOutput(
        X1=out_e.X1, C1=out_e.C1 * keep1, D1=out_a.D1, Q1=out_a.Q1 * keep1,
        X2=out_e.X2, C2=out_e.C2 * keep2, D2=out_a.D2, Q2=out_a.Q2 * keep2,
    )


def easi3r_inference_mono(ep: EasiParams, feat, pos, shape,
                          dtype=torch.bfloat16) -> model_api.PairOutput:
    return easi3r_asymmetric_inference(ep, feat, pos, feat, pos, shape, dtype)
