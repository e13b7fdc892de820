"""Dual-model inference for the dynamic pipeline.

Port of the JAX package's `dynamic/inference.py`, MonST3R half: both
decoders run on the same MonST3R encoder features. The pointmaps X and
confidences C come from the MonST3R decoder (no descriptor head), the
descriptors D and their confidences Q from the MASt3R decoder and its catMLP
head. The Easi3R pipeline is not ported; `SLAMSystem` refuses it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
