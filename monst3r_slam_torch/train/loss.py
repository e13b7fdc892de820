"""Training objective: confidence-weighted two-view pointmap regression.

Port of the JAX package's `train/loss.py` (the DUSt3R/MASt3R conf-aware
regression, L = C * ||X - X_gt|| - alpha * log C per valid pixel, each
view's pointmaps scale-normalized by their mean valid distance).

One difference at a point of measure zero: where a norm's argument is
exactly the zero vector (a predicted point equal to its ground truth, a
zero point), `torch.linalg.norm` has a zero gradient, where the
reference's `jnp.linalg.norm` has a NaN one, which no validity mask can
cancel there (NaN * 0 is NaN).
"""

from __future__ import annotations

import torch


def normalize_pointmap(X: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Scale-normalize by the mean distance of valid points (per batch el)."""
    d = torch.linalg.norm(X, dim=-1)
    denom = torch.sum(valid, dim=(1, 2)) + 1e-8
    mean_d = torch.sum(d * valid, dim=(1, 2)) / denom
    return X / torch.clamp(mean_d, min=1e-8)[:, None, None, None]


def conf_regression_terms(pred_X: torch.Tensor, pred_C: torch.Tensor, gt_X: torch.Tensor,
                          valid: torch.Tensor, alpha: float = 0.2,
                          normalize: bool = True) -> tuple:
    """The numerator and the denominator of `conf_regression_loss`: the
    per-pixel loss summed over the valid pixels, and their count. The loss
    of a batch split into row blocks is the quotient of the blocks' sums,
    not the mean of their losses, whenever their valid counts differ."""
    valid = valid.float()
    if normalize:
        pred_X = normalize_pointmap(pred_X, valid)
        gt_X = normalize_pointmap(gt_X, valid)
    err = torch.linalg.norm(pred_X - gt_X, dim=-1)
    # conf-aware: C*err - alpha*log(C); C is strictly positive by construction
    logC = torch.log(torch.clamp(pred_C, min=1e-8))
    per_pix = pred_C * err - alpha * logC
    return torch.sum(per_pix * valid), torch.sum(valid)


def conf_regression_loss(pred_X: torch.Tensor, pred_C: torch.Tensor, gt_X: torch.Tensor,
                         valid: torch.Tensor, alpha: float = 0.2,
                         normalize: bool = True) -> torch.Tensor:
    """pred_X, gt_X (B, H, W, 3); pred_C (B, H, W), >= its vmin; valid
    (B, H, W) bool or float. A scalar f32 tensor."""
    num, den = conf_regression_terms(pred_X, pred_C, gt_X, valid, alpha, normalize)
    return num / (den + 1e-8)


def two_view_loss(out, batch, alpha: float = 0.2) -> torch.Tensor:
    """`out` is a models.mast3r.PairOutput; batch carries gt_X1/gt_X2/valid."""
    l1 = conf_regression_loss(out.X1, out.C1, batch["gt_X1"], batch["valid1"], alpha)
    l2 = conf_regression_loss(out.X2, out.C2, batch["gt_X2"], batch["valid2"], alpha)
    return l1 + l2
