"""Plain reference of the fine-tuning step: the confidence-aware pointmap
regression loss of DUSt3R / MASt3R and AdamW, over the plain model of
`model.py`, in float32 with TF32 off.

The loss of a batch is each view's summed per-pixel loss over its summed
valid count, the two views added; every pointmap is first divided by its
mean valid distance, per pair. Since only the sums couple the pairs, the
gradient is accumulated over blocks of rows (`rows` pairs at a time), so
the reference fits beside a batch the program ran at once.

AdamW is the published update (Loshchilov & Hutter) with the reference
repository's settings: decoupled weight decay on the old weights,
bias-corrected moments, eps outside the square root.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model


def _view_terms(pred_X, pred_C, gt_X, valid, alpha: float):
    v = valid.float()

    def norm(X):
        d = torch.linalg.vector_norm(X, dim=-1)
        mean = (d * v).sum(dim=(1, 2)) / (v.sum(dim=(1, 2)) + 1e-8)
        return X / mean.clamp(min=1e-8)[:, None, None, None]

    err = torch.linalg.vector_norm(norm(pred_X) - norm(gt_X), dim=-1)
    per_pix = pred_C * err - alpha * torch.log(pred_C.clamp(min=1e-8))
    return (per_pix * v).sum()


def loss_and_grads(params, cfg: dict, batch: dict, P: model.Precision = model.F32,
                   rows: int = 2, alpha: float = 0.2):
    """The batch's loss (a float) with each leaf's `.grad` set to its
    gradient; `params` holds f32 leaves that require grad."""
    den1 = float(batch["valid1"].float().sum()) + 1e-8
    den2 = float(batch["valid2"].float().sum()) + 1e-8
    total = 0.0
    for r0 in range(0, batch["img1"].shape[0], rows):
        b = {k: v[r0:r0 + rows] for k, v in batch.items()}
        o1, o2 = model.pair(params, cfg, b["img1"], b["img2"], P)
        loss = (_view_terms(o1["pts3d"], o1["conf"], b["gt_X1"], b["valid1"], alpha) / den1
                + _view_terms(o2["pts3d"], o2["conf"], b["gt_X2"], b["valid2"], alpha) / den2)
        loss.backward()
        total += float(loss.detach())
    return total


class AdamW:
    def __init__(self, leaves, lr: float, betas=(0.9, 0.95), eps: float = 1e-8,
                 weight_decay: float = 0.05):
        self.leaves, self.lr, self.b1, self.b2 = leaves, lr, betas[0], betas[1]
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.leaves, self.m, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
            p.grad = None


def steps(params, leaves, cfg: dict, batches, lr: float, P: model.Precision = model.F32,
          rows: int = 2) -> dict:
    """Run the steps on `batches` from the weights in `params` (whose f32
    leaves, in order, are `leaves`): each step's loss, each leaf's first
    gradient norm, and each leaf's change norm after the last step."""
    start = [p.detach().clone() for p in leaves]
    opt = AdamW(leaves, lr)
    losses, grad_norms = [], None
    with model.exact_f32():
        for i, batch in enumerate(batches):
            losses.append(loss_and_grads(params, cfg, batch, P, rows))
            if i == 0:
                grad_norms = [float(torch.linalg.vector_norm(p.grad)) if p.grad is not None
                              else 0.0 for p in leaves]
            opt.step()
    change = [float(torch.linalg.vector_norm(p.detach() - s)) for p, s in zip(leaves, start)]
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change)


def compare(got: dict, ref: dict) -> dict:
    """The compared numbers: the widest relative loss gap over the steps,
    and by the worst leaf the gap between the program's and the reference's
    first-gradient norm and change norm, over the reference's norm of that
    leaf or of the median leaf, whichever is larger. Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out."""
    step_gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    g_ref = np.asarray(ref["grad_norms"])
    keep = g_ref >= 1e-3 * np.median(g_ref)

    def worst(name):
        a, b = np.asarray(got[name])[keep], np.asarray(ref[name])[keep]
        return float(np.max(np.abs(a - b) / np.maximum(b, np.median(b))))

    return dict(loss_gap=float(max(step_gaps)), grad_gap=worst("grad_norms"),
                change_gap=worst("change_norms"), leaves_counted=int(keep.sum()),
                leaves=len(keep), step_loss_gaps=step_gaps)
