"""Training step: the two-view forward with gradients, AdamW.

Port of the JAX package's `train/step.py` on one device (the reference's
dp x tp training mesh is not ported yet: `parallel/` holds the SLAM path's
mesh only). The weights stay the
f32 leaf tensors of the port's parameter tree (`models/init.py`) and each
operation casts them to the compute type, as the serving path does. On the
card every attention of the encoder and decoder runs kernel A, forward
only (`ops/attention.KernelAttention`).

The optimizer is the reference's `optax.adamw(lr, b1=0.9, b2=0.95,
weight_decay=0.05)`, eps 1e-8, every leaf decayed: `torch.optim.AdamW`
with the same settings computes the same update (decoupled decay on the
old weights, bias-corrected moments, eps outside the square root), in
another order of f32 operations.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from monst3r_slam_torch.models import croco, heads
from monst3r_slam_torch.models.config import ModelConfig
from monst3r_slam_torch.train.loss import conf_regression_loss


class TrainState(NamedTuple):
    params: dict  # the parameter tree, f32 leaves that require grad
    opt_state: torch.optim.AdamW  # over `named_leaves(params)`, in that order
    step: int


def named_leaves(tree, prefix: str = "") -> list:
    """[(path, tensor)] of a parameter tree in a fixed order, each path
    spelled as JAX's `tree_util.keystr` spells it (`['enc_blocks'][0]['attn']
    ['qkv']['w']`), here over the port's per-block lists."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.05):
    """AdamW with the reference's settings, to be built over the leaves."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=weight_decay)


def init_train_state(params, optimizer) -> TrainState:
    leaves = [t.requires_grad_() for _, t in named_leaves(params)]
    return TrainState(params, optimizer(leaves), 0)


def pair_forward(params, cfg: ModelConfig, img1, img2, dtype=torch.bfloat16):
    """Two-view forward with gradients (`mast3r.encode`/`decode` record none)."""
    h, w = img1.shape[1:3]
    n_h, n_w = h // cfg.patch_size, w // cfg.patch_size
    feat1, pos1 = croco.encode_image(params, cfg, img1, dtype)
    feat2, pos2 = croco.encode_image(params, cfg, img2, dtype)
    dec1, dec2 = croco.decode_pair(params, cfg, feat1, pos1, feat2, pos2, dtype)
    out1 = heads.head_forward(params["head1"], cfg, dec1, n_h, n_w)
    out2 = heads.head_forward(params["head2"], cfg, dec2, n_h, n_w)
    return out1, out2


def loss_fn(params, cfg: ModelConfig, batch, alpha: float = 0.2, dtype=torch.bfloat16):
    out1, out2 = pair_forward(params, cfg, batch["img1"], batch["img2"], dtype)
    l1 = conf_regression_loss(out1.pts3d, out1.conf, batch["gt_X1"], batch["valid1"], alpha)
    l2 = conf_regression_loss(out2.pts3d, out2.conf, batch["gt_X2"], batch["valid2"], alpha)
    return l1 + l2


def backward(loss: torch.Tensor, opt: torch.optim.AdamW) -> None:
    """`loss.backward()`, then a zero gradient on each leaf the loss does not
    reach (the descriptor head): as in the reference, AdamW still decays it."""
    loss.backward()
    for t in opt.param_groups[0]["params"]:
        if t.grad is None:
            t.grad = torch.zeros_like(t)


def train_step(state: TrainState, cfg: ModelConfig, batch, dtype=torch.bfloat16):
    """One AdamW step on `batch`, in place. Returns (state, loss), the loss
    a tensor on the device (no host read)."""
    opt = state.opt_state
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(state.params, cfg, batch, dtype=dtype)
    backward(loss, opt)
    opt.step()
    return TrainState(state.params, opt, state.step + 1), loss.detach()
