"""Training step: the two-view forward with gradients, AdamW.

Port of the JAX package's `train/step.py`. The weights stay the f32 leaf
tensors of the port's parameter tree (`models/init.py`) and each operation
casts them to the compute type, as the serving path does. On the card every
attention of the encoder and decoder runs kernel A, forward only
(`ops/attention.KernelAttention`).

On a dp x tp mesh (`parallel/mesh.py`, one process; a grid may repeat a
card) the step takes `shard_params`'s tree and a batch split over dp by
`batch_sharding`: each dp row block runs the tensor-parallel forward
(`models/blocks.py`) on its row of devices, which reach every weight
through a differentiable `.to`, so autograd sums each weight's gradient
over the rows, where the reference's GSPMD inserts a psum over dp. The
loss divides the rows' summed numerators by their summed denominators, as
the reference's loss over the whole batch does. On a (1, 1) mesh the step
is the one-device step, operation for operation.

The optimizer is the reference's `optax.adamw(lr, b1=0.9, b2=0.95,
weight_decay=0.05)`, eps 1e-8, every leaf decayed: `torch.optim.AdamW`
with the same settings computes the same update (decoupled decay on the
old weights, bias-corrected moments, eps outside the square root), in
another order of f32 operations. It is elementwise, so it steps each part
of a split weight as it would step that slice of the whole.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from monst3r_slam_torch.models import croco, heads
from monst3r_slam_torch.models.config import ModelConfig
from monst3r_slam_torch.parallel.mesh import Mesh, Sharded, row_params, sum_home
from monst3r_slam_torch.train.loss import conf_regression_terms
from monst3r_slam_torch.utils import timing


class TrainState(NamedTuple):
    params: dict  # the parameter tree, f32 leaves that require grad
    opt_state: torch.optim.AdamW  # over `leaf_tensors(params)`, in that order
    step: int


def named_leaves(tree, prefix: str = "") -> list:
    """[(path, tensor)] of a parameter tree in a fixed order, each path
    spelled as JAX's `tree_util.keystr` spells it (`['enc_blocks'][0]['attn']
    ['qkv']['w']`), here over the port's per-block lists. A `Sharded`
    weight is one leaf."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.05):
    """AdamW with the reference's settings, to be built over the leaves."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=weight_decay)


def leaf_parts(w) -> list:
    """The tensors of one leaf: a `Sharded` weight's parts in shard order,
    or the tensor itself."""
    return w.parts if isinstance(w, Sharded) else [w]


def leaf_tensors(params) -> list:
    """The tensors the optimizer steps, in `named_leaves` order."""
    return [t for _, w in named_leaves(params) for t in leaf_parts(w)]


def init_train_state(params, optimizer) -> TrainState:
    return TrainState(params, optimizer([t.requires_grad_() for t in leaf_tensors(params)]), 0)


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


def loss_fn(params, cfg: ModelConfig, batch, alpha: float = 0.2, dtype=torch.bfloat16,
            mesh: Mesh | None = None):
    """The two views' losses over the whole batch, added. With a `mesh`,
    `params` is `shard_params`'s tree and each batch value the list of its
    dp row blocks (`batch_sharding`); each view's numerator and denominator
    are summed over the rows on the home device, then divided."""
    if mesh is None:
        rows = [(params, batch)]
    else:
        rows = [(row_params(params, mesh, d), {k: v[d] for k, v in batch.items()})
                for d in range(mesh.shape["dp"])]
    terms = []
    for p, b in rows:
        out1, out2 = pair_forward(p, cfg, b["img1"], b["img2"], dtype)
        terms.append(conf_regression_terms(out1.pts3d, out1.conf, b["gt_X1"], b["valid1"], alpha)
                     + conf_regression_terms(out2.pts3d, out2.conf, b["gt_X2"], b["valid2"],
                                             alpha))
    num1, den1, num2, den2 = (sum_home(t) for t in zip(*terms))
    return num1 / (den1 + 1e-8) + num2 / (den2 + 1e-8)


def backward(loss: torch.Tensor, opt: torch.optim.AdamW) -> None:
    """`loss.backward()`, then a zero gradient on each leaf the loss does not
    reach (the descriptor head): as in the reference, AdamW still decays it."""
    loss.backward()
    for t in opt.param_groups[0]["params"]:
        if t.grad is None:
            t.grad = torch.zeros_like(t)


def train_step(state: TrainState, cfg: ModelConfig, batch, dtype=torch.bfloat16,
               mesh: Mesh | None = None):
    """One AdamW step on `batch`, in place; on a `mesh`, the state's weights
    from `shard_params` and the batch from `batch_sharding` (`loss_fn`).
    Returns (state, loss), the loss a tensor on the (home) device (no host
    read). The recorder (utils/timing) holds the step as a `train_step`
    span (request id: the step) over `forward`, `backward` and `optimizer`,
    each with its device time on a card."""
    opt = state.opt_state
    on_card = opt.param_groups[0]["params"][0].is_cuda
    with timing.span("train_step", rid=state.step):
        opt.zero_grad(set_to_none=True)
        with timing.span("forward", device=on_card):
            loss = loss_fn(state.params, cfg, batch, dtype=dtype, mesh=mesh)
        with timing.span("backward", device=on_card):
            backward(loss, opt)
        with timing.span("optimizer", device=on_card):
            opt.step()
    return TrainState(state.params, opt, state.step + 1), loss.detach()
