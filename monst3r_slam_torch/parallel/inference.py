"""Sharded inference fan-out on a device mesh.

Port of the TPU package's `parallel/inference.py`:

  * the factor-graph edge decode (`sharded_edge_decode`): `add_factors`
    batches the pair decodes of every new edge into one decode, which is
    independent per pair, so the batch splits into contiguous row blocks
    over the mesh's `dp` axis, each block decoded on its device, launched
    back to back with no host read between them, and the outputs gathered
    on the home device; it also takes the tp-split weights that training
    leaves (`shard_params`), which it gathers and replicates first;
  * the dynamic pipeline's dual decode (`dual_decode_two_device`): MonST3R
    (X, C) and MASt3R (D, Q) read the same encoder features with their own
    weights, so the two decodes run on two devices at once, and D and Q
    are copied home for the matcher. The pipeline does not call it.

Launches to different cards from one thread are asynchronous, so shards on
distinct cards overlap without threads; shards that share a card run one
after the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from monst3r_slam_torch.dynamic.inference import DualParams, combine
from monst3r_slam_torch.models import mast3r as model_api
from monst3r_slam_torch.models.config import ModelConfig
from monst3r_slam_torch.ops.build import on_card
from monst3r_slam_torch.parallel.mesh import Mesh, canonical_device, gather_params, split_rows


def _tree_to(tree, dev: torch.device):
    return torch.utils._pytree.tree_map(lambda t: t.to(dev), tree)


def _pad_rows(x: torch.Tensor, n_to: int) -> torch.Tensor:
    """Pad the leading (batch) dim with zero rows up to n_to rows."""
    pad = n_to - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def place_replicated(params, mesh: Mesh) -> dict:
    """The parameter tree on each distinct dp shard device, {device: tree};
    the replica on the weights' own device is the tree itself."""
    return {dev: _tree_to(params, dev) for dev in dict.fromkeys(mesh.shard_devices("dp"))}


@torch.no_grad()
def sharded_edge_decode(mesh: Mesh, params: dict, cfg: ModelConfig, feat1, pos1, feat2, pos2,
                        shape, dtype=torch.bfloat16) -> model_api.PairOutput:
    """`model_api.decode` with the edge batch split over `dp`: the rows are
    padded with zero rows to a multiple of the dp size (the decode is per
    row, so pad rows only waste the remainder), split into contiguous
    blocks, each decoded on its shard device with that device's replica of
    `params` (`place_replicated`), and the outputs gathered in row order on
    the home device with the pad rows stripped.

    `params` may also be a parameter tree placed by `shard_params` (the
    weights a sharded train step leaves, as the reference decodes with
    `state.params`). It is gathered (`gather_params`) and replicated, not
    decoded tensor parallel: rows are independent, so dp alone spreads the
    decode, and each row then decodes as the unsharded decode of the same
    weights does, bit for bit, where the tensor-parallel forward would round
    its row-parallel sums in bf16 another way and launch every attention tp
    times over. The cost is one copy of the weights per call."""
    if not all(isinstance(k, torch.device) for k in params):
        params = place_replicated(gather_params(params, mesh), mesh)
    devs = mesh.shard_devices("dp")
    B = feat1.shape[0]
    Bp = -(-B // len(devs)) * len(devs)
    blocks = [split_rows(mesh, _pad_rows(x, Bp)) for x in (feat1, pos1, feat2, pos2)]
    outs = []
    for d, dev in enumerate(devs):
        with on_card(dev):
            outs.append(model_api.decode(params[dev], cfg, *(b[d] for b in blocks), shape,
                                         dtype))
    return model_api.PairOutput(*(
        None if field[0] is None else _gather_rows(field, mesh.home)[:B] for field in zip(*outs)))


def _gather_rows(blocks, home: torch.device) -> torch.Tensor:
    """The row blocks concatenated on `home` in the memory layout of the
    blocks (the heads return pointmaps as channels-last views of
    channel-first buffers): the matcher's reductions read the layout, and
    a row's matches then equal those of the unsharded decode's output."""
    t = blocks[0]
    perm = [0] + sorted(range(1, t.dim()), key=lambda d: -t.stride(d))
    out = torch.cat([b.to(home).permute(perm) for b in blocks])
    return out.permute([perm.index(d) for d in range(t.dim())])


def dual_device_pair(mesh_or_devices) -> Optional[Sequence[torch.device]]:
    """The first two devices of a mesh (in grid order) or of a device list,
    for the dual decoder; None with fewer than two. A grid that repeats a
    card gives that card twice."""
    if isinstance(mesh_or_devices, Mesh):
        devs = list(mesh_or_devices.devices.flat)
    else:
        devs = [canonical_device(d) for d in mesh_or_devices]
    if len(devs) < 2:
        return None
    return devs[0], devs[1]


def place_dual(dual: DualParams, dev_a, dev_b) -> DualParams:
    """A copy of `dual` with the MonST3R weights on dev_a and the MASt3R
    weights on dev_b."""
    return dual._replace(monst3r=_tree_to(dual.monst3r, canonical_device(dev_a)),
                         mast3r=_tree_to(dual.mast3r, canonical_device(dev_b)))


@torch.no_grad()
def dual_decode_two_device(dual: DualParams, dev_a, dev_b, feat_i, pos_i, feat_j, pos_j,
                           shape, dtype=torch.bfloat16) -> model_api.PairOutput:
    """The dynamic pipeline's dual decode (`monst3r_asymmetric_inference`)
    with MonST3R on dev_a and MASt3R on dev_b (`place_dual` put the weights
    there), both launched before either result is read; every output is on
    dev_a, D and Q copied there."""
    dev_a, dev_b = canonical_device(dev_a), canonical_device(dev_b)
    with on_card(dev_a):
        out_m = model_api.decode(dual.monst3r, dual.monst3r_cfg, feat_i.to(dev_a),
                                 pos_i.to(dev_a), feat_j.to(dev_a), pos_j.to(dev_a), shape, dtype)
    with on_card(dev_b):
        out_a = model_api.decode(dual.mast3r, dual.mast3r_cfg, feat_i.to(dev_b),
                                 pos_i.to(dev_b), feat_j.to(dev_b), pos_j.to(dev_b), shape, dtype)
    return combine(out_m, out_a._replace(**{k: None if t is None else t.to(dev_a)
                                            for k, t in out_a._asdict().items()}))
