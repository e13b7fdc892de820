"""Device mesh, and the Megatron rule of the model weights and its placement.

Port of the TPU package's `parallel/mesh.py` for one process: a `Mesh` is
a plain object holding a (dp, tp) grid of `torch.device`, with named axes

  * `dp`: data parallel over frames, pairs, edges and training samples
    (the leading batch dim);
  * `tp`: tensor parallel over the ViT hidden dims (Megatron-style:
    column-parallel qkv / fc1 / cross q, k, v, row-parallel proj / fc2).

A shard is a tensor placed on its grid device, and a sum over shards is a
copy to the first device of its line and adds in shard order, so no
process group is used: where the reference's GSPMD inserts collectives,
the port copies and adds, and autograd differentiates through both. A grid
may repeat a device (eight entries of `cpu`, or of one card): the work
still splits into the same shards and sums the same way, and only distinct
devices hold copies of a tensor.

The SLAM path splits only over `dp` (`split_rows`, `replicate`, also named
`batch_sharding` and `replicated` as in the reference). Training splits
over both: `param_spec` states the tensor-parallel rule in the port's
layout, `shard_params` places the weights under it (a `Sharded` leaf per
split weight), `gather_params` puts them back together, and
`row_params` gives dp row d its view of the placed tree.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch


def canonical_device(dev) -> torch.device:
    """`dev` with the index of a bare "cuda" made explicit (the current
    card), so that equal devices compare and hash equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes: `devices` (dp, tp) object array of
    `torch.device`, `axis_names`, and `shape` {axis name: size}."""

    def __init__(self, devices, axis_names: Sequence[str] = ("dp", "tp")):
        grid = np.vectorize(canonical_device, otypes=[object])(np.asarray(devices, dtype=object))
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs {grid.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def home(self) -> torch.device:
        """Where gathered results and summed systems live."""
        return self.devices.flat[0]

    def shard_devices(self, axis: str = "dp") -> list:
        """The device of each shard along `axis` (a shard is replicated over
        the other axes, and runs on the first device of its line)."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return [grid[(i,) + (0,) * (grid.ndim - 1)] for i in range(grid.shape[0])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in dict.fromkeys(self.devices.flat)]})"


def make_mesh(n_devices: int | None = None, axes: Sequence[str] = ("dp", "tp"),
              devices=None) -> Mesh:
    """Factorize `devices` (by default every visible CUDA card; the first
    `n_devices` of them if given) into a (dp, tp) mesh: tp is the largest
    power of two that is at most isqrt(n) and divides n, so attention heads
    divide evenly."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("make_mesh needs at least one device")
    tp = 1
    while tp * 2 <= math.isqrt(n) and n % (tp * 2) == 0:
        tp *= 2
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // tp, tp), axes)


_COLUMN = ("qkv", "fc1")  # and cross-attention q, k, v


def param_spec(path: Sequence, leaf: torch.Tensor) -> tuple:
    """The tensor-parallel split of one weight of the port's parameter tree
    (models/init.py): a tuple with one entry per dim of `leaf`, "tp" on the
    dim that splits over the tp axis and None elsewhere (all None: the
    weight is replicated). `path` is the leaf's keys, list indices included
    (("enc_blocks", 3, "attn", "qkv", "w")).

    The rule is the TPU package's, moved to the port's layout. There a
    linear weight is (in, out) and the blocks of a stack share a leading
    depth axis; here a linear weight is (out, in), as `F.linear` takes it,
    and each block is a dict of its own. So
      * column-parallel qkv / fc1 / cross q, k, v (there: the last dim,
        the outputs): the weight splits dim 0 here, and the bias dim 0;
      * row-parallel attention or cross proj and fc2 (there: the
        second-to-last dim, the inputs): the weight splits dim 1 here, and
        the bias is replicated;
      * the depth axis has no counterpart, and every other weight is
        replicated."""
    name = "/".join(str(k) for k in path)
    nd = leaf.dim()
    spec = [None] * nd
    column = any(f"{n}/{p}" in name for n in _COLUMN for p in ("w", "b")) or any(
        name.endswith(f"cross/{n}/{p}") for n in ("q", "k", "v") for p in ("w", "b"))
    if column and nd >= 1:
        spec[0] = "tp"
    elif nd >= 2 and (("proj/w" in name and ("attn" in name or "cross" in name))
                      or "fc2/w" in name):
        spec[1] = "tp"
    return tuple(spec)


def split_rows(mesh: Mesh, x: torch.Tensor, axis: str = "dp") -> list:
    """`x` split into contiguous blocks of its leading dim, one per shard
    along `axis`, each on its shard's device (the counterpart of
    `batch_sharding`). The leading dim must divide by the axis size."""
    devs = mesh.shard_devices(axis)
    if x.shape[0] % len(devs):
        raise ValueError(f"leading dim {x.shape[0]} does not divide by {axis} size {len(devs)}")
    return [blk.to(dev) for blk, dev in zip(x.split(x.shape[0] // len(devs)), devs)]


def replicate(mesh: Mesh, x: torch.Tensor, axis: str = "dp") -> dict:
    """One copy of `x` on each distinct shard device along `axis`,
    {device: tensor} (the counterpart of `replicated`: the devices that no
    shard runs on hold no copy); the copy on x's own device is x."""
    return {dev: x.to(dev) for dev in dict.fromkeys(mesh.shard_devices(axis))}


batch_sharding = split_rows  # the reference's name: the leading dim split over dp
replicated = replicate  # the reference's name: a copy on each dp shard device


@dataclasses.dataclass
class Sharded:
    """A weight split over the tp axis: `parts[t]`, a contiguous tensor of
    its own, is shard t's piece, split along `dim`. With `groups` > 1 the
    dim holds that many equal segments (qkv's [q; k; v]) and part t joins
    the t-th tp piece of each segment, in segment order."""

    parts: list
    dim: int
    groups: int = 1

    @classmethod
    def split(cls, x: torch.Tensor, dim: int, groups: int, devices) -> "Sharded":
        """`x` split into one part per device of `devices` (new tensors, also
        on x's own device)."""
        return cls([p.to(dev) for p, dev in
                    zip(split_pieces(x, dim, len(devices), groups), devices)], dim, groups)

    def whole(self, parts=None) -> torch.Tensor:
        """The weight the parts split, on part 0's device; with `parts`,
        the tensor that those (tensors shaped as the parts, an AdamW moment
        of each, say) split in the same way."""
        parts = self.parts if parts is None else parts
        home = parts[0].device
        pieces = [p.to(home).chunk(self.groups, self.dim) for p in parts]
        return torch.cat([pieces[t][g] for g in range(self.groups) for t in range(len(parts))],
                         self.dim)


def split_pieces(x: torch.Tensor, dim: int, tp: int, groups: int = 1) -> list:
    """The tp pieces of `x` that `Sharded` holds: piece t joins the t-th of
    tp equal slices of each of the `groups` equal segments of `dim`."""
    if x.shape[dim] % (groups * tp):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {groups} x {tp}")
    segs = [s.chunk(tp, dim) for s in x.chunk(groups, dim)]
    return [torch.cat([s[t] for s in segs], dim).contiguous() for t in range(tp)]


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _map(fn, tree):
    return _map_with_path(lambda _, leaf: fn(leaf), tree)


def param_shardings(params, mesh: Mesh):
    """The tree of `param_spec` tuples of `params` (the mesh does not
    change the rule: it is taken for the reference's signature)."""
    del mesh
    return _map_with_path(param_spec, params)


@torch.no_grad()
def shard_params(params, mesh: Mesh):
    """A new tree of `params` placed on the mesh under the Megatron rule:
    each weight that `param_spec` splits becomes a `Sharded` of tp parts,
    part t on `mesh.devices[0, t]`; every other weight one copy on the home
    device. With tp 1 nothing is split, and every leaf is a plain copy on
    the home device.

    The reference's fused qkv weight holds [q; k; v] along the split dim
    (rows here, columns there), so a contiguous split would give shard 0
    all of q and half of k, which is no set of heads; GSPMD reshards
    around it, and the port has no GSPMD. So shard t of qkv (weight and
    bias) takes the rows of q, of k and of v of heads t H/tp ... (t+1) H/tp
    - 1 (`groups` 3), and the row-parallel proj splits its input dim in
    the same head order. Cross-attention's q, k and v are separate weights,
    so their contiguous split is already head-aligned."""
    tp = mesh.shape["tp"]

    def place(path, leaf):
        spec = param_spec(path, leaf)
        if tp == 1 or "tp" not in spec:
            return leaf.to(mesh.home, copy=True)
        return Sharded.split(leaf, spec.index("tp"), 3 if "qkv" in path else 1,
                             list(mesh.devices[0]))

    return _map_with_path(place, params)


@torch.no_grad()
def gather_params(sharded, mesh: Mesh):
    """The inverse of `shard_params`: one tree of plain tensors on the
    home device, copies of the placed weights (a snapshot)."""
    return _map(lambda leaf: leaf.whole().to(mesh.home) if isinstance(leaf, Sharded)
                else leaf.to(mesh.home, copy=True), sharded)


def row_params(sharded, mesh: Mesh, d: int):
    """The tree that dp row `d` computes with: each replicated weight on
    `mesh.devices[d, 0]` and part t of each split one on
    `mesh.devices[d, t]`, moved there by `.to`, which autograd
    differentiates (on a repeated device it is the tensor itself), so each
    weight's gradient sums over the dp rows."""
    devs = list(mesh.devices[d])

    def place(leaf):
        if isinstance(leaf, Sharded):
            return dataclasses.replace(leaf, parts=[p.to(dev) for p, dev in zip(leaf.parts, devs)])
        return leaf.to(devs[0])

    return _map(place, sharded)


def sum_home(parts) -> torch.Tensor:
    """The sum over shards: each tensor copied to the first one's device and
    added in shard order."""
    home = parts[0].device
    return functools.reduce(torch.add, [p.to(home) for p in parts])
