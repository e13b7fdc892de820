"""Device mesh of the SLAM path, and the Megatron rule of the model weights.

Port of the TPU package's `parallel/mesh.py` for one process: a `Mesh` is
a plain object holding a (dp, tp) grid of `torch.device`, with named axes

  * `dp`: data parallel over frames, pairs and edges (the leading batch dim);
  * `tp`: tensor parallel over the ViT hidden dims (Megatron-style:
    column-parallel qkv / fc1 / cross q, k, v, row-parallel proj / fc2).

A shard is a tensor placed on its grid device, and a sum over shards is a
copy to the home device `devices[0, 0]` and adds in shard order, so no
process group is used. A grid may repeat a device (eight entries of `cpu`,
or of one card): the work still splits into the same shards and sums the
same way, and only distinct devices hold copies of a tensor.

The SLAM path splits only over `dp` (`split_rows`, `replicate`: the
counterparts of `batch_sharding` and `replicated`); `param_spec` states the
tensor-parallel rule in the port's layout. Placing the weights under that
rule (`shard_params`, `param_shardings`) belongs to the training path's
dp x tp mesh, the only user of those two, and is not ported yet.
"""

from __future__ import annotations

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

