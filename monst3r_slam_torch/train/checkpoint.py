"""Checkpoint and resume of the whole training state.

Port of the JAX package's `train/checkpoint.py` in the port's own format
(the reference writes orbax directories): one `torch.save` file per step,
`step_<step>.pt`, holding the step, the weights by parameter path
(`step.named_leaves`) and the AdamW state (moments and step count) by the
same paths, all on the CPU. A weight split over a mesh's tp axis (a
`Sharded` leaf) is stored whole, its parts and their moments joined, and
split again on restore into the parts of the state restored into: the file
does not depend on the grid, and a run resumed on another grid continues
the same run. A file is written under a temporary name and renamed into
place, and the directory keeps the newest `max_to_keep`. A run resumed on
the same grid continues bit for bit. The final-weights `.npz` that
`train_torch.py --save` writes is the interchangeable format.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
from typing import Optional

import torch

from monst3r_slam_torch.parallel.mesh import Sharded, split_pieces
from monst3r_slam_torch.train.step import TrainState, leaf_parts, named_leaves

_NAME = re.compile(r"step_(\d+)\.pt")


@dataclasses.dataclass(frozen=True)
class CheckpointManager:
    path: pathlib.Path
    max_to_keep: int

    def steps(self) -> list:
        return sorted(int(m.group(1)) for f in self.path.iterdir()
                      if (m := _NAME.fullmatch(f.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def file(self, step: int) -> pathlib.Path:
        return self.path / f"step_{step}.pt"


def make_manager(ckpt_dir, max_to_keep: int = 3) -> CheckpointManager:
    path = pathlib.Path(ckpt_dir).resolve()
    path.mkdir(parents=True, exist_ok=True)
    return CheckpointManager(path, max_to_keep)


def _indexed(params) -> list:
    """[(path, leaf, the optimizer's indices of its tensors)] in order."""
    out, i = [], 0
    for name, w in named_leaves(params):
        n = len(leaf_parts(w))
        out.append((name, w, range(i, i + n)))
        i += n
    return out


def _whole(w, parts) -> torch.Tensor:
    return w.whole(parts) if isinstance(w, Sharded) else parts[0]


def _pieces(w, x: torch.Tensor) -> list:
    """`x`, a whole weight or moment, as the tensors of leaf `w`."""
    return split_pieces(x, w.dim, len(w.parts), w.groups) if isinstance(w, Sharded) else [x]


def save(mngr: CheckpointManager, state: TrainState) -> None:
    """Write `state` as its step's file; as orbax does, a step at or below
    the newest saved one is skipped."""
    latest = mngr.latest_step()
    if latest is not None and state.step <= latest:
        return
    opt = state.opt_state.state_dict()["state"]
    params, adamw = {}, {}
    for name, w, idx in _indexed(state.params):
        params[name] = _whole(w, leaf_parts(w)).detach().cpu()
        if idx[0] in opt:
            adamw[name] = {k: (v if k == "step" else _whole(w, [opt[i][k] for i in idx])).cpu()
                           for k, v in opt[idx[0]].items()}
    blob = {"step": state.step, "params": params, "adamw": adamw}
    tmp = mngr.file(state.step).with_suffix(".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, mngr.file(state.step))
    for old in mngr.steps()[:-mngr.max_to_keep]:
        mngr.file(old).unlink()


def restore_latest(mngr: CheckpointManager, like: TrainState) -> Optional[TrainState]:
    """The newest checkpoint copied into `like`'s weights and optimizer
    (their devices and split, the optimizer's settings), or None when the
    directory holds no checkpoint yet."""
    step = mngr.latest_step()
    if step is None:
        return None
    blob = torch.load(mngr.file(step), map_location="cpu", weights_only=True)
    leaves = _indexed(like.params)
    if sorted(blob["params"]) != sorted(name for name, _, _ in leaves):
        raise ValueError(f"{mngr.file(step)} holds another parameter tree")
    opt = like.opt_state.state_dict()
    opt["state"] = {}
    with torch.no_grad():
        for name, w, idx in leaves:
            for t, piece in zip(leaf_parts(w), _pieces(w, blob["params"][name])):
                t.copy_(piece)
            if name in blob["adamw"]:
                # each part gets a step count of its own: AdamW adds to it in place
                moments = {k: [v.clone() for _ in idx] if k == "step" else _pieces(w, v)
                           for k, v in blob["adamw"][name].items()}
                for j, i in enumerate(idx):
                    opt["state"][i] = {k: v[j] for k, v in moments.items()}
    like.opt_state.load_state_dict(opt)
    return TrainState(like.params, like.opt_state, blob["step"])
