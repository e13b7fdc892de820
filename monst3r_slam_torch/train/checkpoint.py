"""Checkpoint and resume of the whole training state.

Port of the JAX package's `train/checkpoint.py` in the port's own format
(the reference writes orbax directories): one `torch.save` file per step,
`step_<step>.pt`, holding the step, the weights by parameter path
(`step.named_leaves`) and the AdamW state (moments and step count) by the
same paths, all on the CPU. A file is written under a temporary name and
renamed into place, and the directory keeps the newest `max_to_keep`. A
resumed run continues bit for bit. The final-weights `.npz` that
`train_torch.py --save` writes is the interchangeable format.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
from typing import Optional

import torch

from monst3r_slam_torch.train.step import TrainState, named_leaves

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


def save(mngr: CheckpointManager, state: TrainState) -> None:
    """Write `state` as its step's file; as orbax does, a step at or below
    the newest saved one is skipped."""
    latest = mngr.latest_step()
    if latest is not None and state.step <= latest:
        return
    leaves = named_leaves(state.params)
    opt = state.opt_state.state_dict()
    blob = {
        "step": state.step,
        "params": {name: t.detach().cpu() for name, t in leaves},
        "adamw": {leaves[i][0]: {k: v.cpu() for k, v in s.items()}
                  for i, s in opt["state"].items()},
    }
    tmp = mngr.file(state.step).with_suffix(".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, mngr.file(state.step))
    for old in mngr.steps()[:-mngr.max_to_keep]:
        mngr.file(old).unlink()


def restore_latest(mngr: CheckpointManager, like: TrainState) -> Optional[TrainState]:
    """The newest checkpoint copied into `like`'s weights and optimizer
    (their devices, the optimizer's settings), or None when the directory
    holds no checkpoint yet."""
    step = mngr.latest_step()
    if step is None:
        return None
    blob = torch.load(mngr.file(step), map_location="cpu", weights_only=True)
    leaves = named_leaves(like.params)
    if sorted(blob["params"]) != sorted(n for n, _ in leaves):
        raise ValueError(f"{mngr.file(step)} holds another parameter tree")
    with torch.no_grad():
        for name, t in leaves:
            t.copy_(blob["params"][name])
    opt = like.opt_state.state_dict()
    opt["state"] = {i: blob["adamw"][name] for i, (name, _) in enumerate(leaves)
                    if name in blob["adamw"]}
    like.opt_state.load_state_dict(opt)
    return TrainState(like.params, like.opt_state, blob["step"])
