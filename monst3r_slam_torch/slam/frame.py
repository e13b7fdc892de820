"""SLAM state: per-frame data and the fixed-capacity keyframe memory.

Port of the JAX package's `slam/frame.py`. The JAX keyframe memory is an
immutable pytree updated with `.at[].set`; here it is a dataclass of device
tensors updated IN PLACE (`kf_append`, `kf_update_poses` and the tracking
step's keyframe fusion write into the buffers). Readers that must keep a
value across such an update take a copy.

Poses are Sim(3) 8-vectors (core.lie).
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Optional

import torch

from monst3r_slam_torch.core import lie


class Mode(IntEnum):
    INIT = 0
    TRACKING = 1
    RELOC = 2


@dataclasses.dataclass
class Frame:
    """One video frame's SLAM state (hw = h*w, n = patches):
    T_WC (8,), X_canon (hw, 3), C (hw, 1), N () int32, feat (1, n, enc_dim)
    encoder features, pos (1, n, 2), score (); img (1, h, w, 3) the
    normalized image the encoder consumed (the dynamic mask's flow reads it)."""

    frame_id: int
    T_WC: torch.Tensor
    X_canon: torch.Tensor
    C: torch.Tensor
    N: torch.Tensor
    feat: torch.Tensor
    pos: torch.Tensor
    score: torch.Tensor
    img: Optional[torch.Tensor] = None


def fuse_pointmap(X_old, C_old, N_old, X_new, C_new, mode: str = "weighted_pointmap",
                  score_old=None, filtering_score: str = "median"):
    """Fuse a new pointmap observation into the canonical one; returns
    (X, C, N, score). The first observation (N_old == 0) replaces. Only the
    default `weighted_pointmap` mode is ported; its score passes through."""
    if mode != "weighted_pointmap":
        raise NotImplementedError(f"filtering_mode {mode!r} is not ported yet")
    if score_old is None:
        score_old = torch.zeros((), dtype=torch.float32, device=X_old.device)
    first = N_old == 0
    X_f = (C_old * X_old + C_new * X_new) / (C_old + C_new)
    X = torch.where(first, X_new, X_f)
    C = torch.where(first, C_new, C_old + C_new)
    N = torch.where(first, torch.ones_like(N_old), N_old + 1)
    return X, C, N, score_old


@dataclasses.dataclass
class KeyframeMemory:
    """Fixed-capacity keyframe store; all tensors are (capacity, ...), and
    `count` is the live size (a host int)."""

    frame_id: torch.Tensor  # (cap,) int32
    T_WC: torch.Tensor  # (cap, 8)
    X_canon: torch.Tensor  # (cap, hw, 3)
    C: torch.Tensor  # (cap, hw, 1)
    N: torch.Tensor  # (cap,) int32
    feat: torch.Tensor  # (cap, n, enc_dim)
    pos: torch.Tensor  # (cap, n, 2)
    score: torch.Tensor  # (cap,)
    count: int = 0

    @property
    def capacity(self) -> int:
        return self.frame_id.shape[0]


def make_keyframe_memory(capacity: int, h: int, w: int, enc_dim: int, patch: int,
                         device=None) -> KeyframeMemory:
    hw = h * w
    n = hw // patch**2

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return KeyframeMemory(
        frame_id=zeros(capacity, dtype=torch.int32),
        T_WC=lie.sim3_identity((capacity,), device=device),
        X_canon=zeros(capacity, hw, 3),
        C=zeros(capacity, hw, 1),
        N=zeros(capacity, dtype=torch.int32),
        feat=zeros(capacity, n, enc_dim),
        pos=zeros(capacity, n, 2, dtype=torch.int32),
        score=zeros(capacity),
        count=0,
    )


def kf_append(mem: KeyframeMemory, frame: Frame) -> int:
    """Copy `frame` into slot `mem.count` in place; returns the slot."""
    idx = mem.count
    if idx >= mem.capacity:
        raise RuntimeError(f"keyframe memory full ({idx}/{mem.capacity})")
    mem.frame_id[idx] = frame.frame_id
    mem.T_WC[idx] = frame.T_WC
    mem.X_canon[idx] = frame.X_canon
    mem.C[idx] = frame.C
    mem.N[idx] = frame.N
    mem.feat[idx] = frame.feat.reshape(mem.feat.shape[1:])
    mem.pos[idx] = frame.pos.reshape(mem.pos.shape[1:])
    mem.score[idx] = frame.score
    mem.count = idx + 1
    return idx


def kf_update_poses(mem: KeyframeMemory, T_WCs: torch.Tensor, idx: torch.Tensor) -> None:
    """Write poses `T_WCs` into slots `idx`, in place."""
    mem.T_WC[idx] = T_WCs
