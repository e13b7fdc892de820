"""SLAM state: per-frame data and the fixed-capacity keyframe memory.

Port of the JAX package's `slam/frame.py`. The JAX keyframe memory is an
immutable pytree updated with `.at[].set`; here it is a dataclass of device
tensors updated IN PLACE (`kf_set`, `kf_append`, `kf_update_pointmap`,
`kf_update_poses` and the tracking step's keyframe fusion write into the
buffers). Readers that must keep a value across such an update take a copy.
Pointmap fusion (`fuse_pointmap`) covers the six filtering modes, each
branch-free on the first-observation predicate. The two weighted modes
leave a pixel that neither observation weighs (a dynamic pixel whose
confidence the mask zeroed in both) at its old point, where the JAX
package's means divide 0 by 0 and the NaN then fails every later solve
that reads the keyframe.

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
    encoder features, pos (1, n, 2), score () the best-score statistic,
    N_updates () int32; img (1, h, w, 3) the normalized image the encoder
    consumed (the dynamic mask's flow reads it)."""

    frame_id: int
    T_WC: torch.Tensor
    X_canon: torch.Tensor
    C: torch.Tensor
    N: torch.Tensor
    feat: torch.Tensor
    pos: torch.Tensor
    score: torch.Tensor
    img: Optional[torch.Tensor] = None
    N_updates: Optional[torch.Tensor] = None  # None: zero

    def get_average_conf(self) -> torch.Tensor:
        """C over the fusion count (at least 1)."""
        return self.C / torch.clamp(self.N.to(self.C.dtype), min=1.0)


def make_empty_frame(h: int, w: int, enc_dim: int, patch: int, device=None) -> Frame:
    """A zero frame at the identity pose, in the port's layout (batched
    feat, pos and img)."""
    hw = h * w
    n = hw // patch**2

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Frame(
        frame_id=0,
        T_WC=lie.sim3_identity(device=device),
        X_canon=zeros(hw, 3),
        C=zeros(hw, 1),
        N=zeros(dtype=torch.int32),
        feat=zeros(1, n, enc_dim),
        pos=zeros(1, n, 2, dtype=torch.int32),
        score=zeros(),
        img=zeros(1, h, w, 3),
        N_updates=zeros(dtype=torch.int32),
    )


def conf_score(C: torch.Tensor, filtering_score: str = "median") -> torch.Tensor:
    """Scalar pointmap-quality score over all of C. The median of an even
    count is the mean of the two middle values, as jnp.median's (torch.median
    would return the lower one)."""
    if filtering_score == "median":
        s = torch.sort(C.reshape(-1)).values
        n = s.shape[0]
        return (s[(n - 1) // 2] + s[n // 2]) * 0.5
    if filtering_score == "mean":
        return torch.mean(C)
    raise ValueError(f"unknown filtering_score {filtering_score}")


def _to_sph(P: torch.Tensor) -> torch.Tensor:
    r = torch.linalg.vector_norm(P, dim=-1, keepdim=True)
    x, y, z = P.split(1, dim=-1)
    phi = torch.atan2(y, x)
    theta = torch.arccos(torch.clamp(z / torch.clamp(r, min=1e-12), -1.0, 1.0))
    return torch.cat([r, phi, theta], dim=-1)


def _to_cart(s: torch.Tensor) -> torch.Tensor:
    r, phi, theta = s.split(1, dim=-1)
    st = torch.sin(theta)
    return torch.cat([r * st * torch.cos(phi), r * st * torch.sin(phi), r * torch.cos(theta)],
                     dim=-1)


def _weighted(C_old, X_old, C_new, X_new):
    """The confidence-weighted mean of two observations; a pixel that
    neither weighs (both confidences 0, as on a dynamic pixel the mask
    zeroed in both) keeps its old value, where the mean would be 0/0."""
    C = C_old + C_new
    return torch.where(C > 0, (C_old * X_old + C_new * X_new) / torch.where(C > 0, C, 1.0), X_old)


def fuse_pointmap(X_old, C_old, N_old, X_new, C_new, mode: str = "weighted_pointmap",
                  score_old=None, filtering_score: str = "median"):
    """Fuse a new pointmap observation into the canonical one; returns
    (X, C, N, score). The first observation (N_old == 0) always replaces;
    every mode selects on that predicate with `torch.where`, never on the
    host. Only `best_score` maintains the score; the others pass it through."""
    first = N_old == 0
    one = torch.ones_like(N_old)
    if score_old is None:
        score_old = torch.zeros((), dtype=torch.float32, device=X_old.device)
    score = score_old
    if mode == "first":
        X = torch.where(first, X_new, X_old)
        C = torch.where(first, C_new, C_old)
        N = torch.where(first, one, N_old)
    elif mode == "recent":
        X, C, N = X_new, C_new, one
    elif mode == "best_score":
        new_score = conf_score(C_new, filtering_score)
        better = first | (new_score > score_old)
        X = torch.where(better, X_new, X_old)
        C = torch.where(better, C_new, C_old)
        N = torch.where(better, one, N_old)
        score = torch.where(better, new_score, score_old)
    elif mode == "indep_conf":
        better = C_new > C_old
        X = torch.where(first, X_new, torch.where(better, X_new, X_old))
        C = torch.where(first, C_new, torch.where(better, C_new, C_old))
        N = one
    elif mode == "weighted_pointmap":
        X_f = _weighted(C_old, X_old, C_new, X_new)
        X = torch.where(first, X_new, X_f)
        C = torch.where(first, C_new, C_old + C_new)
        N = torch.where(first, one, N_old + 1)
    elif mode == "weighted_spherical":
        sph = _weighted(C_old, _to_sph(X_old), C_new, _to_sph(X_new))
        X = torch.where(first, X_new, _to_cart(sph))
        C = torch.where(first, C_new, C_old + C_new)
        N = torch.where(first, one, N_old + 1)
    else:
        raise ValueError(f"unknown filtering_mode {mode}")
    return X, C, N, score


@dataclasses.dataclass
class KeyframeMemory:
    """Fixed-capacity keyframe store; all tensors are (capacity, ...), and
    `count` is the live size (a host int)."""

    frame_id: torch.Tensor  # (cap,) int32
    T_WC: torch.Tensor  # (cap, 8)
    X_canon: torch.Tensor  # (cap, hw, 3)
    C: torch.Tensor  # (cap, hw, 1)
    N: torch.Tensor  # (cap,) int32
    N_updates: torch.Tensor  # (cap,) int32
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
        N_updates=zeros(capacity, dtype=torch.int32),
        feat=zeros(capacity, n, enc_dim),
        pos=zeros(capacity, n, 2, dtype=torch.int32),
        score=zeros(capacity),
        count=0,
    )


def kf_set(mem: KeyframeMemory, idx: int, frame: Frame) -> int:
    """Copy `frame` into slot `idx` in place and bump `count` to
    max(count, idx + 1); returns the slot."""
    if not 0 <= idx < mem.capacity:
        raise RuntimeError(f"keyframe slot {idx} is outside the memory (capacity "
                           f"{mem.capacity})")
    mem.frame_id[idx] = frame.frame_id
    mem.T_WC[idx] = frame.T_WC
    mem.X_canon[idx] = frame.X_canon
    mem.C[idx] = frame.C
    mem.N[idx] = frame.N
    mem.N_updates[idx] = 0 if frame.N_updates is None else frame.N_updates
    mem.feat[idx] = frame.feat.reshape(mem.feat.shape[1:])
    mem.pos[idx] = frame.pos.reshape(mem.pos.shape[1:])
    mem.score[idx] = frame.score
    mem.count = max(mem.count, idx + 1)
    return idx


def kf_append(mem: KeyframeMemory, frame: Frame) -> int:
    """Copy `frame` into slot `mem.count` in place; returns the slot."""
    return kf_set(mem, mem.count, frame)


def kf_get(mem: KeyframeMemory, idx: int, img_placeholder=None) -> Frame:
    """Slot `idx` as a Frame of views into the memory (the image is not
    stored; `img_placeholder` stands for it). Take copies to keep values
    across a later in-place update."""
    return Frame(
        frame_id=mem.frame_id[idx],
        T_WC=mem.T_WC[idx],
        X_canon=mem.X_canon[idx],
        C=mem.C[idx],
        N=mem.N[idx],
        feat=mem.feat[idx],
        pos=mem.pos[idx],
        score=mem.score[idx],
        img=img_placeholder,
        N_updates=mem.N_updates[idx],
    )


def kf_update_pointmap(mem: KeyframeMemory, idx: int, X: torch.Tensor, C: torch.Tensor,
                       mode: str, filtering_score: str = "median") -> None:
    """Fuse the observation (X, C) into slot `idx` in place and count the
    update in `N_updates`."""
    X_f, C_f, N_f, S_f = fuse_pointmap(mem.X_canon[idx], mem.C[idx], mem.N[idx], X, C, mode,
                                       score_old=mem.score[idx],
                                       filtering_score=filtering_score)
    mem.X_canon[idx] = X_f
    mem.C[idx] = C_f
    mem.N[idx] = N_f
    mem.N_updates[idx] += 1
    mem.score[idx] = S_f


def kf_update_poses(mem: KeyframeMemory, T_WCs: torch.Tensor, idx: torch.Tensor) -> None:
    """Write poses `T_WCs` into slots `idx`, in place."""
    mem.T_WC[idx] = T_WCs
