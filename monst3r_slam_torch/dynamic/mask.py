"""Dynamic-object masking: optical flow against ego-motion flow.

Port of the JAX package's `dynamic/mask.py`: dense optical flow between the
frame and its keyframe is compared with the flow that camera motion alone
induces (MonST3R depth through the relative Sim(3) and the pinhole model);
the min-max-normalized error map is thresholded at
`dynamic_mask_threshold` and optionally refined on the host.

The flow comes from a pluggable estimator, OpenCV DIS on the host by
default, or from a fused device program (`raft.make_fused_flow_error_program`)
that returns only the error map. Both, and the refiner, are installed with
the reference's module-level setters.
"""

from __future__ import annotations

import inspect
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from monst3r_slam_torch.core import lie


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def ego_motion_flow(T_WCi, T_WCj, depth_i: torch.Tensor, K) -> torch.Tensor:
    """Flow (h, w, 2) from frame i to j induced by camera motion alone:
    p_j = K (R_ji (d K^-1 p_i) + t_ji), flow = p_j - p_i, with the Sim(3)
    relative pose reduced to its 4x4 matrix (the rotation block carries the
    scale)."""
    dev = depth_i.device
    T_WCi, T_WCj, K = _f32(T_WCi, dev), _f32(T_WCj, dev), _f32(K, dev)
    h, w = depth_i.shape
    M = lie.sim3_matrix(lie.sim3_rel(T_WCj, T_WCi))  # j <- i
    R, t = M[:3, :3], M[:3, 3]
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    rays = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    P_j = (depth_i[..., None] * rays) @ R.T + t
    z = torch.clamp(P_j[..., 2], min=1e-6)
    u_j = fx * P_j[..., 0] / z + cx
    v_j = fy * P_j[..., 1] / z + cy
    return torch.stack([u_j - u, v_j - v], dim=-1)


def flow_error_map(flow: torch.Tensor, ego_flow: torch.Tensor) -> torch.Tensor:
    """Min-max-normalized flow-error map."""
    err = torch.linalg.vector_norm(flow - ego_flow, dim=-1)
    lo, hi = torch.min(err), torch.max(err)
    return torch.where(hi > lo, (err - lo) / (hi - lo), torch.zeros_like(err))


def flow_error_mask(flow: torch.Tensor, ego_flow: torch.Tensor,
                    threshold: float = 0.35) -> torch.Tensor:
    """The normalized flow-error map thresholded to a boolean mask."""
    return flow_error_map(flow, ego_flow) > threshold


# ---------------------------------------------------------------------------
# Flow estimation backend (host)
# ---------------------------------------------------------------------------

_flow_estimator: Optional[Callable] = None


def set_flow_estimator(fn: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]]):
    """Install a flow backend: fn(img_i, img_j) -> (h, w, 2) float32, the
    images HWC uint8 RGB; None restores OpenCV DIS."""
    global _flow_estimator
    _flow_estimator = fn


def compute_flow(img_i: np.ndarray, img_j: np.ndarray) -> np.ndarray:
    """Dense optical flow i -> j: the installed estimator, else OpenCV DIS."""
    if _flow_estimator is not None:
        return np.asarray(_flow_estimator(img_i, img_j), np.float32)
    import cv2

    g_i = cv2.cvtColor(img_i, cv2.COLOR_RGB2GRAY)
    g_j = cv2.cvtColor(img_j, cv2.COLOR_RGB2GRAY)
    dis = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
    return np.asarray(dis.calc(g_i, g_j, None), np.float32)


# (fn, takes_overlap_cb) as one tuple, so a reader racing a swap always sees
# a consistent pair.
_flow_error_program: Tuple[Optional[Callable], bool] = (None, False)


def set_flow_error_program(fn: Optional[Callable], takes_overlap_cb=None):
    """Install a fused device program for the error map,
    fn(img_i, img_j, T_WCi, T_WCj, depth_i, K) -> err_norm (h, w) numpy.

    A program may take an `overlap_cb` keyword: a zero-argument callable it
    must invoke after enqueueing its device work and before waiting for its
    result, so that the caller's independent device work (the dual
    pipeline's MASt3R decode) runs while the host consumes the map. Support
    is read from the signature (an `overlap_cb` parameter or **kwargs);
    `takes_overlap_cb` overrides that for a callable whose signature cannot
    be inspected."""
    global _flow_error_program
    takes_cb = bool(takes_overlap_cb)
    if fn is not None and takes_overlap_cb is None:
        try:
            params = inspect.signature(fn).parameters
            takes_cb = "overlap_cb" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
        except (TypeError, ValueError):
            takes_cb = False
    _flow_error_program = (fn, takes_cb)


# ---------------------------------------------------------------------------
# Region prompts / refinement hooks
# ---------------------------------------------------------------------------


def connected_component_centroids(mask: np.ndarray, min_area: int = 20) -> List[Tuple[int, int]]:
    """(x, y) centroids of the connected regions of at least `min_area` px."""
    from scipy import ndimage

    labeled, n = ndimage.label(np.asarray(mask, bool))
    out = []
    for idx in range(1, n + 1):
        ys, xs = np.nonzero(labeled == idx)
        if ys.size >= min_area:
            out.append((int(xs.mean()), int(ys.mean())))
    return out


_mask_refiner: Optional[Callable] = None


def set_mask_refiner(fn: Optional[Callable]):
    """Install a refiner fn(img_u8, err_norm, raw_mask, threshold, min_area)
    -> bool (h, w). With refinement requested and none installed, the native
    hysteresis + GrabCut refiner (dynamic/refine.py) runs."""
    global _mask_refiner
    _mask_refiner = fn


def get_dynamic_mask(
    img_i_u8: np.ndarray,
    img_j_u8: np.ndarray,
    T_WCi,
    T_WCj,
    depth_i,
    K,
    threshold: float = 0.35,
    refine: bool = False,
    min_area: int = 20,
    refiner: Optional[Callable] = None,
    img_i_flow=None,
    overlap_cb: Optional[Callable] = None,
) -> np.ndarray:
    """The dynamic mask of a frame pair, bool (h, w); empty without K.

    `refiner` overrides the installed or default refinement (e.g. a
    `TemporalMaskPropagator.as_refiner()`, which is then also called on
    frames whose raw mask is empty, so its state advances). `img_i_flow`
    gives frame i's image for the flow as a device tensor (uint8, or the
    normalized image the encoder consumed); `img_i_u8` still feeds the
    host refiner. `overlap_cb` (zero-argument) enqueues independent device
    work: it runs right after the flow program is enqueued when the
    installed program takes it, else up front; it runs exactly once in
    every case, so callers may rely on it by return time."""
    h, w = img_i_u8.shape[:2]
    if K is None:
        if overlap_cb is not None:
            overlap_cb()
        return np.zeros((h, w), bool)
    program, program_takes_cb = _flow_error_program
    if program is not None:
        kw = {}
        if overlap_cb is not None:
            if program_takes_cb:
                kw["overlap_cb"] = overlap_cb
            else:
                overlap_cb()
        err_norm = np.asarray(program(img_i_u8 if img_i_flow is None else img_i_flow,
                                      img_j_u8, T_WCi, T_WCj, depth_i, K, **kw))
    else:
        # host flow: the device idles during it, so its work goes first
        if overlap_cb is not None:
            overlap_cb()
        flow = compute_flow(img_i_u8, img_j_u8)
        ego = ego_motion_flow(T_WCi, T_WCj, _f32(depth_i), K).cpu()
        err_norm = flow_error_map(torch.from_numpy(flow), ego).numpy()
    mask = err_norm > threshold
    if refine and (mask.any() or refiner is not None):
        if refiner is None:
            refiner = _mask_refiner
        if refiner is None:
            from monst3r_slam_torch.dynamic.refine import make_native_refiner

            refiner = make_native_refiner()
        refined = refiner(img_i_u8, err_norm, mask, threshold, min_area)
        if refined is not None and refined.shape == mask.shape:
            mask = np.asarray(refined, bool)
    return mask


def apply_dynamic_mask_to_pointmaps(X, C, D, Q, mask_flat):
    """Zero confidences and descriptors on dynamic pixels
    (monst3r_utils.py:300-344): C, Q and D to 0 where `mask_flat` (..., hw)
    is set, X unchanged; Q and D may be None."""
    keep = (~mask_flat)[..., None]
    C = C * keep
    if Q is not None:
        Q = Q * keep
    if D is not None:
        D = D * keep
    return X, C, D, Q


def apply_dynamic_mask_native(C: torch.Tensor, D: torch.Tensor, Q: torch.Tensor, mask_hw):
    """Zero C, D and Q on dynamic pixels, decoder-native shapes: C/Q (B, H,
    W), D (B, H, W, F), mask (H, W) bool (host or device)."""
    keep = (~torch.as_tensor(mask_hw, dtype=torch.bool, device=C.device))[None].to(C.dtype)
    return C * keep, D * keep[..., None], Q * keep
