"""Native dynamic-mask refinement: the port's own copy of the JAX package's
`dynamic/refine.py` (host numpy, scipy and OpenCV; no device work).

The reference refines its raw flow-error mask with a SAM2 video predictor;
this native refiner plays the same role:

  1. **Hysteresis growth on the flow-error map**: pixels above the high
     threshold seed regions that grow into any connected pixel above a lower
     threshold.
  2. **GrabCut colour refinement**: the grown mask initializes a GrabCut
     trimap (eroded core certain foreground, the mask probable foreground, a
     dilated ring probable background, the rest background), and the colour
     models snap the mask to the image's boundaries.

`TemporalMaskPropagator` carries each frame's refined mask into the next one
along the optical flow (the video predictor's trick). `cv2.grabCut` draws
its initial colour models from OpenCV's global RNG (`cv2.setRNGSeed`), so
two equal calls in one process may differ unless the seed is set before
each.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def hysteresis_mask(err_norm: np.ndarray, high: float = 0.35, low: float = 0.15) -> np.ndarray:
    """Grow seeds (err > high) into connected support (err > low); bool (h, w)."""
    from scipy import ndimage

    seeds = err_norm > high
    support = err_norm > low
    if not seeds.any():
        return seeds
    labeled, n = ndimage.label(support)
    keep = np.unique(labeled[seeds])
    keep = keep[keep > 0]
    return np.isin(labeled, keep)


def grabcut_refine(img_u8: np.ndarray, mask: np.ndarray, iters: int = 3, margin: int = 7,
                   scale: int = 3) -> np.ndarray:
    """Snap a coarse object mask to image boundaries with GrabCut; bool
    (h, w), the input mask where GrabCut cannot run (degenerate trimaps,
    tiny masks). `scale` > 1 runs the cut at (h/scale, w/scale) and
    upsamples the result with nearest-neighbour."""
    import cv2

    mask = np.asarray(mask, bool)
    if not mask.any() or mask.all():
        return mask
    if scale > 1:
        h, w = mask.shape
        hs, ws = max(h // scale, 8), max(w // scale, 8)
        img_s = cv2.resize(np.ascontiguousarray(img_u8[..., :3]), (ws, hs),
                           interpolation=cv2.INTER_AREA)
        mask_s = cv2.resize(mask.astype(np.uint8), (ws, hs),
                            interpolation=cv2.INTER_NEAREST).astype(bool)
        if not mask_s.any() or mask_s.all():
            # a thin mask can vanish under the decimation: keep the input
            return mask
        out_s = grabcut_refine(img_s, mask_s, iters=iters, margin=max(margin // scale, 2), scale=1)
        return cv2.resize(out_s.astype(np.uint8), (w, h),
                          interpolation=cv2.INTER_NEAREST).astype(bool)
    kernel = np.ones((3, 3), np.uint8)
    m8 = mask.astype(np.uint8)
    core = cv2.erode(m8, kernel, iterations=2).astype(bool)
    ring = cv2.dilate(m8, kernel, iterations=margin).astype(bool)

    gc = np.full(mask.shape, cv2.GC_BGD, np.uint8)
    gc[ring] = cv2.GC_PR_BGD
    gc[mask] = cv2.GC_PR_FGD
    gc[core] = cv2.GC_FGD
    # GrabCut needs both foreground and background evidence for its models
    if not (gc == cv2.GC_BGD).any() or not (core.any() or mask.any()):
        return mask
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(np.ascontiguousarray(img_u8[..., :3]), gc, None, bgd, fgd, iters,
                    cv2.GC_INIT_WITH_MASK)
    except cv2.error:
        return mask
    return (gc == cv2.GC_FGD) | (gc == cv2.GC_PR_FGD)


def refine_dynamic_mask(img_u8: np.ndarray, err_norm: np.ndarray, raw_mask: np.ndarray,
                        threshold: float = 0.35, low_ratio: float = 0.45, min_area: int = 20,
                        use_grabcut: bool = True) -> np.ndarray:
    """Hysteresis growth -> removal of regions under `min_area` -> GrabCut.
    `raw_mask` pixels always stay seeds."""
    from scipy import ndimage

    grown = hysteresis_mask(err_norm, threshold, threshold * low_ratio)
    grown |= np.asarray(raw_mask, bool)

    labeled, n = ndimage.label(grown)
    if n:
        sizes = np.bincount(labeled.ravel())
        small = sizes < min_area
        small[0] = False
        grown[small[labeled]] = False

    if use_grabcut and grown.any():
        grown = grabcut_refine(img_u8, grown)
    return grown


def make_native_refiner(use_grabcut: bool = True, low_ratio: float = 0.45):
    """A refiner for dynamic.mask.set_mask_refiner,
    fn(img_u8, err_norm, raw_mask, threshold, min_area) -> bool mask."""

    def refiner(img_u8, err_norm, raw_mask, threshold, min_area):
        return refine_dynamic_mask(img_u8, err_norm, raw_mask, threshold=threshold,
                                   low_ratio=low_ratio, min_area=min_area,
                                   use_grabcut=use_grabcut)

    return refiner


# ---------------------------------------------------------------------------
# Temporal mask propagation
# ---------------------------------------------------------------------------


def forward_warp_mask(mask: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Splat a bool mask (h, w) forward along flow (h, w, 2) into the next
    frame; a morphological closing fills the splat's holes."""
    from scipy import ndimage

    h, w = mask.shape
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return np.zeros_like(mask)
    u = flow[ys, xs, 0]
    v = flow[ys, xs, 1]
    xn = np.clip(np.rint(xs + u).astype(np.int64), 0, w - 1)
    yn = np.clip(np.rint(ys + v).astype(np.int64), 0, h - 1)
    out = np.zeros((h, w), bool)
    out[yn, xn] = True
    return ndimage.binary_closing(out, structure=np.ones((3, 3), bool))


class TemporalMaskPropagator:
    """Carry each frame's refined dynamic mask into the next frame:

      1. flow-warp the previous refined mask into the current frame,
      2. keep a warped pixel dynamic if its current flow error clears
         `carry_ratio * threshold` (temporal hysteresis),
      3. refine the union (fresh raw mask | carried support) per frame.

    A mask without fresh above-threshold evidence for `max_coast`
    consecutive frames is dropped: objects that stop moving return to the
    static set."""

    def __init__(self, carry_ratio: float = 0.5, max_coast: int = 2):
        self.carry_ratio = carry_ratio
        self.max_coast = max_coast
        self.prev_mask: Optional[np.ndarray] = None
        self.prev_img: Optional[np.ndarray] = None
        self._coast = 0

    def reset(self):
        self.prev_mask = None
        self.prev_img = None
        self._coast = 0

    def __call__(self, img_u8: np.ndarray, err_norm: np.ndarray, raw_mask: np.ndarray,
                 threshold: float, min_area: int, flow_fn=None,
                 use_grabcut: bool = True) -> np.ndarray:
        from monst3r_slam_torch.dynamic import mask as _mask_mod

        carried = None
        if self.prev_mask is not None and self.prev_mask.any():
            if flow_fn is None:
                flow_fn = _mask_mod.compute_flow
            flow = np.asarray(flow_fn(self.prev_img, img_u8), np.float32)
            warped = forward_warp_mask(self.prev_mask, flow)
            carried = warped & (err_norm > self.carry_ratio * threshold)

        seeds = np.asarray(raw_mask, bool)
        if carried is not None:
            seeds = seeds | carried
        # The installed refiner refines the seeds when there is one, else
        # the native one; never this propagator itself or its adapter.
        base = _mask_mod._mask_refiner
        if (base is not None and base is not self
                and getattr(base, "_temporal_propagator", None) is not self):
            refined = np.asarray(base(img_u8, err_norm, seeds, threshold, min_area), bool)
        else:
            refined = refine_dynamic_mask(img_u8, err_norm, seeds, threshold=threshold,
                                          min_area=min_area, use_grabcut=use_grabcut)
        if carried is not None and refined.any():
            refined |= carried  # carried support survives a GrabCut trim

        if np.asarray(raw_mask, bool).any():
            self._coast = 0
        else:
            self._coast += 1
            if self._coast > self.max_coast:
                refined = np.zeros_like(refined)
        self.prev_mask = refined.copy()
        self.prev_img = np.asarray(img_u8).copy()
        return refined

    def as_refiner(self, flow_fn=None, use_grabcut: bool = True):
        """Adapter for dynamic.mask.set_mask_refiner / get_dynamic_mask,
        tagged so that the propagator recognizes it if it is installed."""

        def refiner(img_u8, err_norm, raw_mask, threshold, min_area):
            return self(img_u8, err_norm, raw_mask, threshold, min_area, flow_fn=flow_fn,
                        use_grabcut=use_grabcut)

        refiner._temporal_propagator = self
        return refiner
