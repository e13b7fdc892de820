"""Debug dumps of the dynamic pipeline: the mask overlays.

The port's copy of `save_mask_overlay` from the JAX package's
`viz/debug.py`, writing the same PNG bytes. The pointmap panels and the 3D
scatter of that module are not ported: `SLAMSystem` refuses the config keys
that turn them on.
"""

from __future__ import annotations

import pathlib

import numpy as np


def _np_img(img) -> np.ndarray:
    """-> (h, w, 3) float in [0, 1]."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] == 3:
        img = np.transpose(img, (1, 2, 0))
    img = img.astype(np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    return np.clip(img, 0.0, 1.0)


def save_mask_overlay(path, img, mask, color=(255, 0, 0), alpha=0.5):
    """The frame image with a translucent coloured mask, as a PNG."""
    import cv2

    img8 = np.uint8(_np_img(img) * 255)
    overlay = img8.copy()
    overlay[np.asarray(mask).astype(bool)] = color
    out = np.uint8((1 - alpha) * img8 + alpha * overlay)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
