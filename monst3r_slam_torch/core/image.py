"""Image gradients for the iterative-projection matcher.

Port of the JAX package's `core/image.py`: the 3x3 Scharr-like kernels
(1/32 * [±3, ±10]) as a depthwise convolution over NHWC input after reflect
padding. `F.pad(mode="reflect")` leaves out the edge sample as
`jnp.pad(mode="reflect")` does, and `F.conv2d` is a cross-correlation as
XLA's convolution is, so the kernels are not flipped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_GX = [[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]]
_GY = [[-3.0, -10.0, -3.0], [0.0, 0.0, 0.0], [3.0, 10.0, 3.0]]


def img_gradient(img: torch.Tensor):
    """img (b, h, w, c) -> (gx, gy), each (b, h, w, c), depthwise filtered."""
    c = img.shape[-1]
    x = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")

    def conv(kernel):
        k = (1.0 / 32.0) * torch.tensor(kernel, dtype=torch.float32)
        k = k.to(device=img.device, dtype=img.dtype).expand(c, 1, 3, 3)
        return F.conv2d(x, k, groups=c).permute(0, 2, 3, 1)

    return conv(_GX), conv(_GY)
