"""DPT feature-pyramid head.

Port of the JAX package's `models/dpt.py`. Inside the head the feature maps
are NCHW (PyTorch's convolution layout; weights OIHW, transposed-conv
weights (in, out, k, k)); the head returns NHWC like the reference. The x2
align-corners upsampling uses the reference's interpolation matrices, so
the same weights pair the same input pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from monst3r_slam_torch.models.config import ModelConfig


def _add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return y + b.to(y.dtype)[:, None, None]


def conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    b = p.get("b")
    if b is None or x.dtype == torch.float32:
        return F.conv2d(x, p["w"].to(x.dtype), None if b is None else b.to(x.dtype),
                        stride=stride, padding=padding)
    # In bf16 the reference rounds the convolution to bf16 before it adds the bias.
    return _add_bias(F.conv2d(x, p["w"].to(x.dtype), stride=stride, padding=padding), b)


def conv_transpose_exact(p, x: torch.Tensor, factor: int) -> torch.Tensor:
    """ConvTranspose2d with kernel == stride == factor (no overlap)."""
    if x.dtype == torch.float32:
        return F.conv_transpose2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=factor)
    return _add_bias(F.conv_transpose2d(x, p["w"].to(x.dtype), stride=factor), p["b"])


def _interp_matrix(n_out: int, n_in: int, dtype, device) -> torch.Tensor:
    """Row-stochastic align_corners=True bilinear interpolation matrix."""
    if n_in == 1:
        return torch.ones((n_out, 1), dtype=dtype, device=device)
    src = torch.arange(n_out, dtype=torch.float32, device=device) * (n_in - 1) / (n_out - 1)
    lo = torch.clamp(torch.floor(src).to(torch.int64), 0, n_in - 2)
    frac = src - lo.to(torch.float32)
    rows = torch.arange(n_out, device=device)
    m = torch.zeros((n_out, n_in), dtype=torch.float32, device=device)
    m[rows, lo] = 1.0 - frac
    m[rows, lo + 1] += frac
    return m.to(dtype)


def resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True via two matmuls."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    mh = _interp_matrix(out_h, h, x.dtype, x.device)
    mw = _interp_matrix(out_w, w, x.dtype, x.device)
    y = torch.einsum("Hh,bchw->bcHw", mh, x)
    return torch.einsum("Ww,bcHw->bcHW", mw, y)


def residual_conv_unit(p, x: torch.Tensor) -> torch.Tensor:
    out = conv2d(p["conv1"], F.relu(x), padding=1)
    out = conv2d(p["conv2"], F.relu(out), padding=1)
    return out + x


def fusion_block(p, x: torch.Tensor, skip) -> torch.Tensor:
    out = x
    if skip is not None:
        out = out + residual_conv_unit(p["res1"], skip)
    out = residual_conv_unit(p["res2"], out)
    h, w = out.shape[-2:]
    return conv2d(p["out_conv"], resize_bilinear_ac(out, 2 * h, 2 * w))


def dpt_forward(p, cfg: ModelConfig, hook_feats, n_h: int, n_w: int) -> torch.Tensor:
    """4 hook token tensors (B, N, dim) -> (B, H, W, 4) NHWC."""
    feats = []
    for idx, tokens in enumerate(hook_feats):
        b, n, d = tokens.shape
        x = tokens.reshape(b, n_h, n_w, d).permute(0, 3, 1, 2)
        act = p["act"][idx]
        x = conv2d(act["conv"], x)
        if idx == 0:
            x = conv_transpose_exact(act["up"], x, 4)
        elif idx == 1:
            x = conv_transpose_exact(act["up"], x, 2)
        elif idx == 3:
            x = conv2d(act["down"], x, stride=2, padding=1)
        feats.append(conv2d(p["layer_rn"][idx], x, padding=1))

    path4 = fusion_block(p["refine4"], feats[3], None)
    path4 = path4[:, :, : feats[2].shape[2], : feats[2].shape[3]]
    path3 = fusion_block(p["refine3"], path4, feats[2])
    path2 = fusion_block(p["refine2"], path3, feats[1])
    path1 = fusion_block(p["refine1"], path2, feats[0])

    h = conv2d(p["head"]["conv1"], path1, padding=1)
    hh, ww = h.shape[-2:]
    h = resize_bilinear_ac(h, 2 * hh, 2 * ww)
    h = F.relu(conv2d(p["head"]["conv2"], h, padding=1))
    return conv2d(p["head"]["conv3"], h).permute(0, 2, 3, 1)
