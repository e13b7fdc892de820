"""Top-level two-view pointmap model API (MASt3R).

Port of the JAX package's `models/mast3r.py`: `encode` (the per-frame
encoder cache), `decode` (dual decoder + both heads for an ordered pair,
the heads one after the other or, with `fused_heads`, as one pass over the
stacked head parameters), `inference_mono` and `inference_sym` (both
orders of a pair in one batch). Images are NHWC float32 normalized as
(x - 0.5) / 0.5.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from monst3r_slam_torch.models import croco, heads
from monst3r_slam_torch.models.config import ModelConfig
from monst3r_slam_torch.utils import timing


class PairOutput(NamedTuple):
    """Per-pixel outputs for both views of a decoded pair; view-2 points are
    in view-1's frame. X (B, H, W, 3), C (B, H, W), D (B, H, W, desc_dim),
    Q (B, H, W)."""

    X1: torch.Tensor
    C1: torch.Tensor
    D1: Optional[torch.Tensor]
    Q1: Optional[torch.Tensor]
    X2: torch.Tensor
    C2: torch.Tensor
    D2: Optional[torch.Tensor]
    Q2: Optional[torch.Tensor]


@torch.no_grad()
def encode(params, cfg: ModelConfig, img: torch.Tensor, dtype=torch.bfloat16):
    """img (B, H, W, 3) -> (feat (B, N, enc_dim) float32, pos (B, N, 2));
    the recorder's `model.encodes` counts the images (utils/timing)."""
    timing.count("model.encodes", img.shape[0])
    return croco.encode_image(params, cfg, img, dtype)


def _fused_heads(params, cfg: ModelConfig, dec1, dec2, n_h: int, n_w: int):
    """Both heads as one pass: `torch.func.vmap` over the stacked head
    parameters and hook activations, which batches each convolution of the
    two heads into one grouped convolution (and each matmul into one batched
    matmul). Every operation is the unfused heads' own, so a bf16 pass
    rounds where they do."""
    stacked = torch.utils._pytree.tree_map(lambda a, b: torch.stack([a, b]),
                                           params["head1"], params["head2"])
    dec = tuple(torch.stack([a, b]) for a, b in zip(dec1, dec2))
    outs = torch.func.vmap(lambda hp, df: heads.head_forward(hp, cfg, df, n_h, n_w))(
        stacked, dec)
    out1 = heads.HeadOutput(*[None if t is None else t[0] for t in outs])
    out2 = heads.HeadOutput(*[None if t is None else t[1] for t in outs])
    return out1, out2


@torch.no_grad()
def decode(params, cfg: ModelConfig, feat1, pos1, feat2, pos2, shape,
           dtype=torch.bfloat16, fused_heads: bool = False) -> PairOutput:
    """Decoder + both heads for the ordered pair (1, 2); `shape` is (H, W).
    The recorder's `model.decode_rows` counts the pairs (utils/timing)."""
    timing.count("model.decode_rows", feat1.shape[0])
    h, w = shape
    n_h, n_w = h // cfg.patch_size, w // cfg.patch_size
    dec1, dec2 = croco.decode_pair(params, cfg, feat1, pos1, feat2, pos2, dtype)
    if fused_heads:
        out1, out2 = _fused_heads(params, cfg, dec1, dec2, n_h, n_w)
    else:
        out1 = heads.head_forward(params["head1"], cfg, dec1, n_h, n_w)
        out2 = heads.head_forward(params["head2"], cfg, dec2, n_h, n_w)
    return PairOutput(
        out1.pts3d, out1.conf, out1.desc, out1.desc_conf,
        out2.pts3d, out2.conf, out2.desc, out2.desc_conf,
    )


def inference_mono(params, cfg: ModelConfig, feat, pos, shape, dtype=torch.bfloat16) -> PairOutput:
    """Self-pair decode (feat, feat)."""
    return decode(params, cfg, feat, pos, feat, pos, shape, dtype)


def inference_sym(params, cfg: ModelConfig, feat_i, pos_i, feat_j, pos_j, shape,
                  dtype=torch.bfloat16):
    """Both orders of the pair (i, j) in one decode of batch 2b. Returns
    (out_ij, out_ji): out_ij holds (Xii, Cii, Dii, Qii, Xji, ...) of the
    order (i, j), out_ji those of (j, i)."""
    out = decode(params, cfg, torch.cat([feat_i, feat_j]), torch.cat([pos_i, pos_j]),
                 torch.cat([feat_j, feat_i]), torch.cat([pos_j, pos_i]), shape, dtype)
    b = feat_i.shape[0]

    def split(t):
        return (t[:b], t[b:]) if t is not None else (None, None)

    (X11, X22), (C11, C22), (D11, D22), (Q11, Q22) = map(split, (out.X1, out.C1, out.D1, out.Q1))
    (X21, X12), (C21, C12), (D21, D12), (Q21, Q12) = map(split, (out.X2, out.C2, out.D2, out.Q2))
    return (PairOutput(X11, C11, D11, Q11, X21, C21, D21, Q21),
            PairOutput(X22, C22, D22, Q22, X12, C12, D12, Q12))
