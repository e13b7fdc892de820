"""Operations and bytes of the model and of the kernels, counted from shapes.

Model FLOPs count every matrix multiplication and convolution of the
published architecture, layer by layer (2 operations a multiply-add):
the patch embedding, each block's projections and MLP, both attentions'
QK^T and PV, the decoder embedding, the DPT head's projections, transposed
convolutions, 3x3 convolutions and 1x1 output convolutions, and the
catMLP descriptor head. Elementwise work (layernorms, GELU, softmax,
RoPE, the bilinear x2 resizes, the output activations) is left out. A
training step counts 3x its forward (the forward and the two products of
the backward). The peaks are NVIDIA's for one H100 SXM, dense.
"""

from __future__ import annotations

PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_F32 = 67e12  # FLOP/s, FP32 pipe
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


def tokens(cfg: dict, h: int, w: int) -> int:
    return (h // cfg["patch_size"]) * (w // cfg["patch_size"])


def encoder_flops(cfg: dict, h: int, w: int) -> float:
    """One image."""
    n, e, r = tokens(cfg, h, w), cfg["enc_dim"], cfg["mlp_ratio"]
    f = 2.0 * n * (cfg["patch_size"] ** 2 * 3) * e
    per_block = 2.0 * n * e * 3 * e + 4.0 * n * n * e + 2.0 * n * e * e + 2 * 2.0 * n * e * r * e
    return f + cfg["enc_depth"] * per_block


def decoder_flops(cfg: dict, h: int, w: int) -> float:
    """Both streams of one pair."""
    n, e, d, r = tokens(cfg, h, w), cfg["enc_dim"], cfg["dec_dim"], cfg["mlp_ratio"]
    per_block = (2.0 * n * d * 3 * d + 4.0 * n * n * d + 2.0 * n * d * d  # self-attention
                 + 4 * 2.0 * n * d * d + 4.0 * n * n * d  # cross: q, k, v, proj; QK^T, PV
                 + 2 * 2.0 * n * d * r * d)  # MLP
    return 2 * (2.0 * n * e * d + cfg["dec_depth"] * per_block)


def head_flops(cfg: dict, h: int, w: int) -> float:
    """One view's DPT head and, where the model has one, its descriptor
    head, on the (n_h, n_w) patch grid."""
    n_h, n_w = h // cfg["patch_size"], w // cfg["patch_size"]
    p = n_h * n_w
    e, d, fd = cfg["enc_dim"], cfg["dec_dim"], cfg["feature_dim"]
    ld = cfg["layer_dims"]
    h4, w4 = (n_h + 1) // 2, (n_w + 1) // 2  # the last hook after its 3x3 stride-2 conv

    def conv(pix, ci, co, k=1):
        return 2.0 * pix * ci * co * k * k

    f = conv(p, e, ld[0]) + 2.0 * p * ld[0] * ld[0] * 16  # 1x1, then transposed 4x4 stride 4
    f += conv(p, d, ld[1]) + 2.0 * p * ld[1] * ld[1] * 4  # 1x1, transposed 2x2 stride 2
    f += conv(p, d, ld[2])
    f += conv(p, d, ld[3]) + conv(h4 * w4, ld[3], ld[3], 3)
    res = (16 * p, 4 * p, p, h4 * w4)  # each hook's pixels after its resampling
    f += sum(conv(res[i], ld[i], fd, 3) for i in range(4))  # layer_rn
    # refinenets: refine4 on the last hook (one residual unit of two 3x3
    # convs), the others at 1, 4 and 16 P (two units); each ends in a 1x1
    # conv at twice its resolution
    for pix, units in ((h4 * w4, 1), (p, 2), (4 * p, 2), (16 * p, 2)):
        f += units * 2 * conv(pix, fd, fd, 3) + conv(4 * pix, fd, fd)
    f += conv(64 * p, fd, fd // 2, 3) + conv(256 * p, fd // 2, cfg["last_dim"], 3)
    f += conv(256 * p, cfg["last_dim"], 4)
    if cfg["desc_dim"] is not None:
        idim = e + d
        hidden = int(cfg["desc_hidden_factor"] * idim)
        per_pix = (cfg["desc_dim"] + (1 if cfg["two_confs"] else 0)) * cfg["patch_size"] ** 2
        f += 2.0 * p * idim * hidden + 2.0 * p * hidden * per_pix
    return f


def decode_flops(cfg: dict, h: int, w: int) -> float:
    """The decoder and both heads for one ordered pair."""
    return decoder_flops(cfg, h, w) + 2 * head_flops(cfg, h, w)


def pair_forward_flops(cfg: dict, h: int, w: int) -> float:
    """Both encodes, the decoder and both heads."""
    return 2 * encoder_flops(cfg, h, w) + decode_flops(cfg, h, w)


def train_step_flops(cfg: dict, batch: int, h: int, w: int) -> float:
    return 3.0 * batch * pair_forward_flops(cfg, h, w)


def attention_calls(cfg: dict, batch: int, h: int, w: int, pairs: bool = True) -> list:
    """(B, heads, N, hd) of each attention of a pair's forward: the
    encoder's self-attentions of both images, then each decoder stream's
    self- and cross-attentions."""
    n = tokens(cfg, h, w)
    enc = (batch, cfg["enc_heads"], n, cfg["enc_dim"] // cfg["enc_heads"])
    dec = (batch, cfg["dec_heads"], n, cfg["dec_dim"] // cfg["dec_heads"])
    return [enc] * (2 * cfg["enc_depth"]) + [dec] * (4 * cfg["dec_depth"])


def attention_bound_s(shape, elem_bytes: int = 2, peak: float = PEAK_BF16) -> float:
    """Least time of one attention forward: QK^T and PV at the peak, or
    Q, K, V read and O written once, whichever is longer."""
    b, hh, n, d = shape
    flops = 4.0 * b * hh * n * n * d
    return max(flops / peak, 4.0 * b * hh * n * d * elem_bytes / PEAK_BYTES)


def tile_match_bound_s(T: int, tsz: int, crop: int, fd: int, h: int, w: int,
                       window_positions: int) -> float:
    """Least time of one kernel B call, as the port's kernel table counts
    it: the ray dot over each query's crop (3 multiplies and 2 adds a
    target, f32) plus the descriptor dot over the positions of each
    query's window (bf16 on the tensor cores), against reading the images,
    the queries and the corners once and writing (u, v, converged)."""
    ops_s = 5.0 * T * tsz * crop * crop / PEAK_F32 + 2.0 * fd * window_positions / PEAK_BF16
    n_bytes = (h * w * 3 * 4 + h * w * fd * 2 + T * 2 * 4  # rays, descriptors, corners
               + T * tsz * 3 * 4 + T * tsz * fd * 2  # query rays and descriptors
               + 3 * T * tsz * 4)  # u, v, converged
    return max(ops_s, n_bytes / PEAK_BYTES)
