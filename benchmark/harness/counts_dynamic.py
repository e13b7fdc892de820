"""Operations of RAFT and of SAM2's image path, counted from shapes.

Each matrix product and convolution counts 2 operations a multiply-add,
layer by layer, as `counts.py` counts the two-view model; elementwise work
(norms, activations, softmax, the correlation lookup's taps, the pooling,
the upsampling's combination) is left out.

RAFT: both images through the feature encoder and the first through the
context encoder (a 7x7 stride-2 stem and six residual blocks down to 1/8,
then a 1x1 projection), the all-pairs correlation at 1/8, each iteration's
motion encoder, separable ConvGRU and flow head, and the upsampling mask's
two convolutions once. SAM2: the Hiera trunk (the 7x7 stride-4 patch
embedding; each block's qkv, projection, MLP and the products of its
windowed or global attention, with the pooled queries of a stage's first
block), the neck's 1x1 convolutions, the decoder's two skip projections,
and the mask decoder for the refiner's fixed batch of prompt rows (the
two-way layers over the 6 output tokens and the prompts, the final
attention, the two transposed convolutions, the hypernetworks, the IoU
head and the mask product).
"""

from __future__ import annotations


def _conv(pix: float, ci: int, co: int, kh: int, kw: int) -> float:
    return 2.0 * pix * ci * co * kh * kw


def raft_flops(rc: dict, h: int, w: int) -> float:
    """One RAFT call on an (h, w) pair at `rc["iters"]` iterations."""
    enc_blocks = ((64, 64, 1), (64, 64, 1), (64, 96, 2), (96, 96, 1), (96, 128, 2), (128, 128, 1))

    def encoder(out_dim: int) -> float:
        hh, ww = h / 2, w / 2
        f = _conv(hh * ww, 3, 64, 7, 7)
        for ci, co, s in enc_blocks:
            hh, ww = hh / s, ww / s
            f += _conv(hh * ww, ci, co, 3, 3) + _conv(hh * ww, co, co, 3, 3)
            if s > 1 or ci != co:
                f += _conv(hh * ww, ci, co, 1, 1)
        return f + _conv(hh * ww, 128, out_dim, 1, 1)

    hd, cd = rc["hidden_dim"], rc["context_dim"]
    p = (h / 8) * (w / 8)
    planes = rc["corr_levels"] * (2 * rc["corr_radius"] + 1) ** 2
    gru_in = hd + 128 + cd
    per_iter = (_conv(p, planes, 256, 1, 1) + _conv(p, 256, 192, 3, 3)
                + _conv(p, 2, 128, 7, 7) + _conv(p, 128, 64, 3, 3) + _conv(p, 256, 126, 3, 3)
                + 6 * _conv(p, gru_in, hd, 1, 5)
                + _conv(p, hd, 256, 3, 3) + _conv(p, 256, 2, 3, 3))
    return (2 * encoder(rc["feature_dim"]) + encoder(hd + cd)
            + 2.0 * p * p * rc["feature_dim"]  # the all-pairs correlation
            + rc["iters"] * per_iter
            + _conv(p, hd, 256, 3, 3) + _conv(p, 256, 64 * 9, 1, 1))


def _attn(nq: float, nk: float, c: int) -> float:
    """QK^T and PV of `nq` queries over `nk` keys at total width `c`."""
    return 4.0 * nq * nk * c


def sam2_encode_flops(sc: dict) -> float:
    """SAM2's image encoder at its input size: Hiera, the neck, the skips."""
    s = sc["img_size"]
    hw = (s / 4) ** 2
    f = _conv(hw, 3, sc["embed_dim"], 7, 7)
    dim, blk = sc["embed_dim"], 0
    widths = []
    for stage, n in enumerate(sc["stages"]):
        for j in range(n):
            pooled = stage > 0 and j == 0
            co = dim * 2 if pooled else dim
            hq = hw / 4 if pooled else hw
            ws = sc["window_spec"][stage - 1 if pooled else stage]
            f += 2.0 * hw * dim * 3 * co  # qkv on every token
            if pooled:
                f += 2.0 * hw * dim * co  # the shortcut's projection
            if blk in sc["global_att_blocks"]:
                f += _attn(hq, hw, co)
            else:  # each query against its window's ws x ws keys
                f += _attn(hq, ws * ws, co)
            f += 2.0 * hq * co * co + 2 * 2.0 * hq * co * 4 * co  # projection, MLP
            hw, dim, blk = hq, co, blk + 1
        widths.append((hw, dim))
    d = sc["d_model"]
    f += sum(_conv(p, c, d, 1, 1) for p, c in widths)
    f += _conv(widths[0][0], d, d // 8, 1, 1) + _conv(widths[1][0], d, d // 4, 1, 1)
    return f


def sam2_decode_flops(sc: dict, rows: int) -> float:
    """The mask decoder on `rows` prompt rows of one point each."""
    d, m = sc["d_model"], sc["num_mask_tokens"]
    hw = (sc["img_size"] / 16) ** 2
    t = 2 + m + 2  # object and IoU tokens, the mask tokens, the point and SAM's padding point
    half = d // 2

    def cross(nq, nk):  # q from nq, k and v from nk, the output back to d
        return (2.0 * nq * d * half + 2 * 2.0 * nk * d * half + _attn(nq, nk, half)
                + 2.0 * nq * half * d)

    layer = (4 * 2.0 * t * d * d + _attn(t, t, d)  # token self-attention
             + cross(t, hw) + 2 * 2.0 * t * d * sc["dec_mlp_dim"] + cross(hw, t))
    f = sc["dec_depth"] * layer + cross(t, hw)
    f += 2.0 * hw * d * (d // 4) * 4 + 2.0 * (4 * hw) * (d // 4) * (d // 8) * 4  # upscaling
    f += m * (2 * 2.0 * d * d + 2.0 * d * (d // 8)) + 2 * 2.0 * d * d + 2.0 * d * m
    f += 2.0 * m * (16 * hw) * (d // 8)  # the masks
    return rows * f


def sam2_flops(sc: dict) -> float:
    """One refiner call: one encode and the decode of its fixed prompt batch."""
    return sam2_encode_flops(sc) + sam2_decode_flops(sc, sc["max_objects"])
