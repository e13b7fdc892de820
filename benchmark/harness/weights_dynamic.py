"""RAFT's and SAM2's weights drawn from the seed, on the device, in one
`torch.randn` call each.

The trees have the program's layouts (`monst3r_slam_torch/dynamic/raft.py`:
convolutions OIHW with biases, instance-norm affines; `dynamic/sam2.py`:
linears (in, out), convolutions HWIO, the prompt encoder's Gaussian and
embeddings, the decoder's tokens and hypernetworks) and the scales of a
random start: He-normal weights (variance 2 / fan_in), zero biases, unit
norms, 0.02 for embeddings and tokens, a unit Gaussian for the prompt
encoder's Fourier features, and the configuration's `flow_out_std` for the
last convolution of RAFT's flow head. Every normal leaf is a slice of the one draw,
so the same seed gives the same weights on the same device. Everything is
float32, the type both models run in. The reference (`benchmark/reference/
raft.py`, `sam2.py`) reads the same trees.
"""

from __future__ import annotations

import math

import torch

RAFT_ENC = ((64, 64, 1), (64, 64, 1), (64, 96, 2), (96, 96, 1), (96, 128, 2), (128, 128, 1))
GRU_CONVS = ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")


def _normal(shape, std):
    return ("normal", tuple(shape), float(std))


def _zeros(n):
    return ("zeros", (n,))


def _ones(n):
    return ("ones", (n,))


def raft_spec(rc: dict) -> dict:
    """RAFT's tree for the configuration's `raft` block (feature, hidden and
    context widths, correlation levels and radius; `flow_out_std`, the
    spread of the flow head's last convolution)."""
    def conv(kh, kw, ci, co):
        return {"w": _normal((co, ci, kh, kw), math.sqrt(2.0 / (kh * kw * ci))), "b": _zeros(co)}

    def norm(c):
        return {"w": _ones(c), "b": _zeros(c)}

    def enc(out_dim):
        layers = []
        for ci, co, s in RAFT_ENC:
            blk = {"conv1": conv(3, 3, ci, co), "norm1": norm(co),
                   "conv2": conv(3, 3, co, co), "norm2": norm(co)}
            if s > 1 or ci != co:
                blk["downsample"] = conv(1, 1, ci, co)
                blk["norm3"] = norm(co)
            layers.append(blk)
        return {"conv1": conv(7, 7, 3, 64), "norm1": norm(64), "layers": layers,
                "conv2": conv(1, 1, 128, out_dim)}

    hd, cd = rc["hidden_dim"], rc["context_dim"]
    planes = rc["corr_levels"] * (2 * rc["corr_radius"] + 1) ** 2
    gru_in = hd + 128 + cd
    return {
        "fnet": enc(rc["feature_dim"]),
        "cnet": enc(hd + cd),
        "update": {
            "encoder": {"convc1": conv(1, 1, planes, 256), "convc2": conv(3, 3, 256, 192),
                        "convf1": conv(7, 7, 2, 128), "convf2": conv(3, 3, 128, 64),
                        "conv": conv(3, 3, 256, 128 - 2)},
            "gru": {k: conv(1, 5, gru_in, hd) if k.endswith("1") else conv(5, 1, gru_in, hd)
                    for k in GRU_CONVS},
            "flow_head": {"conv1": conv(3, 3, hd, 256),
                          "conv2": {"w": _normal((2, 256, 3, 3), rc["flow_out_std"]),
                                    "b": _zeros(2)}},
            "mask": {"conv1": conv(3, 3, hd, 256), "conv2": conv(1, 1, 256, 64 * 9)},
        },
    }


def sam2_stage_dims(sc: dict) -> list:
    """(dim_in, dim_out) of each Hiera block: the width doubles at the first
    block of each stage after the first."""
    dims, dim, first = [], sc["embed_dim"], set()
    n = 0
    for s in sc["stages"][:-1]:
        n += s
        first.add(n)
    for i in range(sum(sc["stages"])):
        out = dim * 2 if i in first else dim
        dims.append((dim, out))
        dim = out
    return dims


def sam2_spec(sc: dict) -> dict:
    """SAM2's image-model tree for the configuration's `sam2` block."""
    def lin(ci, co):
        return {"w": _normal((ci, co), math.sqrt(2.0 / ci)), "b": _zeros(co)}

    def ln(c):
        return {"w": _ones(c), "b": _zeros(c)}

    def cv(kh, kw, ci, co):
        return {"w": _normal((kh, kw, ci, co), math.sqrt(2.0 / (kh * kw * ci))), "b": _zeros(co)}

    def attn(c, internal=None):
        i = internal or c
        return {"q": lin(c, i), "k": lin(c, i), "v": lin(c, i), "out": lin(i, c)}

    C, d, M = sc["embed_dim"], sc["d_model"], sc["num_mask_tokens"]
    blocks = []
    for ci, co in sam2_stage_dims(sc):
        blk = {"norm1": ln(ci), "attn": {"qkv": lin(ci, 3 * co), "proj": lin(co, co)},
               "norm2": ln(co), "mlp": {"fc1": lin(co, 4 * co), "fc2": lin(4 * co, co)}}
        if co != ci:
            blk["proj"] = lin(ci, co)
        blocks.append(blk)
    bh, bw = sc["window_pos_embed_bkg_spatial_size"]
    ws0 = sc["window_spec"][0]
    trunk = {"patch_embed": cv(7, 7, 3, C), "pos_embed": _normal((1, bh, bw, C), 0.02),
             "pos_embed_window": _normal((1, ws0, ws0, C), 0.02), "blocks": blocks}
    neck = {"convs": [cv(1, 1, C * 2 ** i, d) for i in range(len(sc["stages"]))]}
    prompt = {"pe_gaussian": _normal((2, d // 2), 1.0),
              **{k: _normal((d,), 0.02) for k in ("point_neg", "point_pos", "not_a_point",
                                                   "no_mask_embed")}}

    def layer():
        return {"self_attn": attn(d), "norm1": ln(d), "cross_t2i": attn(d, d // 2),
                "norm2": ln(d), "mlp": {"fc1": lin(d, sc["dec_mlp_dim"]),
                                        "fc2": lin(sc["dec_mlp_dim"], d)},
                "norm3": ln(d), "cross_i2t": attn(d, d // 2), "norm4": ln(d)}

    dec = {"iou_token": _normal((1, d), 0.02), "mask_tokens": _normal((M, d), 0.02),
           "obj_token": _normal((1, d), 0.02),
           "layers": [layer() for _ in range(sc["dec_depth"])],
           "final_t2i": attn(d, d // 2), "norm_final": ln(d),
           "up1": cv(2, 2, d, d // 4), "up_norm": ln(d // 4), "up2": cv(2, 2, d // 4, d // 8),
           "skip0": cv(1, 1, d, d // 8), "skip1": cv(1, 1, d, d // 4),
           "hyper": [[lin(d, d), lin(d, d), lin(d, d // 8)] for _ in range(M)],
           "iou_head": [lin(d, d), lin(d, d), lin(d, M)]}
    return {"trunk": trunk, "neck": neck, "prompt": prompt, "dec": dec,
            "no_mem_embed": _normal((1, 1, 1, d), 0.02)}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def draw(spec: dict, seed: int, device) -> dict:
    """The tree of `spec` with its leaves drawn from `seed` on `device`, f32."""
    leaves = list(_leaves(spec))
    total = sum(math.prod(s[1]) for _, s in leaves if s[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device)
    off = 0
    for path, (kind, shape, *std) in leaves:
        if kind == "normal":
            n = math.prod(shape)
            leaf = z[off:off + n].view(shape) * std[0]
            off += n
        else:
            leaf = (torch.zeros if kind == "zeros" else torch.ones)(shape, device=device)
        node = spec
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = leaf
    return spec


def raft_params(rc: dict, seed: int, device) -> dict:
    return draw(raft_spec(rc), seed, device)


def sam2_params(sc: dict, seed: int, device) -> dict:
    return draw(sam2_spec(sc), seed, device)
