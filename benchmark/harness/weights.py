"""Model weights drawn from the seed, on the device, in a few large calls.

The tree has the program's layout (`monst3r_slam_torch/models/init.py`:
linear (out, in), conv OIHW, transposed conv (in, out, k, k), blocks as
lists) and the published scales (normal weights of variance 2 / (fan_in +
fan_out) for linears and 2 / fan_in for convolutions, zero biases, unit
layernorms, and the last head conv at the configuration's `head_out_std`). Every normal leaf is a slice of
one `torch.randn` call, so making the weights costs one kernel and one copy
per leaf, and the same seed gives the same weights on the same device.

`served=True` gives the inference types (`cast_params_for_inference`'s
rule: bf16 matmul and conv weights and block layernorm weights, f32 biases
and final layernorms); `served=False` gives f32 leaves, as training keeps
them. The reference (`benchmark/reference/model.py`) reads the same tree.
"""

from __future__ import annotations

import math

import torch

BLOCK_KEYS = ("enc_blocks", "dec_blocks", "dec_blocks2")


def _spec(cfg: dict) -> dict:
    """The tree with each leaf as ("normal", shape, std) | ("zeros", n) |
    ("ones", n)."""
    def linear(d_in, d_out):
        return {"w": ("normal", (d_out, d_in), math.sqrt(2.0 / (d_in + d_out))),
                "b": ("zeros", d_out)}

    def ln(d):
        return {"w": ("ones", d), "b": ("zeros", d)}

    def conv(kh, kw, ci, co, bias=True):
        p = {"w": ("normal", (co, ci, kh, kw), math.sqrt(2.0 / (kh * kw * ci)))}
        if bias:
            p["b"] = ("zeros", co)
        return p

    e, d, r = cfg["enc_dim"], cfg["dec_dim"], cfg["mlp_ratio"]

    def enc_block():
        return {"norm1": ln(e), "attn": {"qkv": linear(e, 3 * e), "proj": linear(e, e)},
                "norm2": ln(e), "mlp": {"fc1": linear(e, r * e), "fc2": linear(r * e, e)}}

    def dec_block():
        return {"norm1": ln(d), "attn": {"qkv": linear(d, 3 * d), "proj": linear(d, d)},
                "norm2": ln(d), "norm3": ln(d), "norm_y": ln(d),
                "cross": {"q": linear(d, d), "k": linear(d, d), "v": linear(d, d),
                          "proj": linear(d, d)},
                "mlp": {"fc1": linear(d, r * d), "fc2": linear(r * d, d)}}

    ld, fd = cfg["layer_dims"], cfg["feature_dim"]
    in_dims = (e, d, d, d)

    def fusion():
        return {"res1": {"conv1": conv(3, 3, fd, fd), "conv2": conv(3, 3, fd, fd)},
                "res2": {"conv1": conv(3, 3, fd, fd), "conv2": conv(3, 3, fd, fd)},
                "out_conv": conv(1, 1, fd, fd)}

    def head():
        dpt = {
            "act": [
                {"conv": conv(1, 1, in_dims[0], ld[0]),
                 "up": {"w": ("normal", (ld[0], ld[0], 4, 4), 0.02), "b": ("zeros", ld[0])}},
                {"conv": conv(1, 1, in_dims[1], ld[1]),
                 "up": {"w": ("normal", (ld[1], ld[1], 2, 2), 0.02), "b": ("zeros", ld[1])}},
                {"conv": conv(1, 1, in_dims[2], ld[2])},
                {"conv": conv(1, 1, in_dims[3], ld[3]), "down": conv(3, 3, ld[3], ld[3])},
            ],
            "layer_rn": [conv(3, 3, ld[i], fd, bias=False) for i in range(4)],
            "refine1": fusion(), "refine2": fusion(), "refine3": fusion(), "refine4": fusion(),
            "head": {"conv1": conv(3, 3, fd, fd // 2), "conv2": conv(3, 3, fd // 2, cfg["last_dim"]),
                     "conv3": {"w": ("normal", (4, cfg["last_dim"], 1, 1), cfg["head_out_std"]),
                               "b": ("zeros", 4)}},
        }
        out = {"dpt": dpt}
        if cfg["desc_dim"] is not None:
            idim = e + d
            hidden = int(cfg["desc_hidden_factor"] * idim)
            per_pix = (cfg["desc_dim"] + (1 if cfg["two_confs"] else 0)) * cfg["patch_size"] ** 2
            out["local_feat"] = {"fc1": linear(idim, hidden), "fc2": linear(hidden, per_pix)}
        return out

    return {
        "patch_embed": {"proj": linear(cfg["patch_size"] ** 2 * 3, e)},
        "enc_blocks": [enc_block() for _ in range(cfg["enc_depth"])],
        "enc_norm": ln(e),
        "decoder_embed": linear(e, d),
        "dec_blocks": [dec_block() for _ in range(cfg["dec_depth"])],
        "dec_blocks2": [dec_block() for _ in range(cfg["dec_depth"])],
        "dec_norm": ln(d),
        "head1": head(),
        "head2": head(),
    }


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def leaf_dtype(path, spec, served: bool) -> torch.dtype:
    if not served:
        return torch.float32
    is_w = path[-1] == "w"
    return torch.bfloat16 if is_w and (spec[0] == "normal" or path[0] in BLOCK_KEYS) \
        else torch.float32


def make_params(cfg: dict, seed: int, device, served: bool) -> dict:
    """The weight tree of configuration `cfg` from `seed` on `device`."""
    tree = _spec(cfg)
    leaves = list(_leaves(tree))
    normal = [(p, s) for p, s in leaves if s[0] == "normal"]
    total = sum(math.prod(s[1]) for _, s in normal)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device,
                       dtype=torch.bfloat16 if served else torch.float32)
    off = 0
    for path, spec in leaves:
        dtype = leaf_dtype(path, spec, served)
        if spec[0] == "normal":
            n = math.prod(spec[1])
            leaf = (draw[off:off + n].view(spec[1]) * spec[2]).to(dtype)
            off += n
        elif spec[0] == "zeros":
            leaf = torch.zeros(spec[1], device=device, dtype=dtype)
        else:
            leaf = torch.ones(spec[1], device=device, dtype=dtype)
        _set(tree, path, leaf)
    return tree


def named_leaves(tree) -> list:
    """[(path string, tensor)] in a fixed order."""
    return [("/".join(map(str, p)), t) for p, t in _leaves(tree)]
