"""Parameter conversion into the port's layout.

`params_from_jax` takes the JAX package's parameter tree (as
the JAX package's `models/init.py::init_params` or its checkpoint converter
build it), with numpy leaves, and returns the port's tree:
  * linear (in, out)                 -> (out, in) for `F.linear`
  * conv HWIO (kh, kw, I, O)         -> OIHW
  * transposed conv (k, k, I, O)     -> (I, O, k, k) for `F.conv_transpose2d`
  * blocks stacked on a depth axis   -> a list of per-block dicts
`params_to_jax` is its inverse (numpy leaves in the JAX layout, blocks
stacked), for files either package reads. `cast_params_for_inference` is
the port of the reference's bf16 cast.

`load_checkpoint` reads a reference `.pth` checkpoint (MASt3R/MonST3R/DUSt3R
state-dict naming, `{'args': Namespace(model=arch), 'model': state_dict}`):
`params_from_state_dict` builds the JAX package's layout from it in numpy
(the port's copy of that converter: linear (out, in) -> (in, out), conv
OIHW -> HWIO, the patch-embed conv as a (p, p, c)-flattened linear, blocks
stacked on a depth axis), which `params_from_jax` then turns into the
port's tree, so both packages load one checkpoint to the same weights. The
architecture comes from the stored constructor string, parsed
(`config_from_arch_string`), never evaluated.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from monst3r_slam_torch.models.config import INF, ModelConfig

_BLOCK_KEYS = ("enc_blocks", "dec_blocks", "dec_blocks2")


def _leaf(path, x, device) -> torch.Tensor:
    x = np.array(x, dtype=np.float32)
    if path[-1] == "w":
        if x.ndim == 2:
            x = x.T
        elif x.ndim == 4:
            x = x.transpose(2, 3, 0, 1) if path[-2] == "up" else x.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _convert(tree, path, device):
    if isinstance(tree, dict):
        return {k: _convert(v, path + (k,), device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, path + (str(i),), device) for i, v in enumerate(tree)]
    return _leaf(path, tree, device)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(tree, device="cpu"):
    """JAX parameter tree (numpy leaves) -> the port's parameter tree."""
    out = {}
    for key, sub in tree.items():
        if key in _BLOCK_KEYS:
            depth = np.asarray(sub["norm1"]["w"]).shape[0]
            out[key] = [_convert(_unstack(sub, i), (key,), device) for i in range(depth)]
        else:
            out[key] = _convert(sub, (key,), device)
    return out


def _to_jax(tree, path):
    if isinstance(tree, dict):
        return {k: _to_jax(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_jax(v, path + (str(i),)) for i, v in enumerate(tree)]
    x = tree.detach().float().cpu().numpy()
    if path[-1] == "w":
        if x.ndim == 2:
            x = x.T
        elif x.ndim == 4:
            x = x.transpose(2, 3, 0, 1) if path[-2] == "up" else x.transpose(2, 3, 1, 0)
    return np.ascontiguousarray(x)


def params_to_jax(params):
    """The port's parameter tree -> the JAX package's layout, float32 numpy
    leaves: the inverse of `params_from_jax`."""
    out = {}
    for key, sub in params.items():
        if key in _BLOCK_KEYS:
            out[key] = _stack([_to_jax(blk, (key,)) for blk in sub])
        else:
            out[key] = _to_jax(sub, (key,))
    return out


def cast_params_for_inference(params, dtype=torch.bfloat16):
    """Cast matmul/conv weights to bf16 for inference; biases and the final
    encoder/decoder layernorms stay f32. Block layernorm weights are cast
    too, as in the reference, where they are stacked (2-D) and so pass its
    `ndim >= 2` test; they are applied in f32 either way."""

    def cast(tree, in_blocks):
        if isinstance(tree, dict):
            return {
                k: (v.to(dtype) if k == "w" and isinstance(v, torch.Tensor)
                    and (v.dim() >= 2 or in_blocks) else cast(v, in_blocks))
                for k, v in tree.items()
            }
        if isinstance(tree, list):
            return [cast(v, in_blocks) for v in tree]
        return tree

    return {k: cast(v, k in _BLOCK_KEYS) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Reference checkpoints: state dict -> the JAX package's layout (numpy)
# ---------------------------------------------------------------------------


def _t(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _linear(sd, name):
    p = {"w": _t(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _ln(sd, name):
    return {"w": _t(sd[f"{name}.weight"]), "b": _t(sd[f"{name}.bias"])}


def _conv(sd, name):
    p = {"w": _t(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)}  # OIHW -> HWIO
    if f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _conv_transpose(sd, name):
    return {"w": _t(sd[f"{name}.weight"]).transpose(2, 3, 0, 1), "b": _t(sd[f"{name}.bias"])}


def _patch_embed(sd, name):
    w = _t(sd[f"{name}.weight"])  # (D, 3, P, P); patches flatten as (p, p, c)
    d, c, p1, p2 = w.shape
    return {"proj": {"w": w.transpose(2, 3, 1, 0).reshape(p1 * p2 * c, d),
                     "b": _t(sd[f"{name}.bias"])}}


def _enc_block(sd, pfx):
    return {
        "norm1": _ln(sd, f"{pfx}.norm1"),
        "attn": {"qkv": _linear(sd, f"{pfx}.attn.qkv"), "proj": _linear(sd, f"{pfx}.attn.proj")},
        "norm2": _ln(sd, f"{pfx}.norm2"),
        "mlp": {"fc1": _linear(sd, f"{pfx}.mlp.fc1"), "fc2": _linear(sd, f"{pfx}.mlp.fc2")},
    }


def _dec_block(sd, pfx):
    return {
        "norm1": _ln(sd, f"{pfx}.norm1"),
        "attn": {"qkv": _linear(sd, f"{pfx}.attn.qkv"), "proj": _linear(sd, f"{pfx}.attn.proj")},
        "norm2": _ln(sd, f"{pfx}.norm2"),
        "norm3": _ln(sd, f"{pfx}.norm3"),
        "norm_y": _ln(sd, f"{pfx}.norm_y"),
        "cross": {
            "q": _linear(sd, f"{pfx}.cross_attn.projq"),
            "k": _linear(sd, f"{pfx}.cross_attn.projk"),
            "v": _linear(sd, f"{pfx}.cross_attn.projv"),
            "proj": _linear(sd, f"{pfx}.cross_attn.proj"),
        },
        "mlp": {"fc1": _linear(sd, f"{pfx}.mlp.fc1"), "fc2": _linear(sd, f"{pfx}.mlp.fc2")},
    }


def _stack(blocks):
    """Per-block trees -> one tree with the leaves stacked on a depth axis."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def _fusion(sd, pfx):
    return {
        "res1": {"conv1": _conv(sd, f"{pfx}.resConfUnit1.conv1"),
                 "conv2": _conv(sd, f"{pfx}.resConfUnit1.conv2")},
        "res2": {"conv1": _conv(sd, f"{pfx}.resConfUnit2.conv1"),
                 "conv2": _conv(sd, f"{pfx}.resConfUnit2.conv2")},
        "out_conv": _conv(sd, f"{pfx}.out_conv"),
    }


def _dpt(sd, pfx):
    acts = [
        {"conv": _conv(sd, f"{pfx}.act_postprocess.0.0"),
         "up": _conv_transpose(sd, f"{pfx}.act_postprocess.0.1")},
        {"conv": _conv(sd, f"{pfx}.act_postprocess.1.0"),
         "up": _conv_transpose(sd, f"{pfx}.act_postprocess.1.1")},
        {"conv": _conv(sd, f"{pfx}.act_postprocess.2.0")},
        {"conv": _conv(sd, f"{pfx}.act_postprocess.3.0"),
         "down": _conv(sd, f"{pfx}.act_postprocess.3.1")},
    ]
    return {
        "act": acts,
        "layer_rn": [_conv(sd, f"{pfx}.scratch.layer{i}_rn") for i in (1, 2, 3, 4)],
        **{f"refine{i}": _fusion(sd, f"{pfx}.scratch.refinenet{i}") for i in (1, 2, 3, 4)},
        "head": {"conv1": _conv(sd, f"{pfx}.head.0"), "conv2": _conv(sd, f"{pfx}.head.2"),
                 "conv3": _conv(sd, f"{pfx}.head.4")},
    }


def _head(sd, head_name, has_desc):
    head = {"dpt": _dpt(sd, f"{head_name}.dpt")}
    if has_desc:
        head["local_feat"] = {
            "fc1": _linear(sd, f"{head_name}.head_local_features.fc1"),
            "fc2": _linear(sd, f"{head_name}.head_local_features.fc2"),
        }
    return head


def config_from_arch_string(arch: str) -> ModelConfig:
    """The architecture kwargs the model needs, parsed out of the
    checkpoint's stored constructor string (dust3r/model.py:31-39)."""

    def _int(name, default):
        m = re.search(rf"{name}\s*=\s*(\d+)", arch)
        return int(m.group(1)) if m else default

    def _mode(name, default):
        m = re.search(rf"(?<![a-z_]){name}\s*=\s*\(\s*'(\w+)'\s*,\s*([^,]+),\s*([^)]+)\)", arch)
        if not m:
            return default

        def num(s):
            s = s.strip()
            if "inf" in s:
                return -INF if s.startswith("-") else INF
            return float(s)

        return (m.group(1), num(m.group(2)), num(m.group(3)))

    m = re.search(r"output_mode\s*=\s*'pts3d\+desc(\d+)'", arch)
    conf_mode = _mode("conf_mode", ("exp", 1.0, INF))
    return ModelConfig(
        patch_size=_int("patch_size", 16),
        enc_depth=_int("enc_depth", 24),
        enc_dim=_int("enc_embed_dim", 1024),
        enc_heads=_int("enc_num_heads", 16),
        dec_depth=_int("dec_depth", 12),
        dec_dim=_int("dec_embed_dim", 768),
        dec_heads=_int("dec_num_heads", 12),
        desc_dim=int(m.group(1)) if m else None,
        two_confs="two_confs=True" in arch.replace(" ", ""),
        depth_mode=_mode("depth_mode", ("exp", -INF, INF)),
        conf_mode=conf_mode,
        desc_conf_mode=_mode("desc_conf_mode", conf_mode),
    )


def params_from_state_dict(sd: Dict[str, np.ndarray], cfg: ModelConfig) -> dict:
    """A reference-format state dict -> the JAX package's parameter layout,
    numpy leaves. A checkpoint without a second decoder uses the first for
    both (dust3r/model.py:90-97)."""
    if not any(k.startswith("dec_blocks2") for k in sd):
        sd = dict(sd)
        for k in list(sd):
            if k.startswith("dec_blocks."):
                sd[k.replace("dec_blocks.", "dec_blocks2.", 1)] = sd[k]
    has_desc = cfg.desc_dim is not None
    return {
        "patch_embed": _patch_embed(sd, "patch_embed.proj"),
        "enc_blocks": _stack([_enc_block(sd, f"enc_blocks.{i}") for i in range(cfg.enc_depth)]),
        "enc_norm": _ln(sd, "enc_norm"),
        "decoder_embed": _linear(sd, "decoder_embed"),
        "dec_blocks": _stack([_dec_block(sd, f"dec_blocks.{i}") for i in range(cfg.dec_depth)]),
        "dec_blocks2": _stack([_dec_block(sd, f"dec_blocks2.{i}") for i in range(cfg.dec_depth)]),
        "dec_norm": _ln(sd, "dec_norm"),
        "head1": _head(sd, "downstream_head1", has_desc),
        "head2": _head(sd, "downstream_head2", has_desc),
    }


def load_checkpoint(path: str, cfg: Optional[ModelConfig] = None, device="cpu"):
    """A reference torch checkpoint -> (the port's params on `device`, cfg).
    The file is unpickled in full (its `args` is a Namespace): load only
    checkpoints from a trusted source."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    if cfg is None:
        cfg = config_from_arch_string(ckpt["args"].model if "args" in ckpt else "")
    return params_from_jax(params_from_state_dict(sd, cfg), device=device), cfg
