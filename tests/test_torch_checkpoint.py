"""Checkpoint loading in the port (`models/convert.py::load_checkpoint`)
against the JAX package's on one synthetic TINY-width checkpoint in the
reference's on-disk layout: torch.save of {'args': Namespace(model=<ctor
string>), 'model': state_dict}, as tests/test_model_parity.py writes it.
The state dict is the JAX TINY init written back into the reference's
names and layouts (`tiny_state_dict`), so no reference model is needed.
The port's loaded tree must equal `params_from_jax` of the JAX loader's,
exactly."""

import argparse

import jax
import numpy as np
import torch

from monst3r_slam_tpu.models import convert as jconvert
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.models.init import init_params as jinit_params
from monst3r_slam_torch.models import convert as tconvert

TINY_ARCH = (
    "AsymmetricMASt3R(pos_embed='RoPE100', patch_embed_cls='ManyAR_PatchEmbed', "
    "img_size=(512, 512), head_type='catmlp+dpt', output_mode='pts3d+desc24', "
    "depth_mode=('exp', -inf, inf), conf_mode=('exp', 1, inf), "
    f"enc_embed_dim={JTINY.enc_dim}, enc_depth={JTINY.enc_depth}, "
    f"enc_num_heads={JTINY.enc_heads}, dec_embed_dim={JTINY.dec_dim}, "
    f"dec_depth={JTINY.dec_depth}, dec_num_heads={JTINY.dec_heads}, "
    "two_confs=True, desc_conf_mode=('exp', 0, inf))"
)


def _lin(sd, name, p):
    sd[f"{name}.weight"] = p["w"].T
    if "b" in p:
        sd[f"{name}.bias"] = p["b"]


def _conv(sd, name, p, transpose=False):
    # HWIO -> OIHW; a transposed conv's (k, k, I, O) -> (I, O, k, k)
    sd[f"{name}.weight"] = p["w"].transpose(2, 3, 0, 1) if transpose else p["w"].transpose(3, 2, 0, 1)
    if "b" in p:
        sd[f"{name}.bias"] = p["b"]


def tiny_tree(seed: int = 0):
    """The JAX package's TINY parameter layout with numpy weights from
    `seed`: normal / sqrt(fan-in) weights, zero biases, unit layernorms
    (the shapes from `jax.eval_shape` of its init, which runs nothing)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), JTINY))

    def fill(path, s):
        names = [str(getattr(k, "key", "")) for k in path]
        if names[-1] == "b":
            return np.zeros(s.shape, np.float32)
        if any(n.startswith("norm") or n.endswith("_norm") for n in names):
            return np.ones(s.shape, np.float32)
        fan_in = int(np.prod(s.shape[-4:-1] if len(s.shape) >= 4 else s.shape[-2:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_state_dict(seed: int = 0):
    """(reference-layout state dict of torch tensors, the JAX tree it came
    from with numpy leaves)."""
    tree = tiny_tree(seed)
    sd = {}
    w = tree["patch_embed"]["proj"]["w"]
    P, d = JTINY.patch_size, w.shape[1]
    sd["patch_embed.proj.weight"] = w.reshape(P, P, 3, d).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = tree["patch_embed"]["proj"]["b"]
    for key, dec in (("enc_blocks", False), ("dec_blocks", True), ("dec_blocks2", True)):
        blocks = tree[key]
        for i in range(blocks["norm1"]["w"].shape[0]):
            blk = jax.tree.map(lambda a, i=i: a[i], blocks)
            pfx = f"{key}.{i}"
            norms = ("norm1", "norm2", "norm3", "norm_y") if dec else ("norm1", "norm2")
            for n in norms:
                sd[f"{pfx}.{n}.weight"], sd[f"{pfx}.{n}.bias"] = blk[n]["w"], blk[n]["b"]
            _lin(sd, f"{pfx}.attn.qkv", blk["attn"]["qkv"])
            _lin(sd, f"{pfx}.attn.proj", blk["attn"]["proj"])
            _lin(sd, f"{pfx}.mlp.fc1", blk["mlp"]["fc1"])
            _lin(sd, f"{pfx}.mlp.fc2", blk["mlp"]["fc2"])
            if dec:
                for ref, ours in (("projq", "q"), ("projk", "k"), ("projv", "v"), ("proj", "proj")):
                    _lin(sd, f"{pfx}.cross_attn.{ref}", blk["cross"][ours])
    for n in ("enc_norm", "dec_norm"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = tree[n]["w"], tree[n]["b"]
    _lin(sd, "decoder_embed", tree["decoder_embed"])
    for h in (1, 2):
        dpt, pfx = tree[f"head{h}"]["dpt"], f"downstream_head{h}.dpt"
        for i, act in enumerate(dpt["act"]):
            _conv(sd, f"{pfx}.act_postprocess.{i}.0", act["conv"])
            if "up" in act:
                _conv(sd, f"{pfx}.act_postprocess.{i}.1", act["up"], transpose=True)
            if "down" in act:
                _conv(sd, f"{pfx}.act_postprocess.{i}.1", act["down"])
        for i, c in enumerate(dpt["layer_rn"]):
            _conv(sd, f"{pfx}.scratch.layer{i + 1}_rn", c)
        for r in (1, 2, 3, 4):
            ref = dpt[f"refine{r}"]
            for u in (1, 2):
                for c in (1, 2):
                    _conv(sd, f"{pfx}.scratch.refinenet{r}.resConfUnit{u}.conv{c}",
                          ref[f"res{u}"][f"conv{c}"])
            _conv(sd, f"{pfx}.scratch.refinenet{r}.out_conv", ref["out_conv"])
        for i, c in ((0, "conv1"), (2, "conv2"), (4, "conv3")):
            _conv(sd, f"{pfx}.head.{i}", dpt["head"][c])
        lf = tree[f"head{h}"]["local_feat"]
        _lin(sd, f"downstream_head{h}.head_local_features.fc1", lf["fc1"])
        _lin(sd, f"downstream_head{h}.head_local_features.fc2", lf["fc2"])
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    return sd, tree


def write_tiny_checkpoint(path, seed: int = 0):
    """A TINY-width checkpoint in the reference's on-disk layout at `path`."""
    sd, tree = tiny_state_dict(seed)
    torch.save({"args": argparse.Namespace(model=TINY_ARCH), "model": sd}, path)
    return tree


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


def test_load_checkpoint_matches_jax(tmp_path):
    path = tmp_path / "tiny_mast3r.pth"
    tree = write_tiny_checkpoint(path)
    jparams, jcfg = jconvert.load_checkpoint(str(path))
    tparams, tcfg = tconvert.load_checkpoint(str(path))
    assert tcfg == tconvert.config_from_arch_string(TINY_ARCH)
    for f in ("enc_depth", "enc_dim", "enc_heads", "dec_depth", "dec_dim", "dec_heads",
              "desc_dim", "two_confs", "depth_mode", "conf_mode", "desc_conf_mode"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    _assert_trees_equal(tparams, tconvert.params_from_jax(jax.tree.map(np.asarray, jparams)))
    # and the state dict written above round-trips to the tree it came from
    _assert_trees_equal(tparams, tconvert.params_from_jax(tree))


def test_config_from_arch_string_matches_jax():
    for arch in (TINY_ARCH,
                 "AsymmetricCroCo3DStereo(pos_embed='RoPE100', head_type='dpt', "
                 "output_mode='pts3d', depth_mode=('exp', -inf, inf), "
                 "conf_mode=('exp', 1, inf), enc_embed_dim=1024, enc_depth=24, "
                 "dec_embed_dim=768, dec_depth=12, dec_num_heads=12)"):
        j, t = jconvert.config_from_arch_string(arch), tconvert.config_from_arch_string(arch)
        assert {k: v for k, v in vars(t).items()} == {k: v for k, v in vars(j).items()}
