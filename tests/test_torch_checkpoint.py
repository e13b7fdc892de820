"""Checkpoint loading in the port (`models/convert.py::load_checkpoint`)
against the JAX package's on one synthetic TINY-width checkpoint in the
reference's on-disk layout: torch.save of {'args': Namespace(model=<ctor
string>), 'model': state_dict}, as tests/test_model_parity.py writes it.
The state dict is the JAX TINY init written back into the reference's
names and layouts by the port's `save_checkpoint`, so no reference model
is needed.
The port's loaded tree must equal `params_from_jax` of the JAX loader's,
exactly."""

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
    from with numpy leaves), through the port's `state_dict_from_params`."""
    tree = tiny_tree(seed)
    sd = tconvert.state_dict_from_params(tree, tconvert.config_from_arch_string(TINY_ARCH))
    return {k: torch.from_numpy(v) for k, v in sd.items()}, tree


def write_tiny_checkpoint(path, seed: int = 0):
    """A TINY-width checkpoint in the reference's on-disk layout at `path`,
    written by the port's `save_checkpoint`; returns the JAX tree it holds."""
    tree = tiny_tree(seed)
    tconvert.save_checkpoint(str(path), tconvert.params_from_jax(tree),
                             tconvert.config_from_arch_string(TINY_ARCH))
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


def test_save_checkpoint_round_trips_through_both_loaders(tmp_path):
    """`save_checkpoint` writes the port's params in the reference layout:
    the port's loader reads back the same tree and config, and so does the
    JAX package's loader (scripts/make_tiny_checkpoint_torch.py writes the
    run_real_torch.sh checkpoint so)."""
    params = tconvert.params_from_jax(tiny_tree(3))
    path = str(tmp_path / "saved.pth")
    tconvert.save_checkpoint(path, params, tconvert.config_from_arch_string(TINY_ARCH))
    tparams, tcfg = tconvert.load_checkpoint(path)
    assert tcfg == tconvert.config_from_arch_string(TINY_ARCH)
    _assert_trees_equal(tparams, params)
    jparams, jcfg = jconvert.load_checkpoint(path)
    assert (jcfg.enc_depth, jcfg.dec_dim, jcfg.desc_dim) == (tcfg.enc_depth, tcfg.dec_dim,
                                                             tcfg.desc_dim)
    _assert_trees_equal(tconvert.params_from_jax(jax.tree.map(np.asarray, jparams)), params)
