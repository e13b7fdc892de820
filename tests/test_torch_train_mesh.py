"""Training's dp x tp mesh in the port (`parallel/mesh.py`'s `shard_params`,
`gather_params`, `row_params`, `batch_sharding`; the tensor-parallel
forward of `models/blocks.py`; `train_step(mesh=)`; the checkpoint across
grids; `train_torch.py` under `make_mesh`; `sharded_edge_decode` on split
weights) against the JAX package's sharded runs, on the CPU.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py) under
`with mesh:` on `shard_params` weights, as `tests/test_parallel.py` and
`__graft_entry__.py` run it; the port's mesh is a grid of 8 entries of
`cpu` (dp 4, tp 2), which splits the work into the same shards and sums
them the same way. TINY config (the graft's own config for its twins),
frames of 32x48, batch 4, inputs from numpy seeds. The f32 twins start
from JAX's TINY weights from key 0, the weights `tests/test_torch_train.py`
holds the one-device step on, carried over by `params_from_jax`; the
graft's twins from weights of its config drawn by the port and carried to
JAX's layout by `params_to_jax`. (On the port's own TINY draw from seed 0
JAX's sharded step parts from JAX's one-device step by 6.3e-4 of a
leaf's largest first gradient, ten times the twins' 2^-14, in
`dec_blocks2`'s `norm3`, and the port's two steps part by as much in the
same leaf: those weights hold no split of the f32 sums to 2^-14, in
either package; `test_port_seed0_weights_part_jax_from_itself`.)

Tolerances, each from where it comes:
  * the encoder on tp-split weights: atol 2e-4, rtol 1e-3, as
    `tests/test_parallel.py:37-55` holds JAX's sharded encoder to its
    one-device one (measured 2.3e-6 against the port's one-device encode);
  * f32 steps (losses, first-step gradients, weights after one and three
    steps): the tolerances of `tests/test_torch_train.py`'s
    `test_loss_gradients_match_the_reference` and
    `test_three_adamw_steps_match_optax`, which hold the one-device port to
    one-device JAX: losses within 2^-20 relative, each gradient within
    2^-14 of its leaf's largest, each weight within 4 eps of itself plus
    2^-10 lr where the reference's first gradient is at least 2^-9 of its
    leaf's largest and lr elsewhere, and 2 lr a step where that gradient is
    below 2^-14 of the largest, so small that f32 rounding decides its
    sign (`_assert_adamw_close`). The sharded port differs from either
    reference only in the order of f32 sums (the row-parallel partials and
    the rows' loss terms), as the two packages do;
  * the shipped bf16 step (the graft's twin): within twice JAX's own
    bf16-vs-f32 distance, the bound of the bf16 model twins
    (`tests/test_torch_models_bf16.py`); the edge decode on split weights:
    in f32, within 2e-4 / 1e-3 of JAX's, the f32 tolerance of
    `tests/test_torch_parallel.py`'s sharded decode twin;
  * mesh (1, 1) against no mesh, shard and gather, the checkpoint's
    re-split, the CLI against its in-process run: equal bit for bit.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import chip_smoke
import train_torch
from monst3r_slam_tpu.models import croco as jcroco
from monst3r_slam_tpu.models import init as jinit
from monst3r_slam_tpu.models import mast3r as jmodel
from monst3r_slam_tpu.models.config import ModelConfig as JModelConfig
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.parallel import inference as jpinf
from monst3r_slam_tpu.parallel import mesh as jmesh
from monst3r_slam_tpu.train import loss as jloss
from monst3r_slam_tpu.train import step as jstep
from monst3r_slam_torch.models import croco as tcroco
from monst3r_slam_torch.models import mast3r as tmodel
from monst3r_slam_torch.models.config import TINY as TTINY
from monst3r_slam_torch.models.config import ModelConfig as TModelConfig
from monst3r_slam_torch.models.convert import params_from_jax, params_to_jax
from monst3r_slam_torch.models.init import init_params
from monst3r_slam_torch.parallel import inference as tpinf
from monst3r_slam_torch.parallel import mesh as tmesh
from monst3r_slam_torch.train import checkpoint as tckpt
from monst3r_slam_torch.train import step as tstep
from tests.test_torch_slam import one_torch_thread  # noqa: F401
from tests.test_torch_train import _cli, _jax_f32_step, _keyed, _unflatten

CPU = torch.device("cpu")
B, H, W = 4, 32, 48
EPS32 = 2.0**-23
LR = 1e-4


def cpu_mesh(n=8):
    return tmesh.make_mesh(devices=[CPU] * n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's TINY weights from key 0, numpy."""
    return _np(jinit.init_params(jax.random.PRNGKey(0), JTINY))


def _drawn(cfg, seed: int = 0):
    """Random weights of `cfg` drawn by the port from `seed`, in JAX's
    layout (numpy)."""
    return params_to_jax(init_params(torch.Generator().manual_seed(seed), cfg))


def _batch(seed: int) -> dict:
    """The synthetic recipe's pair, numpy, with a share of invalid pixels
    that differs per sample (a quarter to all of them valid), so the dp
    row blocks' valid counts differ."""
    rng = np.random.default_rng(seed)
    img1 = (0.5 * rng.standard_normal((B, H, W, 3))).astype(np.float32)
    img2 = (img1 + 0.05 * rng.standard_normal((B, H, W, 3))).astype(np.float32)
    z = 2.0 + 2.0 / (1.0 + np.exp(-img1[..., :1]))
    u = np.linspace(-1, 1, W, dtype=np.float32)[None, None, :, None]
    v = np.linspace(-0.75, 0.75, H, dtype=np.float32)[None, :, None, None]
    gt = np.concatenate([u * z, v * z, z], -1).astype(np.float32)
    keep = np.asarray([1.0, 0.75, 0.5, 0.25])[:, None, None]
    return {"img1": img1, "img2": img2, "gt_X1": gt, "gt_X2": gt[:, ::-1].copy(),
            "valid1": (rng.uniform(size=(B, H, W)) < keep).astype(np.float32),
            "valid2": (rng.uniform(size=(B, H, W)) < keep[::-1]).astype(np.float32)}


def _placed(batch: dict, mesh) -> dict:
    return {k: tmesh.batch_sharding(mesh, torch.from_numpy(v)) for k, v in batch.items()}


def _sharded_state(jp_np, mesh):
    return tstep.init_train_state(tmesh.shard_params(params_from_jax(jp_np), mesh),
                                  tstep.make_optimizer(LR))


def _sharded_grads(state, mesh) -> dict:
    """The gradients the last step left on a sharded state, gathered, by
    JAX's key paths."""
    grads = torch.utils._pytree.tree_map(
        lambda w: dataclasses.replace(w, parts=[p.grad for p in w.parts])
        if isinstance(w, tmesh.Sharded) else w.grad, state.params)
    return _keyed(params_to_jax(tmesh.gather_params(grads, mesh)))


def _weights(state, mesh) -> dict:
    """A copy of the state's weights, gathered, by JAX's key paths."""
    return _keyed(params_to_jax(tmesh.gather_params(state.params, mesh)))


def _assert_adamw_close(got: dict, ref: dict, g1: dict, steps: int):
    """`test_three_adamw_steps_match_optax`'s bound, per element, with one
    more tier: where the reference's first gradient is below the gradient
    check's own tolerance (2^-14 of its leaf's largest), f32 rounding
    decides its sign, and AdamW's normalization turns a flipped sign into
    steps up to lr apart each way: 2 lr a step there (measured: one element
    of `dec_blocks2` cross proj, gradients 1.3e-8 and -3.2e-8 of a largest
    0.2, 1.32 lr apart after one step)."""
    assert sorted(got) == sorted(ref)
    for name, w in got.items():
        g = np.abs(g1[name])
        lr_tol = np.where(g >= 2.0**-9 * g.max(), 2.0**-10,
                          np.where(g >= 2.0**-14 * g.max(), 1.0, 2.0 * steps))
        tol = 4 * EPS32 * np.abs(ref[name]) + lr_tol * LR
        assert (np.abs(w - ref[name]) <= tol).all(), name


def _assert_grads_close(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        r = ref[name]
        assert np.isfinite(g).all() and np.abs(g - r).max() <= 2.0**-14 * np.abs(r).max(), name


# --- placement ----------------------------------------------------------------


def _specs(tree, specs, prefix=""):
    """(path, spec) of a parameter tree and its `param_shardings` tree (whose
    leaves are tuples), paths spelled as `named_leaves` spells them."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _specs(tree[k], specs[k], f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _specs(v, specs[i], f"{prefix}[{i}]")]
    return [(prefix, specs)]


def test_shard_and_gather_round_trip_with_head_aligned_qkv():
    """`shard_params` then `gather_params` gives back every weight bit for
    bit. Each weight `param_spec` splits is a `Sharded` of tp contiguous
    parts (copies; part t on the grid's device (0, t)); every other leaf is
    a copy on the home device. Shard t of a qkv weight and bias holds the
    q, k and v rows of heads t H/tp ... (t+1) H/tp - 1, and shard t of the
    proj after it the same heads' input columns."""
    mesh = cpu_mesh()
    tp = mesh.shape["tp"]
    params = init_params(torch.Generator().manual_seed(0), TTINY)
    sharded = tmesh.shard_params(params, mesh)
    back = tmesh.gather_params(sharded, mesh)
    specs = dict(_specs(params, tmesh.param_shardings(params, mesh)))
    n_split = 0
    for (name, w), (_, s), (_, g) in zip(tstep.named_leaves(params),
                                         tstep.named_leaves(sharded), tstep.named_leaves(back)):
        assert torch.equal(g, w) and g.data_ptr() != w.data_ptr(), name
        if "tp" not in specs[name]:
            assert isinstance(s, torch.Tensor) and torch.equal(s, w)
            assert s.data_ptr() != w.data_ptr()
            continue
        n_split += 1
        assert s.dim == specs[name].index("tp") and len(s.parts) == tp, name
        assert all(p.is_contiguous() and p.device == d for p, d in zip(s.parts, mesh.devices[0]))
        if "['qkv']" not in name:
            assert s.groups == 1 and all(torch.equal(p, c) for p, c in
                                         zip(s.parts, w.chunk(tp, s.dim))), name
    assert n_split == 6 * TTINY.enc_depth + 2 * 13 * TTINY.dec_depth + 2 * 3  # blocks, heads

    for blocks, n_heads in (("enc_blocks", TTINY.enc_heads), ("dec_blocks", TTINY.dec_heads),
                            ("dec_blocks2", TTINY.dec_heads)):
        attn, ref = sharded[blocks][1]["attn"], params[blocks][1]["attn"]
        d = ref["proj"]["w"].shape[0]
        hd, per = d // n_heads, d // tp
        for t in range(tp):
            heads = slice(t * per, (t + 1) * per)  # heads t H/tp ... of hd rows each
            assert per == (n_heads // tp) * hd
            for leaf in ("w", "b"):
                part, whole = attn["qkv"][leaf].parts[t], ref["qkv"][leaf]
                q, k, v = whole.chunk(3, 0)
                assert attn["qkv"][leaf].groups == 3
                assert torch.equal(part, torch.cat([q[heads], k[heads], v[heads]])), (blocks, t)
            assert torch.equal(attn["proj"]["w"].parts[t], ref["proj"]["w"][:, heads])
            assert torch.equal(sharded[blocks][1]["attn"]["proj"]["b"], ref["proj"]["b"])


def test_mesh_helpers_under_the_reference_names():
    """`batch_sharding` and `replicated` are the SLAM path's `split_rows`
    and `replicate`; a tp 1 grid splits no weight."""
    assert tmesh.batch_sharding is tmesh.split_rows and tmesh.replicated is tmesh.replicate
    mesh = cpu_mesh()
    x = torch.arange(8.0).reshape(4, 2)
    rows = tmesh.batch_sharding(mesh, x)
    assert len(rows) == mesh.shape["dp"] and torch.equal(torch.cat(rows), x)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.batch_sharding(mesh, x[:3])
    params = init_params(torch.Generator().manual_seed(0), TTINY)
    one = tmesh.shard_params(params, tmesh.make_mesh(devices=[CPU]))
    assert not any(isinstance(w, tmesh.Sharded) for _, w in tstep.named_leaves(one))
    with pytest.raises(ValueError, match="does not split"):
        tmesh.split_pieces(torch.zeros(6, 4), 0, 4)


# --- the tensor-parallel forward ------------------------------------------------


def test_encoder_on_tp_split_weights_matches_jax_and_one_device(jax_tiny):
    """`tests/test_parallel.py:37-55`'s twin: the encoder of each dp row on
    the row's tp shards, against JAX's jitted encoder on its sharded
    weights and batch, and against the port's one-device encoder."""
    jp = jax_tiny
    img = np.random.default_rng(1).standard_normal((B, H, W, 3)).astype(np.float32)
    jm = jmesh.make_mesh(8)
    with jm:
        jfeat, _ = jax.jit(lambda p, x: jcroco.encode_image(p, JTINY, x, jnp.float32))(
            jmesh.shard_params(jp, jm), jax.device_put(img, jmesh.batch_sharding(jm)))
    mesh = cpu_mesh()
    params = params_from_jax(jp)
    sharded = tmesh.shard_params(params, mesh)
    feat = torch.cat([tcroco.encode_image(tmesh.row_params(sharded, mesh, d), TTINY, rows,
                                          torch.float32)[0]
                      for d, rows in enumerate(tmesh.batch_sharding(mesh, torch.from_numpy(img)))])
    one, _ = tcroco.encode_image(params, TTINY, torch.from_numpy(img), torch.float32)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(feat.numpy(), one.numpy(), atol=2e-4, rtol=1e-3)


# --- the sharded step -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh_run(jax_tiny):
    """JAX's `train_step` pattern in f32 (`_jax_f32_step`) under `with
    mesh:` on `shard_params` weights and a `batch_sharding` batch, three
    steps: losses, the first step's gradients, the weights after one and
    after three steps (numpy). Each step's outputs are placed back under
    the input shardings, so the step compiles once."""
    jm = jmesh.make_mesh(8)
    jp = jax_tiny
    params = jmesh.shard_params(jp, jm)
    opt_state = jstep.make_optimizer(LR).init(params)
    shardings = jax.tree.map(lambda a: a.sharding if isinstance(a.sharding, NamedSharding)
                             else jmesh.replicated(jm), (params, opt_state))
    params, opt_state = jax.device_put((params, opt_state), shardings)
    losses, after = [], []
    with jm:
        for i in range(3):
            batch = {k: jax.device_put(v, jmesh.batch_sharding(jm)) for k, v in _batch(i).items()}
            loss, grads, params, opt_state = _jax_f32_step(params, opt_state, batch)
            params, opt_state = jax.device_put((params, opt_state), shardings)
            losses.append(float(loss))
            after.append(_keyed(_np(params)))
            if i == 0:
                grads0 = _keyed(_np(grads))
    return dict(params=jp, losses=losses, grads0=grads0, after=after)


@pytest.fixture(scope="module")
def port_mesh_run(jax_mesh_run):
    """The port's three f32 steps on the (4, 2) grid from JAX's weights, and
    three one-device steps beside them."""
    mesh = cpu_mesh()
    state = _sharded_state(jax_mesh_run["params"], mesh)
    one = tstep.init_train_state(params_from_jax(jax_mesh_run["params"]), tstep.make_optimizer(LR))
    run = dict(losses=[], after=[], one_losses=[], one_after=[])
    for i in range(3):
        state, loss = tstep.train_step(state, TTINY, _placed(_batch(i), mesh),
                                       dtype=torch.float32, mesh=mesh)
        one, one_loss = tstep.train_step(one, TTINY, {k: torch.from_numpy(v)
                                                      for k, v in _batch(i).items()},
                                         dtype=torch.float32)
        run["losses"].append(float(loss))
        run["one_losses"].append(float(one_loss))
        run["after"].append(_weights(state, mesh))
        run["one_after"].append(_weights(one, tmesh.make_mesh(devices=[CPU])))
        if i == 0:
            run["grads0"] = _sharded_grads(state, mesh)
            run["one_grads0"] = _keyed(params_to_jax(torch.utils._pytree.tree_map(
                lambda t: t.grad, one.params)))
    return run


@pytest.mark.parametrize("ref", ["jax", "one_device"])
def test_sharded_f32_step_losses_and_first_gradients(jax_mesh_run, port_mesh_run, ref):
    """Against JAX's sharded step and against the port's one-device step."""
    if ref == "jax":
        losses, grads = jax_mesh_run["losses"], jax_mesh_run["grads0"]
    else:
        losses, grads = port_mesh_run["one_losses"], port_mesh_run["one_grads0"]
    np.testing.assert_allclose(port_mesh_run["losses"], losses, rtol=2.0**-20)
    _assert_grads_close(port_mesh_run["grads0"], grads)


@pytest.mark.parametrize("ref", ["jax", "one_device"])
@pytest.mark.parametrize("steps", [1, 3])
def test_sharded_f32_steps_weights(jax_mesh_run, port_mesh_run, ref, steps):
    """The gathered weights after one and after three sharded AdamW steps."""
    if ref == "jax":
        want, g1 = jax_mesh_run["after"][steps - 1], jax_mesh_run["grads0"]
    else:
        want, g1 = port_mesh_run["one_after"][steps - 1], port_mesh_run["one_grads0"]
    _assert_adamw_close(port_mesh_run["after"][steps - 1], want, g1, steps)


def _jax_grads(jp: dict, batch: dict, jm=None) -> dict:
    """JAX's first f32 gradients from `jp` on `batch` (`_jax_f32_step`), on
    one device or under `with jm:` on `shard_params` weights."""
    if jm is None:
        _, grads, _, _ = _jax_f32_step(jp, jstep.make_optimizer(LR).init(jp), batch)
        return _keyed(_np(grads))
    params = jmesh.shard_params(jp, jm)
    opt_state = jstep.make_optimizer(LR).init(params)
    shardings = jax.tree.map(lambda a: a.sharding if isinstance(a.sharding, NamedSharding)
                             else jmesh.replicated(jm), (params, opt_state))
    params, opt_state = jax.device_put((params, opt_state), shardings)
    with jm:
        placed = {k: jax.device_put(v, jmesh.batch_sharding(jm)) for k, v in batch.items()}
        _, grads, _, _ = _jax_f32_step(params, opt_state, placed)
    return _keyed(_np(grads))


def _gaps(got: dict, ref: dict) -> dict:
    """Each leaf's largest difference over its reference's largest (a leaf
    the loss does not reach: 0 where both are zeros)."""
    return {n: float(np.abs(got[n] - r).max() / np.abs(r).max()) if np.abs(r).max() > 0
            else np.inf if np.abs(got[n]).max() > 0 else 0.0 for n, r in ref.items()}


def test_port_seed0_weights_part_jax_from_itself():
    """Why the f32 twins start from JAX's key-0 weights: on the port's own
    TINY draw from seed 0, JAX's sharded first gradients part from JAX's
    one-device ones by more than the twins' 2^-14 of a leaf's largest
    (measured 6.3e-4, in `dec_blocks2`'s `norm3` weight), so no split of
    the f32 sums holds there. The port's sharded step parts from its
    one-device step alike: in every leaf by at most twice JAX's own gap
    plus 2^-14 (measured: the same 6.3e-4, in the same leaf)."""
    jp, batch = _drawn(TTINY, 0), _batch(0)
    jax_gap = _gaps(_jax_grads(jp, batch, jmesh.make_mesh(8)), _jax_grads(jp, batch))
    mesh = cpu_mesh()
    state = _sharded_state(jp, mesh)
    state, _ = tstep.train_step(state, TTINY, _placed(batch, mesh), dtype=torch.float32,
                                mesh=mesh)
    one = tstep.init_train_state(params_from_jax(jp), tstep.make_optimizer(LR))
    one, _ = tstep.train_step(one, TTINY, {k: torch.from_numpy(v) for k, v in batch.items()},
                              dtype=torch.float32)
    one_grads = _keyed(params_to_jax(torch.utils._pytree.tree_map(lambda t: t.grad, one.params)))
    port_gap = _gaps(_sharded_grads(state, mesh), one_grads)
    worst = max(jax_gap, key=jax_gap.get)
    assert jax_gap[worst] > 2.0**-14 and port_gap[worst] > 2.0**-14, (worst, jax_gap[worst])
    for name, gap in port_gap.items():
        assert gap <= 2 * jax_gap[name] + 2.0**-14, (name, gap, jax_gap[name])


@pytest.fixture(scope="module")
def one_device_trajectory(jax_tiny):
    """Three one-device f32 steps from JAX's key-0 TINY weights on
    `_batch(i)`: each step's loss and a copy of the weights after it, the
    first copy carrying that step's gradients (what
    `chip_smoke.train_mesh_step_check` reads of the one-device run)."""
    one = tstep.init_train_state(params_from_jax(jax_tiny), tstep.make_optimizer(LR))
    run = []
    for i in range(3):
        one, loss = tstep.train_step(one, TTINY, {k: torch.from_numpy(v)
                                                  for k, v in _batch(i).items()},
                                     dtype=torch.float32)
        snap = torch.utils._pytree.tree_map(lambda t: t.detach().clone(), one.params)
        if i == 0:
            for (_, s), (_, t) in zip(tstep.named_leaves(snap), tstep.named_leaves(one.params)):
                s.grad = t.grad.clone()
        run.append((float(loss), snap))
    return run


@pytest.mark.parametrize("fault", (None,) + chip_smoke.TRAIN_MESH_FAULTS)
def test_step_check_rejects_planted_faults(jax_tiny, one_device_trajectory, fault):
    """`chip_smoke.train_mesh_step_check`, the card's check of the sharded
    step, here on the (4, 2) CPU grid against the one-device step, three
    f32 steps: without a fault every step passes; with each of
    `chip_smoke.planted_fault`'s defects some step fails. A defect that
    changes the gradients from the second step on also breaks the
    trajectory's bounds (the share of weights that agree, or the later
    losses) by the third step: a lost dp row's gradient (measured: 14.6%
    of a leaf agree after three steps), qkv's shards swapped (0%), a dp
    row's loss terms dropped (14.6%). A bias added twice breaks only the
    first step's gradient bound: TINY's biases start at 0, so the first
    forward is unchanged, and AdamW's first step is lr sign(g), the
    doubled gradient's too; in three steps the loss then parts by at most
    6.8e-4 and 95.3% of every leaf agree."""
    mesh = cpu_mesh()
    state = _sharded_state(jax_tiny, mesh)
    checks = []
    for i, (one_loss, one_params) in enumerate(one_device_trajectory):
        with chip_smoke.planted_fault(fault) if fault else contextlib.nullcontext():
            state, loss = tstep.train_step(state, TTINY, _placed(_batch(i), mesh),
                                           dtype=torch.float32, mesh=mesh)
        checks.append(chip_smoke.train_mesh_step_check(one_params, state.params, mesh, i + 1,
                                                       (one_loss, float(loss))))
    failed = [c["failed"] for c in checks]
    if fault is None:
        assert failed == [[], [], []], checks
    elif fault == "bias_twice":
        assert failed[0] == ["grad"], checks
    else:
        assert {"share", "loss"} & set(failed[2]), checks


def test_loss_over_unequal_valid_counts_is_the_whole_batch_loss():
    """The dp row blocks' valid counts differ (1/4 to all pixels valid, per
    sample): the sharded loss, which divides the rows' summed numerators by
    their summed denominators, equals the one-device loss (f32: within 16
    eps on a (4, 1) grid, where only the loss's sums are reordered;
    measured at most 2 eps; and 2^-17 on the (4, 2) grid, which also sums
    the row-parallel partials in another order), while the mean of the rows'
    own losses misses it by far more."""
    params = init_params(torch.Generator().manual_seed(3), TTINY)
    batch = {k: torch.from_numpy(v) for k, v in _batch(7).items()}
    with torch.no_grad():
        one = float(tstep.loss_fn(params, TTINY, batch, dtype=torch.float32))
        dp_only = tmesh.Mesh(np.asarray([[CPU]] * 4, dtype=object))
        for mesh, rtol in ((dp_only, 16 * EPS32), (cpu_mesh(), 2.0**-17)):
            placed = {k: tmesh.batch_sharding(mesh, v) for k, v in batch.items()}
            got = float(tstep.loss_fn(tmesh.shard_params(params, mesh), TTINY, placed,
                                      dtype=torch.float32, mesh=mesh))
            assert abs(got - one) <= rtol * abs(one), (dict(mesh.shape), got, one)
        rows = [float(tstep.loss_fn(params, TTINY, {k: v[d:d + 1] for k, v in batch.items()},
                                    dtype=torch.float32)) for d in range(B)]
    assert abs(np.mean(rows) - one) > 1e-3 * abs(one)


def test_one_by_one_mesh_step_is_the_one_device_step():
    """bf16 (the shipped step) and f32: the step on a (1, 1) mesh, with
    `shard_params` and `batch_sharding`, equals the step without a mesh
    bit for bit, losses and weights, over two steps."""
    mesh = tmesh.make_mesh(devices=[CPU])
    for dtype in (torch.bfloat16, torch.float32):
        params = init_params(torch.Generator().manual_seed(0), TTINY)
        one = tstep.init_train_state(params, tstep.make_optimizer(LR))
        meshed = tstep.init_train_state(tmesh.shard_params(params, mesh), tstep.make_optimizer(LR))
        for i in range(2):
            one, l1 = tstep.train_step(one, TTINY, {k: torch.from_numpy(v)
                                                    for k, v in _batch(i).items()}, dtype=dtype)
            meshed, l2 = tstep.train_step(meshed, TTINY, _placed(_batch(i), mesh), dtype=dtype,
                                          mesh=mesh)
            assert torch.equal(l1, l2), (dtype, i)
        for (n, a), (_, b) in zip(tstep.named_leaves(one.params),
                                  tstep.named_leaves(meshed.params)):
            assert torch.equal(a, b), (dtype, n)


# --- the graft's dry run ---------------------------------------------------------


GRAFT = dict(enc_depth=2, enc_dim=64, enc_heads=4, dec_depth=12, dec_dim=48, dec_heads=4,
             feature_dim=32, last_dim=16, layer_dims=(16, 24, 32, 48), desc_dim=None,
             two_confs=False)


def _graft_batch(dp: int) -> dict:
    """`__graft_entry__.py:84-98`'s batch, drawn by JAX, as numpy."""
    h, w, b = 32, 48, max(dp, 2 * dp)
    key = jax.random.PRNGKey(1)
    noise = np.array(jax.random.normal(key, (b, h, w, 3)))
    gt = np.array(jax.random.normal(key, (b, h, w, 3)) + jnp.asarray([0, 0, 3.0]))
    return {"img1": noise, "img2": noise, "gt_X1": gt, "gt_X2": gt,
            "valid1": np.ones((b, h, w), np.float32), "valid2": np.ones((b, h, w), np.float32)}


@pytest.fixture(scope="module")
def graft_run():
    """`__graft_entry__.py:43-110`: the graft's config, one bf16 `train_step`
    on the 8-device mesh (JAX) and on the port's (4, 2) grid, from the same
    weights and batch; JAX's f32 loss of the same weights beside them."""
    jcfg, tcfg = JModelConfig(**GRAFT), TModelConfig(**GRAFT)
    jm = jmesh.make_mesh(8)
    jp = _drawn(tcfg)
    batch = _graft_batch(jm.shape["dp"])
    opt = jstep.make_optimizer()
    jstate = jstep.init_train_state(jmesh.shard_params(jp, jm), opt)

    @jax.jit
    def f32_loss(params, b):
        out1, out2 = jstep.pair_forward(params, jcfg, b["img1"], b["img2"], dtype=jnp.float32)
        return (jloss.conf_regression_loss(out1.pts3d, out1.conf, b["gt_X1"], b["valid1"])
                + jloss.conf_regression_loss(out2.pts3d, out2.conf, b["gt_X2"], b["valid2"]))

    jf32 = float(f32_loss(jp, batch))
    with jm:
        jstate, jl = jstep.train_step(jstate, jcfg, opt, {
            k: jax.device_put(v, jmesh.batch_sharding(jm)) for k, v in batch.items()})
    mesh = cpu_mesh()
    state = tstep.init_train_state(tmesh.shard_params(params_from_jax(jp), mesh),
                                   tstep.make_optimizer())
    state, loss = tstep.train_step(state, tcfg, _placed(batch, mesh), mesh=mesh)
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, jparams=_np(jstate.params), jloss=float(jl),
                jf32=jf32, mesh=mesh, state=state, loss=float(loss))


def test_graft_sharded_step_loss_matches_jax(graft_run):
    """One sharded bf16 step: a finite loss within twice JAX's own
    bf16-vs-f32 distance of JAX's sharded step's loss."""
    loss, jl = graft_run["loss"], graft_run["jloss"]
    own = abs(jl - graft_run["jf32"])
    assert np.isfinite(loss) and 0 < own and abs(loss - jl) <= 2 * own, (loss, jl, own)


def _edge_inputs(cfg, e: int):
    """`__graft_entry__.py:167-178`'s edge batch, drawn by JAX, as numpy."""
    eh, ew = 32, 48
    n_tok = (eh // cfg.patch_size) * (ew // cfg.patch_size)
    ke = jax.random.split(jax.random.PRNGKey(3), 2)
    feat1, feat2 = (np.array(jax.random.normal(k, (e, n_tok, cfg.enc_dim))) for k in ke)
    yy, xx = np.mgrid[0:eh // cfg.patch_size, 0:ew // cfg.patch_size]
    pos = np.broadcast_to(np.stack([yy.ravel(), xx.ravel()], -1)[None], (e, n_tok, 2))
    return feat1, pos.astype(np.int32).copy(), feat2, (eh, ew)


def test_graft_edge_decode_on_the_stepped_split_weights(graft_run, monkeypatch):
    """`__graft_entry__.py:167-192`: `sharded_edge_decode` at an odd E (pad
    rows added and stripped) on the weights the sharded step left. On the
    port's own stepped weights, in bf16 (the decode's default): E rows,
    finite, and equal to one decode of the whole batch on the gathered
    weights. On JAX's stepped weights, split by the port, in f32 on both
    sides (JAX's decode patched to f32): within 2e-4 / 1e-3 of JAX's
    sharded decode on its sharded weights, the f32 tolerance of
    `tests/test_torch_parallel.py`'s sharded decode twin."""
    jcfg, tcfg, jm, mesh = (graft_run[k] for k in ("jcfg", "tcfg", "jm", "mesh"))
    E = 2 * mesh.shape["dp"] + 1
    feat1, pos, feat2, shape = _edge_inputs(jcfg, E)
    t_in = [torch.from_numpy(a) for a in (feat1, pos, feat2, pos)]
    state = graft_run["state"]
    out = tpinf.sharded_edge_decode(mesh, state.params, tcfg, *t_in, shape)
    whole = tmodel.decode(tmesh.gather_params(state.params, mesh), tcfg, *t_in, shape)
    assert out.X1.shape == (E,) + shape + (3,)
    for t, r in zip(out, whole):
        assert (t is None) == (r is None)
        if t is not None:
            assert torch.isfinite(t).all() and torch.equal(t, r)

    jparams = graft_run["jparams"]
    monkeypatch.setattr(jmodel, "decode", functools.partial(jmodel.decode, dtype=jnp.float32))
    jout = jpinf.sharded_edge_decode(jm, jmesh.shard_params(jparams, jm), jcfg, feat1, pos,
                                     feat2, pos, shape)
    split = tmesh.shard_params(params_from_jax(jparams), mesh)
    tout = tpinf.sharded_edge_decode(mesh, split, tcfg, *t_in, shape, torch.float32)
    for j, t in zip(jout, tout):
        assert (j is None) == (t is None)
        if j is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-4, rtol=1e-3)


# --- the entry point and the checkpoint ---------------------------------------------


def test_cli_runs_the_one_device_mesh_and_saves_the_unsharded_weights(tmp_path):
    """`train_torch.py --device cpu`: a (1, 1) mesh, printed as the
    reference prints it; its `--save` file equals the weights of two
    in-process steps without a mesh, bit for bit."""
    out = _cli("--synthetic", "--steps", "2", "--save", "a.npz", cwd=tmp_path)
    assert out.splitlines()[0] == "mesh: {'dp': 1, 'tp': 1}"
    state = tstep.init_train_state(init_params(torch.Generator().manual_seed(0), TTINY),
                                   tstep.make_optimizer())
    for i in range(2):
        state, _ = tstep.train_step(state, TTINY, train_torch.synthetic_batch(i, 2, 32, 32))
    saved = _unflatten(np.load(tmp_path / "a.npz"))
    want = _keyed(params_to_jax(state.params))
    got = _keyed(saved)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_resume_across_grids(tmp_path, jax_tiny):
    """Two f32 steps on the (4, 2) grid, saved; restored into a (1, 1)
    state of other weights, whose weights and AdamW moments then equal the
    grid's gathered ones bit for bit; two more steps there, against four
    uninterrupted steps on the grid: the losses and weights within the f32
    sharded-vs-one-device tolerance above (the grid's first gradients
    setting the per-element bound). Restored into a fresh (4, 2) state
    instead, the run continues bit for bit."""
    grid, one = cpu_mesh(), tmesh.make_mesh(devices=[CPU])
    jp = jax_tiny

    ref, ref_losses = _sharded_state(jp, grid), []
    for i in range(4):
        ref, loss = tstep.train_step(ref, TTINY, _placed(_batch(i), grid), dtype=torch.float32,
                                     mesh=grid)
        ref_losses.append(float(loss))
        if i == 0:
            g1 = _sharded_grads(ref, grid)

    state = _sharded_state(jp, grid)
    for i in range(2):
        state, _ = tstep.train_step(state, TTINY, _placed(_batch(i), grid), dtype=torch.float32,
                                    mesh=grid)
    mngr = tckpt.make_manager(tmp_path / "ck")
    tckpt.save(mngr, state)

    other = tstep.init_train_state(tmesh.shard_params(init_params(
        torch.Generator().manual_seed(5), TTINY), one), tstep.make_optimizer(LR))
    resumed = tckpt.restore_latest(mngr, other)
    assert resumed.step == 2
    got, want = _weights(resumed, one), _weights(state, grid)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    # the AdamW moments: a split weight's parts' moments, joined, are the
    # restored whole weight's
    grid_opt, opt = (s.opt_state.state_dict()["state"] for s in (state, resumed))
    index = {name: j for j, (name, _) in enumerate(tstep.named_leaves(resumed.params))}
    i = 0
    for name, w in tstep.named_leaves(state.params):
        j = index[name]
        parts = w.parts if isinstance(w, tmesh.Sharded) else [w]
        for k in ("exp_avg", "exp_avg_sq"):
            moments = [grid_opt[i + t][k] for t in range(len(parts))]
            whole = w.whole(moments) if isinstance(w, tmesh.Sharded) else moments[0]
            assert torch.equal(opt[j][k], whole), (name, k)
        assert all(torch.equal(opt[j]["step"], grid_opt[i + t]["step"]) for t in range(len(parts)))
        i += len(parts)

    losses = []
    for i in range(2, 4):
        resumed, loss = tstep.train_step(resumed, TTINY, {k: torch.from_numpy(v)
                                                          for k, v in _batch(i).items()},
                                         dtype=torch.float32)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_losses[2:], rtol=2.0**-20)
    _assert_adamw_close(_weights(resumed, one), _weights(ref, grid), g1, 4)

    again = tckpt.restore_latest(mngr, _sharded_state(_drawn(TTINY, 1), grid))
    for i in range(2, 4):
        again, loss = tstep.train_step(again, TTINY, _placed(_batch(i), grid),
                                       dtype=torch.float32, mesh=grid)
        assert float(loss) == ref_losses[i]
    got, want = _weights(again, grid), _weights(ref, grid)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
