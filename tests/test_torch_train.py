"""The port's training path (`monst3r_slam_torch/train/`, `utils/flops.py`,
`train_torch.py`) against the JAX package's, on the CPU:
TINY config, 32x32 images (4 tokens a view), batch 2, inputs from a numpy
seed, the JAX weights carried over by `params_from_jax`. The port's
attention on the CPU is its plain version; the backward that kernel A's
autograd Function runs on the card for f32 inputs and the widths its
backward kernels do not take, `sdpa_backward_plain`, is held here to
torch's autograd of the plain version and to JAX's, and the route
(`backward_route`) that picks it or the kernels is checked.

Tolerances, each from where it comes:
  * f32 against f32 (losses, gradients, AdamW steps): the two sides sum in
    another order, so they differ by f32 rounding, amplified by the model's
    depth; each bound is stated as a multiple of f32's epsilon (2^-23) times
    the size of what is compared, with the measured ratio beside it.
  * bf16: the port's bf16 step rounds where the reference's rounds
    (`tests/test_torch_models_bf16.py`), so its distance from the
    reference's bf16 run is at most the two sides' own distances from the
    f32 run added: twice the reference's bf16-vs-f32 distance.
  * The plain backward against torch's autograd of the plain forward: the
    same operations, so equal bit for bit.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train_torch
from monst3r_slam_tpu.models import init as jinit
from monst3r_slam_tpu.models.config import MAST3R_512 as J_MAST3R_512
from monst3r_slam_tpu.models.config import MONST3R_512 as J_MONST3R_512
from monst3r_slam_tpu.models.config import TINY as JTINY
from monst3r_slam_tpu.ops import attention as jattn
from monst3r_slam_tpu.train import loss as jloss
from monst3r_slam_tpu.train import step as jstep
from monst3r_slam_tpu.utils import flops as jflops
from monst3r_slam_torch.models import config as tconfig
from monst3r_slam_torch.models.convert import params_from_jax, params_to_jax
from monst3r_slam_torch.models.init import init_params
from monst3r_slam_torch.ops import attention as tattn
from monst3r_slam_torch.train import checkpoint as tckpt
from monst3r_slam_torch.train import loss as tloss
from monst3r_slam_torch.train import step as tstep
from monst3r_slam_torch.utils import flops as tflops
from tests.test_torch_slam import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, H, W = 2, 32, 32
EPS32 = 2.0**-23
LR = 1e-4


def _batch(seed: int) -> dict:
    """A pair as the synthetic recipe makes it, a fifth of the pixels
    invalid: numpy arrays."""
    rng = np.random.default_rng(seed)
    img1 = (0.5 * rng.standard_normal((B, H, W, 3))).astype(np.float32)
    img2 = (img1 + 0.05 * rng.standard_normal((B, H, W, 3))).astype(np.float32)
    z = 2.0 + 2.0 / (1.0 + np.exp(-img1[..., :1]))
    u = np.linspace(-1, 1, W, dtype=np.float32)[None, None, :, None]
    v = np.linspace(-0.75, 0.75, H, dtype=np.float32)[None, :, None, None]
    gt = np.concatenate([u * z, v * z, z], -1).astype(np.float32)
    return {"img1": img1, "img2": img2, "gt_X1": gt, "gt_X2": gt[:, ::-1].copy(),
            "valid1": (rng.uniform(size=(B, H, W)) > 0.2).astype(np.float32),
            "valid2": (rng.uniform(size=(B, H, W)) > 0.2).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_params(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp))


def _keyed(tree) -> dict:
    """{keystr: leaf} of a JAX-layout tree."""
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_loss_f32(params, batch):
    """The reference's `loss_fn` with its `pair_forward` in f32."""
    out1, out2 = jstep.pair_forward(params, JTINY, batch["img1"], batch["img2"],
                                    dtype=jnp.float32)
    return (jloss.conf_regression_loss(out1.pts3d, out1.conf, batch["gt_X1"], batch["valid1"])
            + jloss.conf_regression_loss(out2.pts3d, out2.conf, batch["gt_X2"], batch["valid2"]))


@jax.jit
def _jax_f32_step(params, opt_state, batch):
    """The reference's `train_step` with the f32 loss: (loss, grads, params,
    opt_state)."""
    loss, grads = jax.value_and_grad(_jax_loss_f32)(params, batch)
    updates, opt_state = jstep.make_optimizer(LR).update(grads, opt_state, params)
    return loss, grads, optax.apply_updates(params, updates), opt_state


@pytest.fixture(scope="module")
def jax_run():
    """The reference's TINY weights from key 0 (numpy), and three f32 AdamW
    steps from them: the losses, the first step's gradients and the weights
    after."""
    jp = jinit.init_params(jax.random.PRNGKey(0), JTINY)
    params, opt_state, losses = jp, jstep.make_optimizer(LR).init(jp), []
    for i in range(3):
        loss, grads, params, opt_state = _jax_f32_step(params, opt_state, _jax(_batch(i)))
        losses.append(float(loss))
        if i == 0:
            grads0 = jax.tree.map(np.asarray, grads)
    return dict(params=jax.tree.map(np.asarray, jp), losses=losses, grads0=grads0,
                params3=jax.tree.map(np.asarray, params))


# --- the loss ---------------------------------------------------------------


@pytest.mark.parametrize("normalize", [True, False])
def test_loss_functions_match_the_reference(normalize):
    """Values in f32, partly invalid masks: within 8 eps of the value (one
    normalized sum over 2,048 pixels; measured at most 1 eps)."""
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((B, H, W, 3)) + [0, 0, 3]).astype(np.float32)
    C = (1.0 + np.exp(rng.standard_normal((B, H, W)))).astype(np.float32)
    gt = (rng.standard_normal((B, H, W, 3)) + [0, 0, 3]).astype(np.float32)
    valid = rng.uniform(size=(B, H, W)) > 0.3
    ref = jloss.conf_regression_loss(jnp.asarray(X), jnp.asarray(C), jnp.asarray(gt),
                                     jnp.asarray(valid), 0.3, normalize)
    got = tloss.conf_regression_loss(torch.from_numpy(X), torch.from_numpy(C),
                                     torch.from_numpy(gt), torch.from_numpy(valid), 0.3, normalize)
    assert abs(float(got) - float(ref)) <= 8 * EPS32 * abs(float(ref))
    np.testing.assert_allclose(
        tloss.normalize_pointmap(torch.from_numpy(X), torch.from_numpy(valid).float()).numpy(),
        np.asarray(jloss.normalize_pointmap(jnp.asarray(X), jnp.asarray(valid, jnp.float32))),
        rtol=8 * EPS32, atol=0)
    out = type("Out", (), {"X1": X, "C1": C, "X2": gt, "C2": C[::-1].copy()})
    b = {"gt_X1": gt, "gt_X2": X, "valid1": valid, "valid2": ~valid}
    ref2 = jloss.two_view_loss(out, {k: jnp.asarray(v) for k, v in b.items()})
    tout = type("Out", (), {k: torch.from_numpy(getattr(out, k)) for k in ("X1", "C1", "X2", "C2")})
    got2 = tloss.two_view_loss(tout, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(got2) - float(ref2)) <= 8 * EPS32 * abs(float(ref2))


def test_norm_gradient_at_zero_is_zero_in_the_port_and_nan_in_the_reference():
    """Where a predicted point equals its ground truth exactly, the error's
    norm is taken at the zero vector: `jnp.linalg.norm` differentiates to
    NaN there (and the validity mask's 0 keeps it NaN), `torch.linalg.norm`
    to 0. Everywhere else the two gradients agree to f32 rounding."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((1, 4, 4, 3)).astype(np.float32)
    gt = rng.standard_normal((1, 4, 4, 3)).astype(np.float32)
    gt[0, 1, 2] = X[0, 1, 2]  # one pixel predicted exactly
    C = np.full((1, 4, 4), 1.5, np.float32)
    valid = np.ones((1, 4, 4), np.float32)
    valid[0, 1, 2] = 0.0  # and masked out: the reference's NaN survives the mask
    jg = np.array(jax.grad(lambda x: jloss.conf_regression_loss(
        x, jnp.asarray(C), jnp.asarray(gt), jnp.asarray(valid), normalize=False))(jnp.asarray(X)))
    Xt = torch.from_numpy(X).requires_grad_()
    tloss.conf_regression_loss(Xt, torch.from_numpy(C), torch.from_numpy(gt),
                               torch.from_numpy(valid), normalize=False).backward()
    tg = Xt.grad.numpy()
    assert np.isnan(jg[0, 1, 2]).all() and (tg[0, 1, 2] == 0).all()
    jg[0, 1, 2] = 0
    np.testing.assert_allclose(tg, jg, rtol=4 * EPS32, atol=4 * EPS32 * np.abs(jg).max())


# --- kernel A's backward ----------------------------------------------------


def _qkvd(seed, shape_q, nk, dtype):
    rng = np.random.default_rng(seed)
    b, h, nq, d = shape_q
    q, dout = (rng.standard_normal((b, h, nq, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, nk, d), dtype=np.float32) for _ in range(2))
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v, dout)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nk", [(196, 196), (13, 13), (7, 19)])
def test_sdpa_backward_plain_equals_the_plain_autograd(dtype, nq, nk):
    """The same operations as torch's autograd of `sdpa_plain`, so equal
    bit for bit, at a whole tile's count, at 196 tokens (224x224) and at
    ragged, unequal counts."""
    q, k, v, dout = _qkvd(nq + nk, (2, 3, nq, 64), nk, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.sdpa_plain(*leaves).backward(dout)
    got = tattn.sdpa_backward_plain(q, k, v, dout)
    for g, t in zip(got, leaves):
        assert g.dtype == dtype and torch.equal(g, t.grad)


def test_sdpa_backward_plain_matches_the_reference_vjp():
    """f32, 196 tokens: within 16 eps of each gradient's largest magnitude
    (sums of 64- and 196-term products taken in another order; measured at
    most 2 eps)."""
    q, k, v, dout = _qkvd(3, (2, 4, 196, 64), 196, torch.float32)
    _, vjp = jax.vjp(lambda a, b, c: jattn.sdpa(a, b, c, use_pallas=False),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    refs = vjp(jnp.asarray(dout.numpy()))
    for g, r in zip(tattn.sdpa_backward_plain(q, k, v, dout), refs):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=16 * EPS32 * np.abs(r).max())


@pytest.mark.parametrize("nq,nk", [(196, 196), (130, 7)])
def test_sdpa_backward_plain_in_bf16_stays_within_its_stated_bound(nq, nk):
    """`backward_error_bound`, the bound the card checks kernel A's
    Function against, holds for the bf16 plain backward against the f32
    autograd (measured at most 0.64 of it)."""
    q, k, v, dout = _qkvd(nq * nk, (2, 4, nq, 64), nk, torch.bfloat16)
    ref = [t.float().clone().requires_grad_() for t in (q, k, v)]
    tattn.sdpa_plain(*ref).backward(dout.float())
    for g, r, bound in zip(tattn.sdpa_backward_plain(q, k, v, dout), ref,
                           tattn.backward_error_bound(q, k, v, dout)):
        assert bool(((g.float() - r.grad).abs() <= bound).all())


def test_sdpa_on_the_cpu_stays_the_plain_version():
    """A CPU tensor that requires grad takes `sdpa_plain` (torch
    differentiates it), never the kernel's Function."""
    q, k, v, _ = _qkvd(4, (1, 2, 5, 64), 5, torch.float32)
    q.requires_grad_()
    out, plain = tattn.sdpa(q, k, v), tattn.sdpa_plain(q, k, v)
    assert type(out.grad_fn) is not tattn.KernelAttention._backward_cls
    assert type(out.grad_fn) is type(plain.grad_fn)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("dtype,d,device,route", [
    (torch.bfloat16, 64, "cuda", "kernel"), (torch.bfloat16, 8, "cuda", "kernel"),
    (torch.bfloat16, 16, "cuda", "kernel"), (torch.bfloat16, 40, "cuda", "kernel"),
    (torch.float32, 64, "cuda", "plain"), (torch.float32, 16, "cuda", "plain"),
    (torch.bfloat16, 12, "cuda", "plain"), (torch.bfloat16, 4, "cuda", "plain"),
    (torch.bfloat16, 72, "cuda", "plain"), (torch.bfloat16, 128, "cuda", "plain"),
    (torch.bfloat16, 64, "cpu", "plain"), (torch.float32, 64, "cpu", "plain")])
def test_backward_route_sends_bf16_card_heads_up_to_64_to_the_kernels(dtype, d, device, route):
    """bf16 CUDA heads of a width the backward kernels read in place (a
    multiple of 8 up to `BWD_WIDTH`, the shipped models' 64 and TINY's 16)
    take the kernels; f32 (f32 training, the f32 checks), other widths
    (TINY's 12, above 64) and CPU tensors take `sdpa_backward_plain`."""
    assert tattn.backward_route(dtype, d, torch.device(device)) == route


def test_sdpa_backward_on_the_cpu_is_the_plain_backward_and_is_counted(monkeypatch):
    """On CPU tensors `sdpa_backward` returns `sdpa_backward_plain`'s
    gradients bit for bit and counts the call on the plain route, as
    `attn.bwd_plain` in `utils.timing`; the kernels' wrapper refuses CPU
    tensors."""
    from monst3r_slam_torch.utils import timing

    monkeypatch.setattr(timing, "enabled", True)
    q, k, v, dout = _qkvd(5, (2, 3, 13, 64), 19, torch.bfloat16)
    counted = len(timing.counts("attn.bwd_plain")), len(timing.counts("attn.bwd_kernel"))
    for g, r in zip(tattn.sdpa_backward(q, k, v, dout), tattn.sdpa_backward_plain(q, k, v, dout)):
        assert torch.equal(g, r)
    assert (len(timing.counts("attn.bwd_plain")),
            len(timing.counts("attn.bwd_kernel"))) == (counted[0] + 1, counted[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.attention_backward(q, k, v, dout)


# --- the step ---------------------------------------------------------------


def test_loss_gradients_match_the_reference(jax_run):
    """Per leaf, f32 on both sides: the loss within 16 eps (measured equal),
    each gradient within 2^-14 of its leaf's largest magnitude (f32
    rounding through 4 encoder and 2x4 decoder blocks, the DPT heads and the
    normalizations; measured at most 2^-17.6). The loss does not reach the
    descriptor head and refinenet4's first unit: the reference's gradient
    there is 0, the port's None (`train_step` gives them zeros)."""
    state = tstep.init_train_state(_port_params(jax_run["params"]), tstep.make_optimizer())
    loss = tstep.loss_fn(state.params, tconfig.TINY, _torch(_batch(0)), dtype=torch.float32)
    loss.backward()
    jl = jax_run["losses"][0]
    assert abs(loss.item() - jl) <= 16 * EPS32 * abs(jl)
    grads = tstep.named_leaves(params_to_jax(torch.utils._pytree.tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, state.params)))
    ref = _keyed(jax_run["grads0"])
    assert sorted(n for n, _ in grads) == sorted(ref)
    for name, g in grads:
        r = ref[name]
        assert np.isfinite(g).all() and np.abs(g - r).max() <= 2.0**-14 * np.abs(r).max(), name


def test_three_adamw_steps_match_optax(jax_run):
    """Three f32 steps: the losses within 2^-20 relative (measured 2^-23);
    the weights afterwards within 4 eps of the weight (each step rounds the
    decayed weight) plus, per element:
      * 2^-10 lr where the reference's first gradient is at least 2^-9 of
        its leaf's largest (measured 2^-12.1 lr): the gradients agree to
        2^-14 of that scale (above), so AdamW's direction m/sqrt(v) agrees;
      * lr elsewhere (about 3% of the elements), five times the 0.2 lr
        measured: there the two sides' gradients may differ in sign,
        which AdamW's normalization turns into steps of up to ~lr each way
        per step, so three steps could part by ~6 lr; the bound holds them
        to one step's size, under the ~3 lr one run moves in three."""
    state = tstep.init_train_state(_port_params(jax_run["params"]), tstep.make_optimizer(LR))
    losses = []
    for i in range(3):
        state, loss = tstep.train_step(state, tconfig.TINY, _torch(_batch(i)),
                                       dtype=torch.float32)
        losses.append(float(loss))
    assert state.step == 3
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=2.0**-20)
    ref, g1 = _keyed(jax_run["params3"]), _keyed(jax_run["grads0"])
    for name, w in tstep.named_leaves(params_to_jax(state.params)):
        g = np.abs(g1[name])
        tol = 4 * EPS32 * np.abs(ref[name]) + np.where(g >= 2.0**-9 * g.max(), 2.0**-10, 1.0) * LR
        assert (np.abs(w - ref[name]) <= tol).all(), name


def test_three_bf16_steps_stay_within_twice_the_reference_bf16_distance(jax_run):
    """The shipped step (bf16 compute on f32 weights): each of three losses
    within twice the reference's own bf16-vs-f32 distance at that step."""
    jf32 = jax_run["losses"]
    opt = jstep.make_optimizer(LR)
    jstate = jstep.init_train_state(jax.tree.map(jnp.asarray, jax_run["params"]), opt)
    jbf16 = []
    for i in range(3):
        jstate, loss = jstep.train_step(jstate, JTINY, opt, _jax(_batch(i)))
        jbf16.append(float(loss))
    state = tstep.init_train_state(_port_params(jax_run["params"]), tstep.make_optimizer(LR))
    for i in range(3):
        state, loss = tstep.train_step(state, tconfig.TINY, _torch(_batch(i)))
        own = abs(jbf16[i] - jf32[i])
        assert 0 < own and abs(float(loss) - jbf16[i]) <= 2 * own, (i, float(loss), jbf16[i], own)


# --- checkpoints ------------------------------------------------------------


def _port_state(seed: int):
    gen = torch.Generator().manual_seed(seed)
    return tstep.init_train_state(init_params(gen, tconfig.TINY), tstep.make_optimizer())


def test_resume_continues_bit_for_bit(tmp_path):
    """2 steps, save, restore into a state drawn from another seed, 2 more:
    the losses and weights of 4 uninterrupted steps, bit for bit."""
    ref, ref_losses = _port_state(0), []
    for i in range(4):
        ref, loss = tstep.train_step(ref, tconfig.TINY, _torch(_batch(i)))
        ref_losses.append(float(loss))
    state = _port_state(0)
    for i in range(2):
        state, _ = tstep.train_step(state, tconfig.TINY, _torch(_batch(i)))
    mngr = tckpt.make_manager(tmp_path / "ckpts")
    tckpt.save(mngr, state)
    resumed = tckpt.restore_latest(mngr, _port_state(1))
    assert resumed is not None and resumed.step == 2
    losses = []
    for i in range(2, 4):
        resumed, loss = tstep.train_step(resumed, tconfig.TINY, _torch(_batch(i)))
        losses.append(float(loss))
    assert losses == ref_losses[2:]
    for (n, a), (_, b) in zip(tstep.named_leaves(resumed.params), tstep.named_leaves(ref.params)):
        assert torch.equal(a, b), n


def test_restore_latest_on_an_empty_directory_and_pruning(tmp_path):
    mngr = tckpt.make_manager(tmp_path / "empty", max_to_keep=2)
    state = _port_state(0)
    assert tckpt.restore_latest(mngr, state) is None
    for step in (1, 2, 3, 3):  # the second save of step 3 is skipped
        tckpt.save(mngr, state._replace(step=step))
    assert mngr.steps() == [2, 3]
    assert sorted(p.name for p in mngr.path.iterdir()) == ["step_2.pt", "step_3.pt"]


# --- utils ------------------------------------------------------------------


@pytest.mark.parametrize("size", [(224, 224), (384, 512)])
@pytest.mark.parametrize("name", ["TINY", "MAST3R_512", "MONST3R_512"])
def test_flop_counts_equal_the_reference(name, size):
    jcfg = {"TINY": JTINY, "MAST3R_512": J_MAST3R_512, "MONST3R_512": J_MONST3R_512}[name]
    cfg = getattr(tconfig, name)
    assert tflops.encode_flops(cfg, *size) == jflops.encode_flops(jcfg, *size)
    assert tflops.decode_flops(cfg, *size) == jflops.decode_flops(jcfg, *size)
    assert (tflops.mfu(1e12, 0.5, peak=989e12)
            == jflops.mfu(1e12, 0.5, peak=989e12))


def test_chip_peak_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tflops.chip_peak_flops()
    with pytest.raises(RuntimeError):
        tflops.mfu(1e12, 1.0)


# --- the entry point --------------------------------------------------------


def _cli(*args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "train_torch.py"), "--tiny", "--device",
                          "cpu", "--batch", "2", "--img-size", "32", "32", *args],
                         cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_cli_trains_resumes_and_saves_the_reference_layout(tmp_path):
    """3 steps with a checkpoint, then a resume to step 5: the saved
    weights equal 5 uninterrupted steps in-process; the `--save` file has
    the reference's names and shapes for the same TINY tree and reads back
    through `params_from_jax`."""
    ck = tmp_path / "ck"
    out = _cli("--synthetic", "--steps", "3", "--ckpt-dir", str(ck), "--save", "a.npz",
               cwd=tmp_path)
    assert "mesh: {'dp': 1, 'tp': 1}" in out and "step 0: loss" in out
    out = _cli("--synthetic", "--steps", "5", "--ckpt-dir", str(ck), "--save", "b.npz",
               cwd=tmp_path)
    assert f"resumed from {ck} at step 3" in out
    assert sorted(p.name for p in ck.iterdir()) == ["step_3.pt", "step_5.pt"]

    state = _port_state(0)
    for i in range(5):
        state, _ = tstep.train_step(state, tconfig.TINY,
                                    train_torch.synthetic_batch(i, B, H, W))
    saved = np.load(tmp_path / "b.npz")
    ref = _keyed(jax.eval_shape(lambda k: jinit.init_params(k, JTINY), jax.random.PRNGKey(0)))
    assert sorted(saved.files) == sorted(ref)
    for name in ref:
        assert saved[name].shape == ref[name].shape and saved[name].dtype == ref[name].dtype, name
    back = params_from_jax(_unflatten(saved))
    for (n, a), (_, b) in zip(tstep.named_leaves(back), tstep.named_leaves(state.params)):
        assert torch.equal(a, b.detach()), n


def _unflatten(saved) -> dict:
    """A `--save` file back into the JAX layout's nested dicts and lists."""
    tree = {}
    for name in saved.files:
        keys = [int(k) if k.isdigit() else k.strip("'") for k in name[1:-1].split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = saved[name]
    return _lists(tree)


def _lists(tree):
    if isinstance(tree, dict):
        if tree and all(isinstance(k, int) for k in tree):
            return [_lists(tree[i]) for i in range(len(tree))]
        return {k: _lists(v) for k, v in tree.items()}
    return tree


def test_cli_reads_npz_samples(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    batch = _batch(5)
    for i in range(2):
        np.savez(data / f"{i}.npz", **{k: v[i] for k, v in batch.items()})
    out = _cli("--data", str(data), "--steps", "2", "--save", "", cwd=tmp_path)
    _, ref = tstep.train_step(_port_state(0), tconfig.TINY, _torch(batch))
    assert f"step 0: loss {float(ref):.4f} " in out
