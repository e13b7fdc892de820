"""Traffic kind `train_pairs`: fine-tuning steps of the two-view model.

Set-up builds one training state of the program (`train/step.py`: the f32
weights from the seed, AdamW as `train_torch.py` builds it) and a pool of
batches of pairs rendered from the oracle scene (`scene.py`) along the
known path, with their exact pointmaps as ground truth and every pixel
valid. Its first `checked_steps` steps go through the window's own call on
batches that all differ; they are the warm-up too, and what they produce
(each loss, the first gradient as the optimizer got it, the weights'
change after the last) is held against the plain reference after the
window. The window then runs `train_step` on the pool's batches in turn
until `--seconds` have passed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import common, scene, weights
from benchmark.harness.trace import Tracer

def pair_plan(cell) -> list:
    """[(start, gap)] of every pair of the pool, from the seed."""
    tr = cell.traffic
    rng = np.random.default_rng(cell.seed)
    n = tr["pool_batches"] * tr["batch"]
    lo, hi = tr["pair_gap"]
    return list(zip(rng.integers(0, tr["start_range"], n).tolist(),
                    rng.integers(lo, hi + 1, n).tolist()))


def make_batches(cell, n_batches: int) -> list:
    tr, cfg, dev = cell.traffic, cell.config, cell.device
    h, w = cfg["img_size"]
    focal = tr["focal_scale"] * w
    plan = pair_plan(cell)
    out = []
    for k in range(n_batches):
        rows = plan[k * tr["batch"]:(k + 1) * tr["batch"]]
        Ti = torch.from_numpy(np.stack([scene.trajectory(s, 1, tr["step"])[0] for s, _ in rows]))
        Tj = torch.from_numpy(np.stack([scene.trajectory(s + g, 1, tr["step"])[0]
                                        for s, g in rows]))
        Ti, Tj = Ti.to(dev), Tj.to(dev)
        X1, _, X2, _ = scene.render_pair(Ti, Tj, {"W": torch.zeros(3, 1, device=dev),
                                                  "b": torch.zeros(1, device=dev)}, h, w, focal)
        _, img1 = scene.render_images(Ti, h, w, focal)
        _, img2 = scene.render_images(Tj, h, w, focal)
        valid = torch.ones((len(rows), h, w), device=dev)
        out.append(dict(img1=img1, img2=img2, gt_X1=X1.reshape(-1, h, w, 3),
                        gt_X2=X2.reshape(-1, h, w, 3), valid1=valid, valid2=valid.clone()))
    return out


def leaf_norms(tensors) -> list:
    return [float(x) for x in torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
            .cpu()]


def run(cell) -> dict:
    from monst3r_slam_torch.ops import build
    from monst3r_slam_torch.train.step import init_train_state, make_optimizer, train_step

    cell.phase("import")
    dev, cfg, tr = cell.device, cell.config, cell.traffic
    if dev == "cuda":
        build.build()
    cell.phase("build")
    params = weights.make_params(cfg, cell.seed, dev, served=False)
    leaves = [t for _, t in weights.named_leaves(params)]
    mcfg = common.model_config(cfg)
    state = init_train_state(params, make_optimizer(tr["lr"]))
    common.sync(dev)
    cell.phase("weights")
    pool = make_batches(cell, tr["pool_batches"])
    common.sync(dev)
    cell.phase("traffic")

    start = [t.detach().clone() for t in leaves]
    losses = []
    fault = cell.control.get("fault")
    rows = tr["batch"] // 2 if fault == "half_batch" else tr["batch"]
    if fault == "unchanged":  # the step returns the state as it was
        state.opt_state.step = lambda *a, **k: None
    for k in range(tr["checked_steps"]):
        state, loss = train_step(state, mcfg, {key: v[:rows] for key, v in pool[k].items()})
        losses.append(loss)
        if k == 0:
            beta1 = state.opt_state.param_groups[0]["betas"][0]
            opt_state = state.opt_state.state
            grad_norms = leaf_norms([opt_state[t]["exp_avg"] / (1 - beta1) if t in opt_state
                                     else torch.zeros(()) for t in leaves])
    change_norms = leaf_norms([t.detach() - s for t, s in zip(leaves, start)])
    del start
    got = dict(losses=[float(x) for x in losses], grad_norms=grad_norms,
               change_norms=change_norms)
    if "precision" in cell.control:  # the reference in the program's place
        got = reference_steps(cell, cell.control["precision"])
    common.sync(dev)
    cell.phase("warmup")
    setup_s = cell.setup_done()

    tracer = Tracer(cell.trace)
    window_losses = []
    k = tr["checked_steps"]
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    while time.perf_counter() < deadline:
        state, loss = train_step(state, mcfg, pool[k % len(pool)])
        window_losses.append(loss)
        k += 1
    common.sync(dev)
    window_s = time.perf_counter() - t0
    peak = common.memory_peak(dev)
    steps = len(window_losses)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum()) if steps else 0
    if tracer.enabled:  # the steps that follow the window, profiled
        tracer.start()
        for i in range(1 + tr["trace_steps"]):
            if i == 1:
                tracer.mark()
            state, _ = train_step(state, mcfg, pool[(k + i) % len(pool)])
        tracer.stop()
    del state, params, leaves, pool, window_losses
    if dev == "cuda":
        torch.cuda.empty_cache()

    checks = check(cell, got)
    print(f"train window: {steps} steps in {window_s:.3f} s; checked steps' losses "
          f"{got['losses']}, relative gaps {checks.pop('step_loss_gaps')}; "
          f"{checks.pop('leaves_counted')} of {checks.pop('leaves')} leaves counted", flush=True)
    return dict(setup_s=setup_s, window_s=window_s, steps=steps, batch=tr["batch"],
                img_size=tuple(cfg["img_size"]), config=cfg, trace=tracer.summary,
                traced_steps=tr["trace_steps"],
                attempted=steps, failed=failed, checks=checks, memory_peak_bytes=peak,
                device_kind=common.device_kind(dev))


def reference_steps(cell, precision: str = "f32") -> dict:
    """The plain reference's checked steps from the weights and batches
    made again from the seed."""
    from benchmark.reference import model, train

    params = weights.make_params(cell.config, cell.seed, cell.device, served=False)
    leaves = [t.requires_grad_() for _, t in weights.named_leaves(params)]
    batches = make_batches(cell, cell.traffic["checked_steps"])
    return train.steps(params, leaves, cell.config, batches, cell.traffic["lr"],
                       model.Precision(precision), rows=cell.traffic["ref_rows"])


def check(cell, got: dict) -> dict:
    from benchmark.reference import train

    out = train.compare(got, reference_steps(cell))
    return {k: common.finite(v) if k.endswith("_gap") else v for k, v in out.items()}
