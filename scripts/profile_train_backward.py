#!/usr/bin/env python3
"""Which autograd node of a training step launches which device time.

Builds the step of the benchmark's training cell (`--workload`, by default
monst3r512-train-384x512-b12: weights and batches from `--seed`, as
`benchmark/harness/train_pairs.py` makes them), runs `--warmup` steps,
then profiles `--steps` steps with host and device activity and gives each
kernel to the innermost autograd node that launched it
(`autograd::engine::evaluate_function: <node>`), or to the forward where
no node encloses its launch. Prints the step's device time by node, for
each node named in `--nodes` (by default KernelAttentionBackward, the
attention backward) its kernels beside each kernel's total over the step,
and the attention backward's calls a step by route (the `attn.bwd_kernel`
and `attn.bwd_plain` counters of `utils/timing`).

    python3 scripts/profile_train_backward.py [--seed 0] [--steps 1]
        [--nodes KernelAttentionBackward] [--out by_node.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NODE = "autograd::engine::evaluate_function: "


def owner(ev) -> str:
    """The innermost autograd node above host event `ev`, or "forward"."""
    while ev is not None:
        if ev.name.startswith(NODE):
            return ev.name[len(NODE):]
        ev = ev.cpu_parent
    return "forward"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="monst3r512-train-384x512-b12")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--nodes", nargs="*", default=["KernelAttentionBackward"])
    ap.add_argument("--out", help="also write {node: {kernel: [us a step, launches a step]}} "
                                  "here as JSON")
    args = ap.parse_args()

    import subprocess

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from benchmark.harness import cli, common, train_pairs, weights
    from monst3r_slam_torch.ops import build
    from monst3r_slam_torch.train.step import init_train_state, make_optimizer, train_step
    from monst3r_slam_torch.utils import timing

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cli.Cell(manifest, args.workload, args.seed, 0, False, "cuda", time.perf_counter())
    build.build()
    params = weights.make_params(cell.config, cell.seed, "cuda", served=False)
    state = init_train_state(params, make_optimizer(cell.traffic["lr"]))
    mcfg = common.model_config(cell.config)
    pool = train_pairs.make_batches(cell, 2)
    for i in range(args.warmup):
        state, _ = train_step(state, mcfg, pool[i % 2])
    torch.cuda.synchronize()
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.steps):
            state, _ = train_step(state, mcfg, pool[i % 2])
        torch.cuda.synchronize()
    by_node: dict = {}
    node_kernels: dict = {}
    totals: dict = {}
    for ev in prof.events():
        for k in getattr(ev, "kernels", []):
            node = owner(ev)
            by_node[node] = by_node.get(node, 0.0) + k.duration
            row = node_kernels.setdefault(node, {}).setdefault(k.name, [0.0, 0])
            row[0] += k.duration
            row[1] += 1
            tot = totals.setdefault(k.name, [0.0, 0])
            tot[0] += k.duration
            tot[1] += 1
    per = 1e3 * args.steps  # us summed -> ms a step
    step_ms = sum(t for t, _ in totals.values()) / per
    print(f"card: {card}; {args.workload}, seed {args.seed}: {step_ms:.2f} device ms a step "
          f"attributed, {sum(n for _, n in totals.values()) / args.steps:.0f} launches a step",
          flush=True)
    print("device ms a step by autograd node:")
    for node, us in sorted(by_node.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {us / per:9.3f}  {node}")
    for node in args.nodes:
        rows = node_kernels.get(node, {})
        ms = sum(t for t, _ in rows.values()) / per
        launches = sum(n for _, n in rows.values()) / args.steps
        print(f"{node}: {ms:.3f} device ms a step, {launches:.0f} launches a step; its kernels"
              " (ms a step, launches, share of that kernel's total in the step):")
        for name, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
            print(f"  {us / per:9.3f} {n / args.steps:6.0f}  {100 * us / totals[name][0]:5.1f}%  "
                  f"{name[:160]}")
    routes = {r: sum(c.n for c in timing.counts(f"attn.bwd_{r}")) / args.steps
              for r in ("kernel", "plain")}
    print(f"attention backward calls a step by route: {routes}")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {node: {name: [us / args.steps, n / args.steps] for name, (us, n) in rows.items()}
             for node, rows in node_kernels.items()}))
    print("the step's top kernels (ms a step, launches):")
    for name, (us, n) in sorted(totals.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / per:9.3f} {n / args.steps:6.0f}  {name[:160]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
