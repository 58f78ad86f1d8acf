"""The correctness control of a cell: the reference put in the program's
place and computed one precision below the configuration's (bf16 compute:
fp8, per-tensor scaled e4m3 operands of every product), read by the same
numbers the check compares, at the cell's own sizes, and judged by the
check's own verdict at the limits of the cell's file: each seed has to come
out not correct.

    python3 perfbench/control.py --workload NAME --seconds S SEED [SEED ...]

prints one JSON line per seed: {"seed", "precision", "readings", "checks",
"correct"}, the checks as the run's last key holds them."""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(ctx, precision="fp8"):
    import torch

    from perfbench.lib import check, check_train
    from perfbench.reference import facialmmt as ref_model
    from perfbench.runners.serve import gumbel_table, traffic_for

    spec, tree = ctx.traffic, ctx.tree
    if spec["runner"] == "train_aux":
        return check_train.compare(
            check_train.aux_reference(ctx, tree, spec, precision),
            check_train.aux_reference(ctx, tree, spec))
    if spec["runner"] == "train_target":
        fed = check_train.target_plan(ctx, tree, spec)
        return check_train.compare(
            check_train.target_reference(ctx, tree, spec, fed, precision),
            check_train.target_reference(ctx, tree, spec, fed))
    traffic = traffic_for(ctx)
    count = traffic.count
    nf = tree["data"]["vision_utt_max_len"]
    noise = gumbel_table(torch, count, nf, tree["num_labels"], ctx.seed,
                         ctx.device)
    served = count

    class Rows:
        rows = {i: {"rid": i} for i in range(served)}

    rids = check.serve_sample(ctx, traffic, Rows, range(served))
    low = check.reference_model(ctx, tree, precision)
    answers, fer = [], []
    with torch.no_grad():
        for rid in rids:
            arrays = check.request_arrays(torch, tree, traffic.request(rid),
                                          ctx.device)
            n = arrays["faces"].shape[0]
            _, f, a = ref_model.serve_one(low, arrays,
                                          noise[rid * nf:rid * nf + n])
            answers.append(a[0].cpu().numpy())
            fer.append(f.cpu().numpy())
        del low
        model = check.reference_model(ctx, tree)
        return check.serve_readings(ctx, tree, traffic, rids, noise, answers,
                                    fer, model)


def judge(ctx, numbers):
    """The verdict a run with these readings gets at the cell's limits."""
    from perfbench.lib import check, check_train

    if ctx.traffic["runner"] == "serve":
        return check.verdict(ctx.traffic["check"]["limits"], numbers)
    return check_train.held(ctx, ctx.traffic, numbers)


def main(argv=None, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--precision", default="fp8")
    p.add_argument("seeds", type=int, nargs="+")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from perfbench.lib import harness

    dev = torch.device(device or "cuda")
    out = []
    for seed in args.seeds:
        a = argparse.Namespace(workload=args.workload, seed=seed,
                               seconds=args.seconds, trace=0)
        ctx = harness.Context(a, time.perf_counter(), dev, REPO)
        numbers = readings(ctx, args.precision)
        checks, correct = judge(ctx, numbers)
        r = {"seed": seed, "precision": args.precision, "readings": numbers,
             "checks": checks, "correct": correct}
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
