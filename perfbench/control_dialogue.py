"""The correctness control of the dialogue cell (control.py's, for the runner
`train_dialogue`): the reference put in the program's place and computed
one precision below the configuration's (bf16 compute: fp8, per-tensor
scaled e4m3 operands of every product, e5m2 gradients), read by the numbers
the check compares against the float32 reference on the same rows and
draws, and judged at the limits of the cell's file: each seed has to come
out not correct.

    python3 perfbench/control_dialogue.py --workload NAME --seconds S \\
        SEED [SEED ...]

prints one JSON line per seed: {"seed", "precision", "readings", "checks",
"correct"}."""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(ctx, precision="fp8"):
    import torch

    from perfbench.lib import check_dialogue, check_train
    from perfbench.runners import train_dialogue

    spec, tree = ctx.traffic, ctx.tree
    pool = train_dialogue.dialogue_pool(torch, spec, tree, ctx.seed,
                                        ctx.device)
    fed = train_dialogue.plan(spec, ctx.seed)[:spec["check"]["steps"]]
    return check_train.compare(
        check_dialogue.reference_readings(ctx, tree, spec, pool, fed,
                                          precision),
        check_dialogue.reference_readings(ctx, tree, spec, pool, fed))


def main(argv=None, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--precision", default="fp8")
    p.add_argument("seeds", type=int, nargs="+")
    args = p.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    from perfbench.lib import check_train, harness

    dev = torch.device(device or "cuda")
    out = []
    for seed in args.seeds:
        a = argparse.Namespace(workload=args.workload, seed=seed,
                               seconds=args.seconds, trace=0)
        ctx = harness.Context(a, time.perf_counter(), dev, REPO)
        if ctx.traffic["runner"] != "train_dialogue":
            raise SystemExit("control_dialogue.py runs the dialogue cells; "
                             "control.py the others")
        numbers = readings(ctx, args.precision)
        checks, correct = check_train.held(ctx, ctx.traffic, numbers)
        r = {"seed": seed, "precision": args.precision, "readings": numbers,
             "checks": checks, "correct": correct}
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
