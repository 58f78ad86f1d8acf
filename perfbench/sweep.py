"""Find the knee of the open loop once: the highest offered rate at which
the program answers at least 0.98 of the rate (answers per second between
a lead-in of a quarter of the window, at most 2 s, and its close) and its
queue does not grow.

    python3 perfbench/sweep.py --workload serve_tav_poisson --seed N \\
        --seconds S RATE [RATE ...]

One set-up, then one window per rate, from the lowest; use the cell's own
window length.  A queue grows when the median latency of the last quarter
of a window's requests is more than GROWTH times that of the first quarter.
Prints one line per rate, with the backlog (requests due and not yet
answered) at each quarter of the window, and the knee."""

import argparse
import collections
import os
import sys
import time

T_START = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROWTH = 1.2


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("rates", type=float, nargs="+")
    args = p.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from perfbench.lib import harness, load
    from perfbench.runners.serve import Prepared, traffic_for

    args.trace = 0
    ctx = harness.Context(args, T_START, torch.device("cuda", 0), REPO)
    # the Gumbel table is sized for the highest rate's requests
    st = Prepared(ctx, rate=max(args.rates), seconds=args.seconds)
    knee = None
    for rate in sorted(args.rates):
        st.traffic = traffic_for(ctx, rate, args.seconds)
        st.count = st.traffic.count
        st.reset()
        t0, record, futures = st.drive(ctx, False, args.seconds)
        load.settle(futures, 120.0)
        lead = min(2.0, args.seconds / 4)
        done = [r for r in record.rows.values() if r["ok"]
                and lead <= r["done"] <= args.seconds]
        rows = sorted(record.rows.values(), key=lambda r: r["due"])
        q = max(1, len(rows) // 4)
        lat = lambda part: float(np.median([(r["done"] - r["due"]) * 1e3
                                            for r in part if r["ok"]]))
        first, last = lat(rows[:q]), lat(rows[-q:])
        achieved = len(done) / (args.seconds - lead)
        s = load.latency_summary(record, args.seconds)
        backlog = [sum(1 for r in rows if r["due"] <= t
                       and not (r["done"] is not None and r["done"] <= t))
                   for t in (np.arange(1, 5) * args.seconds / 4)]
        ok = achieved >= 0.98 * rate and last <= GROWTH * first
        if ok:
            knee = rate
        buckets = collections.Counter(st.front.bucket_choices)
        print(f"rate {rate:.1f}: achieved {achieved:.1f} utt/s, p50 "
              f"{s['p50_ms']:.1f} p95 {s['p95_ms']:.1f} ms, median latency "
              f"first quarter {first:.1f} last quarter {last:.1f} ms, fill "
              f"{np.mean(st.front.pack_sizes):.2f}, backlog by quarter "
              f"{backlog}, packs by bucket "
              f"{dict(buckets)} -> {'sustained' if ok else 'not sustained'}",
              flush=True)
    st.front.close()
    print(f"knee {knee}")


if __name__ == "__main__":
    main()
