"""Find the serving cell's knee once: the highest open-loop rate the server
sustains with no growing backlog.

    python3 -m portbench.sweep --workload sr_x2.serve --rates 90 110 130 150 --seconds 10

One process, one server; at each rate one window of Poisson arrivals.
Printed per rate: the 95th-percentile latency, the requests still
unanswered when arrivals stopped (the backlog at the close), the mean fill
of the micro-batches and of the last three, and the median time between
two micro-batches' answers (a micro-batch's time when they run back to
back). The knee is max_batch over that time: beyond it every micro-batch
is full and the queue grows. The rate is then written by
hand into the cell's traffic file, at about four fifths of the knee.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from portbench import run as prun


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    prun.cache_dirs()
    import torch

    bench = prun.load_json(prun.ROOT, "BENCHMARK.json")
    _, config, traffic, driver = prun.find(bench, args.workload)
    cell = driver.Cell(config, dict(traffic), args.seed, torch.device("cuda", 0))
    cell.setup()
    for rate in args.rates:
        cell.traffic["rate"] = rate
        n0 = len(cell.batches)
        r = cell.window(args.seconds)
        t0 = max(t for _, t in cell.batches) - r["seconds"]
        close = t0 + args.seconds
        answered = sum(len(ids) for ids, t in cell.batches[n0:] if t <= close and ids[0] >= 0)
        fills = r["fills"][-(len(cell.batches) - n0):]
        ends = [t for _, t in cell.batches[n0:]]
        print(json.dumps({"rate": rate, "requests": r["units"],
                          "p95_s": float(np.percentile(r["latency"], 95)),
                          "p50_s": float(np.percentile(r["latency"], 50)),
                          "backlog_at_close": r["units"] - answered,
                          "mean_fill": float(np.mean(fills)), "last_fills": fills[-3:],
                          "batch_s": float(np.median(np.diff(ends))) if len(ends) > 1 else None,
                          "late_s": r["late_s"], "window_s": r["seconds"]}), flush=True)
        time.sleep(2.0)
    cell.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
