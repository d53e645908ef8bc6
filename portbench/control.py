"""Read a cell's compared numbers for the program and for the control on
many seeds in one process, at the cell's own size.

    python3 -m portbench.control --workload <name> --seeds 1 2 3 [--seconds 3]
    python3 -m portbench.control --workload sr_x2.train --seeds 1 2 3 --fault half_batch

For each seed: the cell's set-up, a short window at its own load (long
enough for the mix's longest unit), the program's reading (the lower
reading of each limit), then the control's: the plain reference computed
in float8 e4m3 (the precision below the configuration's bfloat16) in the
program's place (the upper reading). One JSON line per seed, then the
largest program reading and the smallest control reading of each number.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run as prun

# the reference's precision that stands in the program's place
CONTROL = "fp8"


def readings(workload: str, seeds, seconds: float, device=None, fault: str = None):
    import contextlib

    import torch

    from portbench import faults

    bench = prun.load_json(prun.ROOT, "BENCHMARK.json")
    _, config, traffic, driver = prun.find(bench, workload)
    device = device or torch.device("cuda", 0)
    out = []
    for seed in seeds:
        planted = (faults.FAULTS[fault](traffic["driver"]) if fault
                   else contextlib.nullcontext())
        with planted:
            cell = driver.Cell(config, traffic, seed, device)
            cell.setup()
            cell.window(seconds)
            cell.free()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        row = {"seed": seed, "program": cell.check()}
        if fault:
            row["fault"] = fault
        else:
            row["control"] = cell.check(CONTROL)
        out.append(row)
        print(json.dumps(row), flush=True)
        del cell
    return out


def summary(rows) -> dict:
    """Per number: the largest program reading; the smallest control reading
    (or, with a fault planted, the smallest program reading)."""
    names = rows[0]["program"]
    key = "control" if "control" in rows[0] else "program"
    return {k: {"largest": max(r["program"][k] for r in rows),
                "smallest": min(r[key][k] for r in rows)} for k in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default=None, help="a fault of faults.FAULTS planted in the "
                   "program instead of the control")
    args = p.parse_args(argv)
    prun.cache_dirs()
    rows = readings(args.workload, args.seeds, args.seconds, fault=args.fault)
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
